// The native executable filter: framework=pjrt on a frozen TorchScript
// program, with no Python in the invoke (counterpart of the JAX package's
// native/src/pjrt_filter.cc; the reference's tensor_filter_tensorrt.cc:215
// deserializes a native engine at open and runs its invoke loop in C++).
//
// filters/aot.py native_aot_compile traces a model's forward (its postproc
// folded in), freezes it so the weights are constants, and saves
// <key>.pjrt (a TorchScript archive) beside <key>.pjrt.sig (the JAX
// package's text signature, np-order dims):
//   nnstpu-pjrt-sig v1
//   in u8 4 128 224 224 3
//   out i32 1 128
// A program traced on the card calls the hand-written kernels through the
// TorchScript op library (csrc/torch_ops.cc), which this filter links, so
// they are the only device code of the port in the program; libtorch runs
// the rest (convolutions, the head) as the Python forward does.
//
// A C++ class subplugin (native/include/nnstpu/cppclass.hh) that
// native_rt.load_exec dlopens into the port's core
// (libnnstpu_torch_core.so, built without pjrt_filter.cc, so the name is
// free); the reference's launch line runs unchanged.
//
// framework=pjrt properties (custom= string, comma-separated):
//   model=<path.pjrt>       the program (set by the element)
//   device:cuda[:N] | cpu   where it runs (default cuda:0). Only
//                           device:cpu takes the CPU: with no card the
//                           open fails and says so.
//   plugin:..., copt.*=...  the reference's PJRT plugin and client
//                           options: accepted and ignored (one warning)
//
// Open: torch::jit::load on the device, the sidecar for the in/out infos,
// pinned staging buffers and a stream of the instance's own. Invoke: the
// core's host memories into the pinned staging, then to the device on the
// instance's stream; forward under c10::InferenceMode with the graph
// executor's optimizer off (no fusion, no generated kernels); the outputs
// back into the core's memories; synchronize before returning. An open
// that fails leaves an instance whose getModelInfo fails, so the element
// posts an error; nnstpu_exec_last_error says why (cppclass.hh turns a
// throw from configure_instance into a null instance, which its adapters
// would call through).

#include <torch/script.h>
#include <torch/csrc/jit/runtime/graph_executor.h>

#ifdef NNSTPU_EXEC_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/cuda.h>
#endif

#include <cstdio>
#include <cstring>
#include <fstream>
#include <mutex>
#include <optional>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

#include "nnstpu/cppclass.hh"
#include "nnstpu/tensor.h"

namespace {

std::mutex g_err_mu;
std::string g_err;

void set_error(const std::string& msg) {
  std::lock_guard<std::mutex> lk(g_err_mu);
  g_err = msg;
  std::fprintf(stderr, "[nnstpu:pjrt] %s\n", msg.c_str());
}

// sidecar tokens (filters/sig_tokens.py; pjrt_filter.cc kDtypes)
struct DtypeEntry {
  const char* token;
  at::ScalarType scalar;
  nnstpu::DType wire;
};

const DtypeEntry kDtypes[] = {
    {"i32", at::kInt, nnstpu::DType::kInt32},
    {"u32", at::kUInt32, nnstpu::DType::kUint32},
    {"i16", at::kShort, nnstpu::DType::kInt16},
    {"u16", at::kUInt16, nnstpu::DType::kUint16},
    {"i8", at::kChar, nnstpu::DType::kInt8},
    {"u8", at::kByte, nnstpu::DType::kUint8},
    {"f64", at::kDouble, nnstpu::DType::kFloat64},
    {"f32", at::kFloat, nnstpu::DType::kFloat32},
    {"i64", at::kLong, nnstpu::DType::kInt64},
    {"u64", at::kUInt64, nnstpu::DType::kUint64},
    {"f16", at::kHalf, nnstpu::DType::kFloat16},
    {"bf16", at::kBFloat16, nnstpu::DType::kBfloat16},
};

struct TensorSig {
  const DtypeEntry* dtype = nullptr;
  std::vector<int64_t> dims;  // np order (major → minor)
  size_t bytes() const {
    size_t n = c10::elementSize(dtype->scalar);
    for (int64_t d : dims) n *= static_cast<size_t>(d);
    return n;
  }
};

struct Signature {
  std::vector<TensorSig> ins, outs;
};

Signature read_sidecar(const std::string& path) {
  std::ifstream f(path);
  if (!f) throw std::runtime_error("cannot open signature sidecar " + path);
  std::string line;
  if (!std::getline(f, line) || line.rfind("nnstpu-pjrt-sig", 0) != 0)
    throw std::runtime_error(path + ": not a nnstpu-pjrt-sig file");
  Signature sig;
  while (std::getline(f, line)) {
    if (line.empty() || line[0] == '#') continue;
    std::istringstream ss(line);
    std::string kind, dt;
    size_t ndims = 0;
    ss >> kind >> dt >> ndims;
    if (!ss || (kind != "in" && kind != "out") || ndims > NNSTPU_RANK_LIMIT)
      throw std::runtime_error(path + ": bad sidecar line: " + line);
    TensorSig t;
    for (const auto& e : kDtypes)
      if (dt == e.token) t.dtype = &e;
    if (!t.dtype) throw std::runtime_error(path + ": unknown dtype " + dt);
    for (size_t i = 0; i < ndims; ++i) {
      int64_t d = 0;
      ss >> d;
      if (!ss || d <= 0)
        throw std::runtime_error(path + ": bad dim in line: " + line);
      t.dims.push_back(d);
    }
    (kind == "in" ? sig.ins : sig.outs).push_back(std::move(t));
  }
  if (sig.ins.empty() || sig.outs.empty())
    throw std::runtime_error(path + ": sidecar has no in/out tensors");
  return sig;
}

void sig_to_info(const std::vector<TensorSig>& ts, nnstpu_tensors_info* out) {
  std::memset(out, 0, sizeof(*out));
  out->num = static_cast<uint32_t>(ts.size());
  for (size_t i = 0; i < ts.size(); ++i) {
    const auto& t = ts[i];
    // wire dims are innermost-first: reverse the np-order dims
    out->info[i].rank = static_cast<uint32_t>(t.dims.size());
    for (size_t d = 0; d < t.dims.size(); ++d)
      out->info[i].dims[d] =
          static_cast<uint32_t>(t.dims[t.dims.size() - 1 - d]);
    out->info[i].dtype = static_cast<uint32_t>(t.dtype->wire);
  }
}

// the custom section's comma-separated tokens, each split at its first
// ':' or '='
std::vector<std::pair<std::string, std::string>> parse_tokens(
    const std::string& custom) {
  std::vector<std::pair<std::string, std::string>> kv;
  std::istringstream ss(custom);
  std::string tok;
  while (std::getline(ss, tok, ',')) {
    if (tok.empty()) continue;
    size_t pos = tok.find_first_of("=:");
    if (pos == std::string::npos)
      kv.emplace_back(tok, "");
    else
      kv.emplace_back(tok.substr(0, pos), tok.substr(pos + 1));
  }
  return kv;
}

class TorchExecFilter : public nnstpu::tensor_filter_subplugin {
 public:
  void configure_instance(const char* props) override {
    try {
      open(props);
      ok_ = true;
    } catch (const std::exception& e) {
      set_error(std::string("framework=pjrt: ") + e.what());
    }
  }

  int getModelInfo(nnstpu_tensors_info* in,
                   nnstpu_tensors_info* out) override {
    if (!ok_) return -1;
    sig_to_info(sig_.ins, in);
    sig_to_info(sig_.outs, out);
    return 0;
  }

  int invoke(const nnstpu_tensor_mem* in, uint32_t n_in,
             nnstpu_tensor_mem* out, uint32_t n_out) override {
    if (!ok_) return -1;
    if (n_in != sig_.ins.size() || n_out != sig_.outs.size()) {
      std::fprintf(stderr, "[nnstpu:pjrt] invoke arity %u/%u vs sig %zu/%zu\n",
                   n_in, n_out, sig_.ins.size(), sig_.outs.size());
      return -1;
    }
    for (uint32_t i = 0; i < n_in; ++i)
      if (in[i].size != sig_.ins[i].bytes()) {
        std::fprintf(stderr, "[nnstpu:pjrt] input %u size %zu != sig %zu\n",
                     i, in[i].size, sig_.ins[i].bytes());
        return -1;
      }
    try {
#ifdef NNSTPU_EXEC_CUDA
      if (device_.is_cuda()) return invoke_cuda(in, out);
#endif
      return invoke_cpu(in, out);
    } catch (const std::exception& e) {
      std::fprintf(stderr, "[nnstpu:pjrt] invoke failed: %s\n", e.what());
      return -1;
    }
  }

 private:
  void open(const char* props) {
    auto models = parse_models(props);
    if (models.size() != 1)
      throw std::runtime_error("need exactly one model=<path.pjrt>");
    const std::string& model = models[0];
    std::string device = "cuda:0";
    bool ignored = false;
    for (auto& [k, v] : parse_tokens(parse_custom(props))) {
      if (k == "device")
        device = v == "cuda" ? "cuda:0" : v;
      else if (k == "plugin" || k.rfind("copt.", 0) == 0)
        ignored = true;
    }
    if (ignored)
      std::fprintf(stderr,
                   "[nnstpu:pjrt] plugin: and copt.* are the JAX package's "
                   "PJRT options; this runner ignores them\n");
    device_ = c10::Device(device);
    if (device_.is_cuda()) {
#ifdef NNSTPU_EXEC_CUDA
      if (!torch::cuda::is_available())
        throw std::runtime_error(
            "no CUDA device for " + model +
            " (say custom=device:cpu to run the program on the CPU)");
      if (device_.index() >= static_cast<int>(torch::cuda::device_count()))
        throw std::runtime_error("no device " + device);
#else
      throw std::runtime_error(
          "this runner was built without CUDA, so there is no CUDA device "
          "for " + model + " (say custom=device:cpu to run the program on "
          "the CPU)");
#endif
    } else if (!device_.is_cpu()) {
      throw std::runtime_error("unknown device " + device);
    }
    sig_ = read_sidecar(model + ".sig");
    module_ = torch::jit::load(model, device_);
    module_.eval();
#ifdef NNSTPU_EXEC_CUDA
    if (device_.is_cuda()) {
      if (device_.index() < 0) device_ = c10::Device(c10::kCUDA, 0);
      stream_ = c10::cuda::getStreamFromPool(false, device_.index());
      for (const auto& t : sig_.ins) stage_in_.push_back(pinned(t));
      for (const auto& t : sig_.outs) stage_out_.push_back(pinned(t));
    }
#endif
    std::fprintf(stderr,
                 "[nnstpu:pjrt] loaded %s on %s (%zu in, %zu out; torch %s)\n",
                 model.c_str(), device_.str().c_str(), sig_.ins.size(),
                 sig_.outs.size(), NNSTPU_TORCH_VERSION);
  }

  static at::Tensor pinned(const TensorSig& t) {
    return at::empty(t.dims, at::TensorOptions()
                                 .dtype(t.dtype->scalar)
                                 .pinned_memory(true));
  }

  // the program's outputs, one tensor or a tuple/list of them
  std::vector<at::Tensor> run(std::vector<c10::IValue> args) {
    torch::jit::GraphOptimizerEnabledGuard no_opt(false);
    c10::IValue r = module_.forward(std::move(args));
    std::vector<at::Tensor> outs;
    if (r.isTensor()) {
      outs.push_back(r.toTensor());
    } else if (r.isTuple()) {
      for (const auto& v : r.toTupleRef().elements())
        outs.push_back(v.toTensor());
    } else if (r.isTensorList()) {
      for (const at::Tensor& t : r.toTensorVector()) outs.push_back(t);
    } else {
      throw std::runtime_error("the program returns neither tensors nor a "
                               "tuple of them");
    }
    if (outs.size() != sig_.outs.size())
      throw std::runtime_error("the program gives " +
                               std::to_string(outs.size()) +
                               " outputs, the sidecar says " +
                               std::to_string(sig_.outs.size()));
    for (size_t i = 0; i < outs.size(); ++i)
      if (outs[i].scalar_type() != sig_.outs[i].dtype->scalar ||
          outs[i].numel() * outs[i].element_size() != sig_.outs[i].bytes())
        throw std::runtime_error("output " + std::to_string(i) +
                                 " does not match the sidecar");
    return outs;
  }

  int invoke_cpu(const nnstpu_tensor_mem* in, nnstpu_tensor_mem* out) {
    c10::InferenceMode guard;
    std::vector<c10::IValue> args;
    for (size_t i = 0; i < sig_.ins.size(); ++i)
      args.emplace_back(at::from_blob(
          in[i].data, sig_.ins[i].dims,
          at::TensorOptions().dtype(sig_.ins[i].dtype->scalar)));
    auto outs = run(std::move(args));
    for (size_t i = 0; i < outs.size(); ++i) {
      at::Tensor o = outs[i].contiguous();
      std::memcpy(out[i].data, o.data_ptr(), out[i].size);
    }
    return 0;
  }

#ifdef NNSTPU_EXEC_CUDA
  int invoke_cuda(const nnstpu_tensor_mem* in, nnstpu_tensor_mem* out) {
    c10::InferenceMode guard;
    c10::cuda::CUDAStreamGuard sg(*stream_);
    std::vector<c10::IValue> args;
    for (size_t i = 0; i < sig_.ins.size(); ++i) {
      std::memcpy(stage_in_[i].data_ptr(), in[i].data, in[i].size);
      args.emplace_back(stage_in_[i].to(device_, /*non_blocking=*/true));
    }
    auto outs = run(std::move(args));
    for (size_t i = 0; i < outs.size(); ++i)
      stage_out_[i].copy_(outs[i].reshape(sig_.outs[i].dims),
                          /*non_blocking=*/true);
    stream_->synchronize();
    for (size_t i = 0; i < outs.size(); ++i)
      std::memcpy(out[i].data, stage_out_[i].data_ptr(), out[i].size);
    return 0;
  }

  std::optional<c10::cuda::CUDAStream> stream_;  // set at open
  std::vector<at::Tensor> stage_in_, stage_out_;
#endif

  bool ok_ = false;
  c10::Device device_{c10::kCPU};
  Signature sig_;
  torch::jit::Module module_;
};

__attribute__((constructor)) void register_exec() {
  nnstpu::register_subplugin<TorchExecFilter>("pjrt");
}

}  // namespace

// forget the last open error (before an open whose outcome is read)
extern "C" __attribute__((visibility("default"))) void
nnstpu_exec_clear_error(void) {
  std::lock_guard<std::mutex> lk(g_err_mu);
  g_err.clear();
}

// why the last open failed ("" when none has)
extern "C" __attribute__((visibility("default"))) const char*
nnstpu_exec_last_error(void) {
  static thread_local std::string copy;
  std::lock_guard<std::mutex> lk(g_err_mu);
  copy = g_err;
  return copy.c_str();
}
