// TorchScript ops over the hand-written kernels: the route a traced
// program takes to them.
//
// The kernels are launched from Python through ctypes
// (ops/fused_block.py, ops/preprocess.py). torch.jit.trace cannot see a
// ctypes launch: it would record the kernel's output as a constant, and
// the saved program would answer every input with the traced one's
// result. So under tracing a CUDA tensor takes these ops instead, which
// the dispatcher records. Each op calls the kernel library's C entry point
// (csrc/fused_block.cu, csrc/preprocess.cu) with the arguments the ctypes
// wrapper passes, on c10's current CUDA stream, so the two routes give the
// same bits. A C++ process (csrc/native_exec.cc) loading the frozen
// program runs the same kernels with no Python in the call.
//
// CUDA implementations only: a CPU trace records the kernels' plain
// versions, never these ops.
//
// Each op counts its launches in a C counter
// (nnstpu_torch_ops_launches), which ops/_script_ops.py reads: Python's
// count_launch never sees a launch made from C++.
//
// Built by ops/_script_ops.py with g++ against torch's headers, linked to
// libtorch and the kernel library (libnnstpu_kernels.so).

#include <ATen/ATen.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <atomic>

extern "C" {
int nnstpu_normalize_u8(const void* x, void* y, long long n, float scale,
                        float offset, int out_dtype, int vec_ok,
                        void* stream);
int nnstpu_fused_inverted_residual(const void* x, void* out,
                                   const void* const* w, const long long* d,
                                   int dtype, const long long* f, int n,
                                   void* stream);
int nnstpu_fused_output_hw(long long H, long long W, const long long* f, int n,
                           long long* hw);
}

namespace {

// dtype codes shared with csrc/common.cuh and ops/_cuda.py DTYPE_CODES
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

enum Kernel { kFused = 0, kNormalize = 1, kNumKernels = 2 };
std::atomic<long long> g_launches[kNumKernels];

void check_weight(const at::Tensor& t, const at::Tensor& x, const char* name,
                  at::ScalarType dtype) {
  TORCH_CHECK(t.device() == x.device(), "fused_inverted_residual: ", name,
              " is on ", t.device(), ", x on ", x.device());
  TORCH_CHECK(t.is_contiguous(), "fused_inverted_residual: ", name,
              " must be contiguous");
  TORCH_CHECK(t.scalar_type() == dtype, "fused_inverted_residual: ", name,
              " is ", t.scalar_type(), ", the kernel takes ", dtype);
}

at::Tensor fused_inverted_residual(const at::Tensor& x,
                                   const c10::optional<at::Tensor>& w1,
                                   const c10::optional<at::Tensor>& b1,
                                   const at::Tensor& wd, const at::Tensor& bd,
                                   const at::Tensor& w2, const at::Tensor& b2,
                                   at::IntArrayRef plan) {
  TORCH_CHECK(x.is_cuda(), "fused_inverted_residual: x must be on a CUDA "
              "device");
  TORCH_CHECK(x.dim() == 4, "fused_inverted_residual takes NHWC, got ",
              x.sizes());
  const bool expand = w1.has_value();
  TORCH_CHECK(expand == b1.has_value(),
              "fused_inverted_residual: w1 and b1 go together");
  // the compute dtype is the weights'
  const at::ScalarType cd = wd.scalar_type();
  TORCH_CHECK(cd == at::kFloat || cd == at::kBFloat16,
              "fused_inverted_residual computes in float32 or bfloat16");
  c10::cuda::CUDAGuard guard(x.device());
  at::Tensor xc = x.to(cd).contiguous();
  const long long B = xc.size(0), H = xc.size(1), W = xc.size(2);
  const long long Cin = xc.size(3);
  const long long Ch = wd.size(-1), Cout = w2.size(-1);
  if (expand) {
    check_weight(*w1, x, "w1", cd);
    check_weight(*b1, x, "b1", at::kFloat);
    TORCH_CHECK(w1->dim() == 2 && w1->size(0) == Cin && w1->size(1) == Ch,
                "fused_inverted_residual: w1 must be [Cin, Ch]");
  } else {
    TORCH_CHECK(Cin == Ch, "fused_inverted_residual: x has ", Cin,
                " channels, the block takes ", Ch);
  }
  check_weight(wd, x, "wd", cd);
  check_weight(bd, x, "bd", at::kFloat);
  check_weight(w2, x, "w2", cd);
  check_weight(b2, x, "b2", at::kFloat);
  TORCH_CHECK(wd.dim() == 2 && wd.size(0) == 9, "wd must be [9, Ch]");
  TORCH_CHECK(w2.dim() == 2 && w2.size(0) == Ch, "w2 must be [Ch, Cout]");
  // the output map (stride 2 halves it) as the kernel library computes it
  long long hw[2];
  TORCH_CHECK(nnstpu_fused_output_hw(
                  H, W, reinterpret_cast<const long long*>(plan.data()),
                  static_cast<int>(plan.size()), hw) == 0,
              "fused_inverted_residual: the plan's stride or pads do not fit "
              "a ", H, "x", W, " input");
  at::Tensor out = at::empty({B, hw[0], hw[1], Cout}, xc.options());
  const void* w[6] = {expand ? w1->data_ptr() : nullptr,
                      expand ? b1->data_ptr() : nullptr,
                      wd.data_ptr(), bd.data_ptr(), w2.data_ptr(),
                      b2.data_ptr()};
  const long long d[6] = {B, H, W, Cin, Ch, Cout};
  static_assert(sizeof(int64_t) == sizeof(long long), "plan fields");
  const int err = nnstpu_fused_inverted_residual(
      xc.data_ptr(), out.data_ptr(), w, d, cd == at::kFloat ? kF32 : kBF16,
      reinterpret_cast<const long long*>(plan.data()),
      static_cast<int>(plan.size()),
      c10::cuda::getCurrentCUDAStream(x.device().index()).stream());
  TORCH_CHECK(err == 0, "fused_inverted_residual: CUDA error ", err);
  g_launches[kFused].fetch_add(1, std::memory_order_relaxed);
  return out;
}

at::Tensor normalize_u8(const at::Tensor& x, double scale, double offset,
                        at::ScalarType out_dtype) {
  TORCH_CHECK(x.is_cuda(), "normalize_u8: x must be on a CUDA device");
  TORCH_CHECK(x.scalar_type() == at::kByte, "normalize_u8 takes uint8, got ",
              x.scalar_type());
  TORCH_CHECK(out_dtype == at::kFloat || out_dtype == at::kBFloat16,
              "normalize_u8 writes float32 or bfloat16, not ", out_dtype);
  c10::cuda::CUDAGuard guard(x.device());
  at::Tensor xc = x.contiguous();
  at::Tensor y = at::empty(xc.sizes(), xc.options().dtype(out_dtype));
  const int vec_ok = (reinterpret_cast<uintptr_t>(xc.data_ptr()) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y.data_ptr()) % 16 == 0);
  const int err = nnstpu_normalize_u8(
      xc.data_ptr(), y.data_ptr(), xc.numel(), static_cast<float>(scale),
      static_cast<float>(offset), out_dtype == at::kFloat ? kF32 : kBF16,
      vec_ok, c10::cuda::getCurrentCUDAStream(x.device().index()).stream());
  TORCH_CHECK(err == 0, "normalize_u8: CUDA error ", err);
  g_launches[kNormalize].fetch_add(1, std::memory_order_relaxed);
  return y;
}

}  // namespace

TORCH_LIBRARY(nnstpu_torch, m) {
  m.def("fused_inverted_residual(Tensor x, Tensor? w1, Tensor? b1, "
        "Tensor wd, Tensor bd, Tensor w2, Tensor b2, int[] plan) -> Tensor");
  m.def("normalize_u8(Tensor x, float scale, float offset, "
        "ScalarType out_dtype) -> Tensor");
}

TORCH_LIBRARY_IMPL(nnstpu_torch, CUDA, m) {
  m.impl("fused_inverted_residual", &fused_inverted_residual);
  m.impl("normalize_u8", &normalize_u8);
}

// launches of kernel k (0: fused_inverted_residual, 1: normalize_u8) made
// through these ops; -1 for an unknown k
extern "C" __attribute__((visibility("default"))) long long
nnstpu_torch_ops_launches(int k) {
  if (k < 0 || k >= kNumKernels) return -1;
  return g_launches[k].load(std::memory_order_relaxed);
}

extern "C" __attribute__((visibility("default"))) void
nnstpu_torch_ops_reset(void) {
  for (auto& c : g_launches) c.store(0, std::memory_order_relaxed);
}
