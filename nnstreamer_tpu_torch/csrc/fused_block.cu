// One stride-1 MobileNet-v2 inverted-residual block, BatchNorm pre-folded:
//   expand 1x1 + bias + relu6 -> depthwise 3x3 SAME + bias + relu6
//   -> project 1x1 + bias (+ residual when Cin == Cout),
// NHWC, compute dtype T (bfloat16 on the main path, float32 in checks),
// float32 biases, float32 accumulation.
//
// Replaces the Pallas kernel nnstreamer_tpu/ops/fused_block.py::
// fused_inverted_residual (bodies _block_kernel and _block_kernel_batched).
// The Pallas kernel keeps the 6x-wide hidden tensor in VMEM; its two
// bodies exist because of VMEM sizing. Here one kernel serves every
// stride-1 shape and needs no tiling gate: ragged row tiles, ragged
// output-channel tiles and ragged hidden-channel chunks are masked.
//
// Design (simple and right first; wgmma/TMA/warp specialisation are later
// work). One CTA owns one image, R output rows and CoT output channels:
//   1. stage the R+2 input rows (the halo) of all Cin channels in shared
//      memory, zero rows above and below the image;
//   2. loop over chunks of Cc hidden channels — the depthwise conv is per
//      channel, so the hidden tensor never has to exist whole:
//        a. expand the (R+2) x (W+2) halo window for the chunk into shared
//           memory: float32 sum, + b1, relu6, rounded to T; positions
//           outside the image hold post-activation zeros (SAME padding
//           pads the hidden tensor after its activation);
//        b. the 9 depthwise taps for the R x W outputs of the chunk,
//           + bd, relu6, rounded to T, into shared memory;
//        c. dw[R*W, Cc] @ w2[Cc, CoT] added into float32 accumulators held
//           in registers (each thread owns up to kAcc outputs);
//   3. + b2, round to T, residual add in T, store the valid rows.
// Both 1x1 products are FMA loops in this kernel (no library call).
//
// Bound on the H100: at the main path's shapes the block moves
// B*H*W*(Cin+Cout) elements and does 2*B*H*W*(Cin*Ch + 9*Ch + Ch*Cout)
// operations, so its floor is the bf16 tensor-core rate for the wide
// blocks and memory for the narrow ones. This kernel runs its products on
// the CUDA cores from shared memory, so it is bound by shared-memory
// loads and float32 issue, far above that floor: the tensor-core version
// is later work. What the design does keep is the Pallas kernel's point:
// the hidden tensor never touches device memory, so each block reads its
// input once (plus a two-row halo) and writes its output once.
//
// Rounding points. JAX kernel: expand sum in f32, +b1, relu6, round to
// the compute dtype; each depthwise product tap*wd rounded to the compute
// dtype before the f32 sum (fused_block.py _block_kernel, the
// `(tap * wd).astype(f32)` line); +bd, relu6, round; project sum in f32,
// +b2, round to the compute dtype, then the residual add in the compute
// dtype. This kernel rounds at the same points; only the order of the
// float32 sums differs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAcc = 32;  // accumulators per thread: R*W*CoT <= 8192

struct FusedIR {
  const void* x;
  const void* w1;
  const float* b1;
  const void* wd;
  const float* bd;
  const void* w2;
  const float* b2;
  void* out;
  int B, H, W, Cin, Ch, Cout;
  int R, CoT, Cc;
  int n_row_tiles;
  int expand, residual;
};

__device__ __forceinline__ float relu6(float v) {
  return fminf(fmaxf(v, 0.0f), 6.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_ir_kernel(FusedIR a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ w1 = static_cast<const T*>(a.w1);
  const T* __restrict__ wd = static_cast<const T*>(a.wd);
  const T* __restrict__ w2 = static_cast<const T*>(a.w2);
  T* __restrict__ out = static_cast<T*>(a.out);

  const int H = a.H, W = a.W, Cin = a.Cin, Ch = a.Ch, Cout = a.Cout;
  const int R = a.R, CoT = a.CoT, Cc = a.Cc;
  const int W2 = W + 2;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.n_row_tiles;
  const int y0 = (blockIdx.x % a.n_row_tiles) * R;
  const int co0 = blockIdx.y * CoT;
  const int nco = min(CoT, Cout - co0);
  const int rows = min(R, H - y0);  // valid output rows of this tile

  T* xs = reinterpret_cast<T*>(smem_raw);  // [(R+2), W, Cin]
  T* hid = xs + (R + 2) * W * Cin;         // [(R+2), W+2, Cc]
  T* dw = hid + (R + 2) * W2 * Cc;         // [R, W, Cc]
  T* w1s = dw + R * W * Cc;                // [Cin, Cc]
  T* w2s = w1s + Cin * Cc;                 // [Cc, CoT]

  // 1. input rows y0-1 .. y0+R, zero outside the image
  const long long img = static_cast<long long>(b) * H * W;
  const int row_elems = W * Cin;
  for (int i = tid; i < (R + 2) * row_elems; i += kThreads) {
    const int gy = y0 - 1 + i / row_elems;
    xs[i] = (gy >= 0 && gy < H)
                ? x[(img + static_cast<long long>(gy) * W) * Cin + i % row_elems]
                : from_f32<T>(0.0f);
  }

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  const int n_out = R * W * nco;

  for (int c0 = 0; c0 < Ch; c0 += Cc) {
    const int nc = min(Cc, Ch - c0);
    __syncthreads();  // xs staged / previous chunk fully consumed

    // weights of this chunk
    if (a.expand) {
      for (int i = tid; i < Cin * Cc; i += kThreads) {
        const int c = i % Cc;
        w1s[i] = c < nc ? w1[(i / Cc) * Ch + c0 + c] : from_f32<T>(0.0f);
      }
    }
    for (int i = tid; i < Cc * CoT; i += kThreads) {
      const int c = i / CoT, co = i % CoT;
      w2s[i] = (c < nc && co < nco) ? w2[(c0 + c) * Cout + co0 + co]
                                    : from_f32<T>(0.0f);
    }
    __syncthreads();

    // 2a. expand the halo window; post-activation zeros off the image
    for (int i = tid; i < (R + 2) * W2 * Cc; i += kThreads) {
      const int c = i % Cc;
      const int q = i / Cc;
      const int gx = q % W2 - 1;
      const int r = q / W2;
      const int gy = y0 - 1 + r;
      float h = 0.0f;
      if (c < nc && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const T* xp = xs + (r * W + gx) * Cin;
        if (a.expand) {
          float s = 0.0f;
          for (int k = 0; k < Cin; ++k)
            s = fmaf(to_f32<T>(xp[k]), to_f32<T>(w1s[k * Cc + c]), s);
          h = relu6(s + a.b1[c0 + c]);
        } else {
          h = to_f32<T>(xp[c0 + c]);
        }
      }
      hid[i] = from_f32<T>(h);
    }
    __syncthreads();

    // 2b. depthwise 3x3: each product rounded to T, summed in f32 in the
    // JAX kernel's tap order (dy outer, dx inner)
    for (int i = tid; i < R * W * Cc; i += kThreads) {
      const int c = i % Cc;
      const int q = i / Cc;
      const int col = q % W;
      const int r = q / W;
      float s = 0.0f;
      if (c < nc) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float tap = to_f32<T>(hid[((r + dy) * W2 + col + dx) * Cc + c]);
            const float wv = to_f32<T>(wd[(dy * 3 + dx) * Ch + c0 + c]);
            s = __fadd_rn(s, round_to<T>(__fmul_rn(tap, wv)));
          }
        }
        s = relu6(s + a.bd[c0 + c]);
      }
      dw[i] = from_f32<T>(s);
    }
    __syncthreads();

    // 2c. project the chunk into the register accumulators
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int i = tid + j * kThreads;
      if (i < n_out) {
        const int co = i % nco;
        const T* dp = dw + (i / nco) * Cc;
        float s = acc[j];
        for (int c = 0; c < nc; ++c)
          s = fmaf(to_f32<T>(dp[c]), to_f32<T>(w2s[c * CoT + co]), s);
        acc[j] = s;
      }
    }
  }

  // 3. epilogue: + b2, round to T, residual add in T, store valid rows
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < n_out) {
      const int co = i % nco;
      const int p = i / nco;
      const int r = p / W;
      if (r < rows) {
        const long long pix = img + static_cast<long long>(y0 + r) * W + p % W;
        float o = round_to<T>(acc[j] + a.b2[co0 + co]);
        if (a.residual) o = o + to_f32<T>(x[pix * Cin + co0 + co]);
        out[pix * Cout + co0 + co] = from_f32<T>(o);
      }
    }
  }
}

template <typename T>
int launch(const FusedIR& a, int n_co_tiles, long long smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_ir_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned int>(a.B) * a.n_row_tiles, n_co_tiles);
  fused_ir_kernel<T><<<grid, kThreads, static_cast<size_t>(smem), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tile plan (R, CoT, Cc) and its shared-memory size come from
// ops/fused_block.py _plan_tiles; the kernel checks the one limit it
// depends on for memory safety (R*W*CoT accumulators).
NNSTPU_EXPORT int nnstpu_fused_inverted_residual(
    const void* x, const void* w1, const void* b1, const void* wd,
    const void* bd, const void* w2, const void* b2, void* out, int B, int H,
    int W, int Cin, int Ch, int Cout, int R, int CoT, int Cc, int expand,
    int residual, int dtype, long long smem, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (R < 1 || CoT < 1 || Cc < 1 ||
      static_cast<long long>(R) * W * CoT > static_cast<long long>(kThreads) * kAcc)
    return static_cast<int>(cudaErrorInvalidValue);
  FusedIR a;
  a.x = x;
  a.w1 = w1;
  a.b1 = static_cast<const float*>(b1);
  a.wd = wd;
  a.bd = static_cast<const float*>(bd);
  a.w2 = w2;
  a.b2 = static_cast<const float*>(b2);
  a.out = out;
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Ch = Ch;
  a.Cout = Cout;
  a.R = R;
  a.CoT = CoT;
  a.Cc = Cc;
  a.n_row_tiles = (H + R - 1) / R;
  a.expand = expand;
  a.residual = residual;
  const int n_co_tiles = (Cout + CoT - 1) / CoT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return launch<float>(a, n_co_tiles, smem, s);
    case DT_BF16: return launch<__nv_bfloat16>(a, n_co_tiles, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
