// One MobileNet-v2 inverted-residual block, BatchNorm pre-folded:
//   expand 1x1 + bias + relu6 -> depthwise 3x3 SAME, stride 1 or 2,
//   + bias + relu6 -> project 1x1 + bias (+ residual when the stride is 1
//   and Cin == Cout),
// NHWC, compute dtype bfloat16 on the main path (float32 in checks),
// float32 biases, float32 accumulation. Input [B, H, W, Cin], output
// [B, Ho, Wo, Cout] with Ho = ceil(H / stride), Wo = ceil(W / stride).
//
// Replaces the Pallas kernel nnstreamer_tpu/ops/fused_block.py::
// fused_inverted_residual (bodies _block_kernel and _block_kernel_batched)
// and, at stride 2, that function's route to inverted_residual_xla (three
// XLA convolutions: the Pallas kernel has no stride-2 body). The Pallas
// kernel keeps the 6x-wide hidden tensor in VMEM; so does this one, in
// shared memory: each block reads its input once (plus a halo where a map
// is cut into row tiles) and writes its output once.
//
// Bound on the H100. The block moves B*(H*W*Cin + Ho*Wo*Cout) elements and
// does 2*B*(H*W*Cin*Ch + Ho*Wo*(9*Ch + Ch*Cout)) operations. The 112x112
// expand=1 block is bound by bytes (about 0.05 ms at batch 128); the 14x14
// and 7x7 blocks with Ch >= 384 by the bf16 tensor-core rate; the rest sit
// near the ridge. Both 1x1 products are about 90% of the operations, so
// they run on the tensor cores. The four stride-2 blocks of MobileNet-v2
// at batch 128 are bound at about 0.036 ms together, three by bytes: the
// first (112x112x16 -> 56x56x24, hidden 96) reads 51 MB and writes 19 MB,
// while its hidden tensor alone would be 308 MB of bf16 in device memory.
// Stride 2 keeps that tensor in shared memory too, so what the block moves
// is its input and output; the expand runs on every input pixel (4x the
// output pixels), which keeps the 1x1 products' share of the work.
//
// bfloat16 design (fused_ir_tc_kernel). 512 threads (16 warps of at most
// 128 registers, so that loops waiting on shared memory have warps to hide
// behind), one CTA per SM, persistent over work items (image, R output
// rows). The wrapper's plan (ops/fused_block.py _plan_tiles) picks R so
// that small maps (14x14, 7x7) are whole images (no halo recompute) and
// larger maps have row tiles of at most 512 pixels. Per work item:
//   1. the input rows of the tile and its halo, all Cin channels, arrive
//      in shared memory by cp.async (16 B) into one of two buffers: the
//      next item's rows are in flight while this item computes;
//   2. for each chunk of Cc hidden channels (its weights staged by
//      cp.async into one of two buffers, the next chunk's in flight):
//        a. expand: [pixels x Cin] . [Cin x Cc] on mma.sync m16n8k16
//           (bf16 in, f32 sum) fed by ldmatrix, a warp per 16 pixels x 32
//           channels, + b1, relu6, rounded to bf16 into the hidden tile
//           [(R+2) x (W+2) x Cc]; its border columns, and rows outside
//           the image, hold post-activation zeros (SAME padding pads the
//           hidden tensor after relu6);
//        b. depthwise 3x3 on the CUDA cores: a thread owns two channels
//           (their 9 weights in registers) and walks 4-pixel row segments,
//           reading each hidden value once per segment row; each tap
//           product on mul.rn.bf16x2 (see Rounding), summed in f32 in the
//           JAX kernel's tap order (dy outer, dx inner), + bd, relu6,
//           rounded to bf16;
//        c. project: [R*W x Cc] . [Cc x Cout] on mma.sync, accumulated
//           over the chunks in registers; the warps split the [R*W x Cout]
//           output into 16x16 fragments (FM x FN per warp), so one CTA
//           holds every output channel of its pixels and no CTA redoes
//           another's expand or depthwise;
//   3. + b2, round to bf16, residual add in bf16 (the input is still in
//      shared memory), staged in shared memory and stored 16 B wide.
// Stride 2 (the template argument S; pads pt, pl from the plan): an item's
// R output rows r0.. read input rows 2*r0 - pt .. 2*(r0+R-1) - pt + 2, so
// consecutive tiles share one input row and its expand is computed twice
// (1 row in 2R+1). The hidden tile is [(2R+1) x (2*Wo+1) x Cc], its pad
// columns and off-image rows post-activation zeros as at stride 1 (TF
// SAME: pads (0, 1) on an even map, (1, 1) on an odd one, never
// PyTorch's symmetric padding=1). The depthwise walks 4-output-pixel
// segments reading 9 hidden values a segment row; the project and the
// epilogue run over R*Wo pixels. There is no residual at stride 2.
// Shared-memory rows are padded by 8 elements, so the 8 row addresses of
// each ldmatrix fall in distinct banks; ragged Cin, Cout and hidden chunks
// are zero-padded in shared memory, never read out of bounds. Index loops
// keep a thread's column fixed and divide by W with a multiply, since an
// integer division costs some twenty instructions.
//
// float32 (fused_ir_fma_kernel): the checks' dtype, on no main path. The
// first version's body stays for it: FMA loops over shared memory, one CTA
// per (image, R output rows, CoT output channels), accumulators in
// registers; the stride and pads are runtime values there.
//
// Rounding points, as the JAX kernel: expand sum in f32, +b1, relu6, round
// to the compute dtype; each depthwise product tap*wd rounded to the
// compute dtype before the f32 sum (fused_block.py _block_kernel, the
// `(tap * wd).astype(f32)` line); +bd, relu6, round; project sum in f32,
// +b2, round, then the residual add in the compute dtype. A product of two
// bf16 values is exact in f32, so mul.rn.bf16x2 (one rounding to nearest)
// gives the bits of the plain version's (tap.float() * wd.float()).to(bf16)
// for every product in the f32 normal range; a product below it is
// rounded twice on the plain path and may differ by one bf16 ulp there,
// inside the checks' tolerance. Only the order of the f32 sums differs.
#include "common.cuh"

namespace {

__device__ __forceinline__ float relu6(float v) {
  return fminf(fmaxf(v, 0.0f), 6.0f);
}

// ---------------------------------------------------------------------------
// float32: FMA loops (one CTA per image x R rows x CoT output channels)
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;
constexpr int kAcc = 32;  // accumulators per thread: R*Wo*CoT <= 8192

struct FmaArgs {
  const float* x;
  const float* w1;
  const float* b1;
  const float* wd;
  const float* bd;
  const float* w2;
  const float* b2;
  float* out;
  int B, H, W, Cin, Ch, Cout;
  int Ho, Wo, stride, pt, pl;  // output map, stride, SAME pads before
  int R, CoT, Cc;
  int n_row_tiles;
  int expand, residual;
};

__global__ void __launch_bounds__(kFmaThreads) fused_ir_fma_kernel(FmaArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const float* __restrict__ x = a.x;
  const float* __restrict__ w1 = a.w1;
  const float* __restrict__ wd = a.wd;
  const float* __restrict__ w2 = a.w2;
  float* __restrict__ out = a.out;

  const int H = a.H, W = a.W, Cin = a.Cin, Ch = a.Ch, Cout = a.Cout;
  const int Wo = a.Wo, S = a.stride;
  const int R = a.R, CoT = a.CoT, Cc = a.Cc;
  const int HR = (R - 1) * S + 3;   // hidden rows of a tile
  const int Wh = (Wo - 1) * S + 3;  // hidden columns, pads included
  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.n_row_tiles;
  const int y0 = (blockIdx.x % a.n_row_tiles) * R;  // first output row
  const int g0 = y0 * S - a.pt;                      // image row of hidden row 0
  const int co0 = blockIdx.y * CoT;
  const int nco = min(CoT, Cout - co0);
  const int rows = min(R, a.Ho - y0);  // valid output rows of this tile

  float* xs = reinterpret_cast<float*>(smem_raw);  // [HR, W, Cin]
  float* hid = xs + HR * W * Cin;                  // [HR, Wh, Cc]
  float* dw = hid + HR * Wh * Cc;                  // [R, Wo, Cc]
  float* w1s = dw + R * Wo * Cc;                   // [Cin, Cc]
  float* w2s = w1s + Cin * Cc;                     // [Cc, CoT]

  // 1. input rows g0 .. g0+HR-1, zero outside the image
  const long long img = static_cast<long long>(b) * H * W;
  const int row_elems = W * Cin;
  for (int i = tid; i < HR * row_elems; i += kFmaThreads) {
    const int gy = g0 + i / row_elems;
    xs[i] = (gy >= 0 && gy < H)
                ? x[(img + static_cast<long long>(gy) * W) * Cin + i % row_elems]
                : 0.0f;
  }

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  const int n_out = R * Wo * nco;

  for (int c0 = 0; c0 < Ch; c0 += Cc) {
    const int nc = min(Cc, Ch - c0);
    __syncthreads();  // xs staged / previous chunk fully consumed

    if (a.expand) {
      for (int i = tid; i < Cin * Cc; i += kFmaThreads) {
        const int c = i % Cc;
        w1s[i] = c < nc ? w1[(i / Cc) * Ch + c0 + c] : 0.0f;
      }
    }
    for (int i = tid; i < Cc * CoT; i += kFmaThreads) {
      const int c = i / CoT, co = i % CoT;
      w2s[i] = (c < nc && co < nco) ? w2[(c0 + c) * Cout + co0 + co] : 0.0f;
    }
    __syncthreads();

    // 2a. expand the halo window; post-activation zeros off the image
    for (int i = tid; i < HR * Wh * Cc; i += kFmaThreads) {
      const int c = i % Cc;
      const int q = i / Cc;
      const int gx = q % Wh - a.pl;
      const int r = q / Wh;
      const int gy = g0 + r;
      float h = 0.0f;
      if (c < nc && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const float* xp = xs + (r * W + gx) * Cin;
        if (a.expand) {
          float s = 0.0f;
          for (int k = 0; k < Cin; ++k) s = fmaf(xp[k], w1s[k * Cc + c], s);
          h = relu6(s + a.b1[c0 + c]);
        } else {
          h = xp[c0 + c];
        }
      }
      hid[i] = h;
    }
    __syncthreads();

    // 2b. depthwise 3x3 in the JAX kernel's tap order (dy outer, dx inner)
    for (int i = tid; i < R * Wo * Cc; i += kFmaThreads) {
      const int c = i % Cc;
      const int q = i / Cc;
      const int col = q % Wo;
      const int r = q / Wo;
      float s = 0.0f;
      if (c < nc) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float tap = hid[((r * S + dy) * Wh + col * S + dx) * Cc + c];
            s = __fadd_rn(s, __fmul_rn(tap, wd[(dy * 3 + dx) * Ch + c0 + c]));
          }
        }
        s = relu6(s + a.bd[c0 + c]);
      }
      dw[i] = s;
    }
    __syncthreads();

    // 2c. project the chunk into the register accumulators
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int i = tid + j * kFmaThreads;
      if (i < n_out) {
        const int co = i % nco;
        const float* dp = dw + (i / nco) * Cc;
        float s = acc[j];
        for (int c = 0; c < nc; ++c) s = fmaf(dp[c], w2s[c * CoT + co], s);
        acc[j] = s;
      }
    }
  }

  // 3. epilogue: + b2, residual add (stride 1: the output pixel is the
  // input pixel), store valid rows
  const long long img_out = static_cast<long long>(b) * a.Ho * Wo;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int i = tid + j * kFmaThreads;
    if (i < n_out) {
      const int co = i % nco;
      const int p = i / nco;
      const int r = p / Wo;
      if (r < rows) {
        const long long pix = img_out + static_cast<long long>(y0 + r) * Wo + p % Wo;
        float o = acc[j] + a.b2[co0 + co];
        if (a.residual) o = o + x[pix * Cin + co0 + co];
        out[pix * Cout + co0 + co] = o;
      }
    }
  }
}

long long fma_smem(int W, int Cin, int R, int CoT, int Cc, int stride) {
  const int Wo = (W + stride - 1) / stride;
  const long long HR = (R - 1) * stride + 3, Wh = (Wo - 1) * stride + 3;
  return 4LL * (HR * W * Cin + HR * Wh * Cc + static_cast<long long>(R) * Wo * Cc +
                Cin * Cc + Cc * CoT);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core 1x1s, persistent CTAs, cp.async staging
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCc = 64;  // hidden channels per chunk (expand fragments)
constexpr int kSeg = 4;     // pixels per depthwise row segment

// (FM, FN): 16x16 project fragments per warp along pixels and along
// output channels. Keep in step with ops/fused_block.py _TC_VARIANTS.
constexpr int kVariants[][2] = {{2, 1}, {2, 2}, {1, 3}, {1, 5}, {1, 6}};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
__host__ __device__ constexpr long long align16(long long v) {
  return (v + 15) / 16 * 16;
}

// Byte offsets into dynamic shared memory. Keep in step with
// ops/fused_block.py _tc_smem.
struct Layout {
  int CinP, CoutP;   // Cin, Cout rounded up to 16
  int xs_stride;     // elements per staged input pixel (CinP + 8)
  int w1_stride;     // elements per w1 chunk row (Cc + 8)
  int w2_stride;     // elements per w2 chunk row (CoutP + 8)
  int hid_stride;    // elements per hidden pixel (Cc + 8)
  int dw_stride;     // elements per depthwise-output pixel (Cc + 8)
  int st_stride;     // elements per staged output pixel (CoutP + 8)
  int HR, Wh;        // hidden tile rows and columns
  long long xs;      // bytes of one input buffer
  long long w2, wd, b1, bd, wbuf;  // offsets in a weight buffer; its bytes
  long long hid, st, b2, total;    // offsets from the start; total bytes
};

__host__ __device__ inline Layout make_layout(int H, int W, int Cin, int Cout,
                                              int R, int Cc, int expand,
                                              int stride) {
  Layout L;
  const int Wo = (W + stride - 1) / stride;
  L.CinP = round_up(Cin, 16);
  L.CoutP = round_up(Cout, 16);
  L.xs_stride = L.CinP + 8;
  L.w1_stride = Cc + 8;
  L.w2_stride = L.CoutP + 8;
  L.hid_stride = Cc + 8;
  L.dw_stride = Cc + 8;
  L.st_stride = L.CoutP + 8;
  L.HR = (R - 1) * stride + 3;
  L.Wh = (Wo - 1) * stride + 3;
  const int in_rows = (L.HR < H ? L.HR : H);
  const int mr = round_up(R * Wo, 16);
  const int stage = L.dw_stride > L.st_stride ? L.dw_stride : L.st_stride;
  L.xs = align16(2LL * round_up(in_rows * W, 16) * L.xs_stride);
  L.w2 = expand ? align16(2LL * L.CinP * L.w1_stride) : 0;
  L.wd = L.w2 + align16(2LL * Cc * L.w2_stride);
  L.b1 = L.wd + align16(2LL * 9 * Cc);
  L.bd = L.b1 + align16(4LL * Cc);
  L.wbuf = L.bd + align16(4LL * Cc);
  L.hid = 2 * L.xs + 2 * L.wbuf;
  L.st = L.hid + align16(2LL * L.HR * L.Wh * L.hid_stride);
  L.b2 = L.st + align16(2LL * mr * stage);
  L.total = L.b2 + align16(4LL * L.CoutP);
  return L;
}

struct TcArgs {
  const bf16* x;
  const bf16* w1;
  const float* b1;
  const bf16* wd;
  const float* bd;
  const bf16* w2;
  const float* b2;
  bf16* out;
  int B, H, W, Cin, Ch, Cout;
  int Ho, Wo, pt, pl;  // output map, SAME pads before (rows, columns)
  int R, Cc, WM;
  int n_row_tiles, n_items, n_chunks;
  int expand, residual;
  int vec_x, vec_w, vec_o;  // 16-byte global accesses allowed
  Layout L;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// f(p, v) for p < n, v < nv, the CTA's threads in groups of nv: a thread
// keeps its v and walks p, so the loop divides nothing.
template <typename F>
__device__ __forceinline__ void for_rows(int n, int nv, F f) {
  if (nv <= kThreads) {
    const int ngrp = kThreads / nv, grp = threadIdx.x / nv;
    const int v = threadIdx.x - grp * nv;
    if (grp < ngrp)
      for (int p = grp; p < n; p += ngrp) f(p, v);
  } else {
    for (int i = threadIdx.x; i < n * nv; i += kThreads) f(i / nv, i % nv);
  }
}

// A operand: 16x16 of a row-major [rows][stride] tile at p (lane's row
// address already applied by the caller).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// B operand: two 16x8 fragments of a row-major [K][N] tile, transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Both products rounded once to nearest bf16 (sm_90 instruction).
__device__ __forceinline__ bf162 mul_rn(bf162 a, bf162 b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(d)
      : "r"(*reinterpret_cast<uint32_t*>(&a)), "r"(*reinterpret_cast<uint32_t*>(&b)));
  return *reinterpret_cast<bf162*>(&d);
}

// q / d for 0 <= q, q * d < 2^32, by a multiply: m = ceil(2^32 / d) from
// magic(d) (d >= 2), or m = 0 for d == 1.
__device__ __forceinline__ uint32_t magic(int d) {
  return d > 1 ? 0xFFFFFFFFu / static_cast<uint32_t>(d) + 1u : 0u;
}
__device__ __forceinline__ int fast_div(int q, uint32_t m) {
  return m ? static_cast<int>(__umulhi(static_cast<uint32_t>(q), m)) : q;
}

// Work item -> (image, first output row, output rows, image row of hidden
// row 0, staged input rows [ylo, yhi)).
struct Item {
  int b, y0, rows, g0, ylo, yhi;
};

template <int S>
__device__ __forceinline__ Item item_of(const TcArgs& a, int item) {
  Item it;
  it.b = item / a.n_row_tiles;
  it.y0 = (item - it.b * a.n_row_tiles) * a.R;
  it.rows = min(a.R, a.Ho - it.y0);
  it.g0 = it.y0 * S - a.pt;
  it.ylo = max(it.g0, 0);
  it.yhi = min(it.g0 + (it.rows - 1) * S + 3, a.H);
  return it;
}

// The input rows [ylo, yhi) of one item into an input buffer (pixel-major,
// xs_stride elements per pixel; the padding columns stay zero).
__device__ __forceinline__ void stage_x(const TcArgs& a, const Item& it, bf16* xs) {
  const int n_px = (it.yhi - it.ylo) * a.W;
  const bf16* src = a.x + (static_cast<long long>(it.b) * a.H + it.ylo) * a.W * a.Cin;
  const int stride = a.L.xs_stride;
  if (a.vec_x) {
    const int cin = a.Cin;
    for_rows(n_px, cin / 8, [&](int p, int v) {
      cp_async16(xs + p * stride + v * 8, src + static_cast<long long>(p) * cin + v * 8);
    });
  } else {
    for (int i = threadIdx.x; i < n_px * a.Cin; i += kThreads) {
      const int p = i / a.Cin;
      xs[p * stride + (i - p * a.Cin)] = src[i];
    }
  }
}

// Hidden chunk k's weights and biases into a weight buffer.
__device__ __forceinline__ void stage_w(const TcArgs& a, int k, unsigned char* wb) {
  const int Cc = a.Cc, Ch = a.Ch, Cout = a.Cout;
  const int c0 = k * Cc;
  const int nc = min(Cc, Ch - c0);
  bf16* w1s = reinterpret_cast<bf16*>(wb);
  bf16* w2s = reinterpret_cast<bf16*>(wb + a.L.w2);
  bf16* wds = reinterpret_cast<bf16*>(wb + a.L.wd);
  float* b1s = reinterpret_cast<float*>(wb + a.L.b1);
  float* bds = reinterpret_cast<float*>(wb + a.L.bd);
  const int tid = threadIdx.x;
  if (a.vec_w) {
    const int nv = nc / 8;  // Ch % 8 == 0, so nc is too
    if (a.expand) {
      const bf16* w1 = a.w1 + c0;
      const int s1 = a.L.w1_stride;
      for_rows(a.Cin, nv, [&](int r, int v) {
        cp_async16(w1s + r * s1 + v * 8, w1 + static_cast<long long>(r) * Ch + v * 8);
      });
    }
    const bf16* w2 = a.w2 + static_cast<long long>(c0) * Cout;
    const int s2 = a.L.w2_stride;
    for_rows(nc, Cout / 8, [&](int r, int v) {
      cp_async16(w2s + r * s2 + v * 8, w2 + static_cast<long long>(r) * Cout + v * 8);
    });
    const bf16* wd = a.wd + c0;
    for_rows(9, nv, [&](int t, int v) { cp_async16(wds + t * Cc + v * 8, wd + t * Ch + v * 8); });
    for (int i = tid; i < nc / 4; i += kThreads) {
      if (a.expand) cp_async16(b1s + i * 4, a.b1 + c0 + i * 4);
      cp_async16(bds + i * 4, a.bd + c0 + i * 4);
    }
  } else {
    if (a.expand) {
      for (int i = tid; i < a.Cin * nc; i += kThreads) {
        const int r = i / nc, c = i - r * nc;
        w1s[r * a.L.w1_stride + c] = a.w1[static_cast<long long>(r) * Ch + c0 + c];
      }
    }
    for (int i = tid; i < nc * Cout; i += kThreads) {
      const int r = i / Cout, c = i - r * Cout;
      w2s[r * a.L.w2_stride + c] = a.w2[static_cast<long long>(c0 + r) * Cout + c];
    }
    for (int i = tid; i < 9 * nc; i += kThreads) {
      const int t = i / nc, c = i - t * nc;
      wds[t * Cc + c] = a.wd[t * Ch + c0 + c];
    }
    for (int i = tid; i < nc; i += kThreads) {
      if (a.expand) b1s[i] = a.b1[c0 + i];
      bds[i] = a.bd[c0 + i];
    }
  }
}

template <int FM, int FN, int S>
__global__ void __launch_bounds__(kThreads, 1) fused_ir_tc_kernel(TcArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout& L = a.L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int W = a.W, Wo = a.Wo, Cc = a.Cc, Ch = a.Ch, Cout = a.Cout;
  const int Wh = L.Wh;  // hidden tile columns: W + 2 at stride 1
  const int pl = S == 1 ? 1 : a.pl;
  const int pairs = Cc / 2;
  const int hs = L.hid_stride;
  const int n16 = Cc / 16;  // k steps of the project, n tiles of the expand
  const int nt16 = L.CoutP / 16;
  const int WM = a.WM, WN = kWarps / a.WM;
  const int wm = warp / WN, wn = warp - (warp / WN) * WN;
  const uint32_t mW = magic(W);  // pixel -> row without a division

  bf16* hid = reinterpret_cast<bf16*>(smem + L.hid);
  bf16* dws = reinterpret_cast<bf16*>(smem + L.st);  // aliased by the output stage
  float* b2s = reinterpret_cast<float*>(smem + L.b2);
  auto xbuf = [&](int i) { return reinterpret_cast<bf16*>(smem + i * L.xs); };
  auto wbuf = [&](int i) { return smem + 2 * L.xs + i * L.wbuf; };

  // Zero everything once: padding rows and columns stay zero from here on.
  for (long long i = tid * 16LL; i < L.total; i += kThreads * 16LL)
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int i = tid; i < Cout; i += kThreads) b2s[i] = a.b2[i];

  int item = blockIdx.x;
  stage_x(a, item_of<S>(a, item), xbuf(0));
  stage_w(a, 0, wbuf(0));
  cp_async_commit();

  float acc[FM][FN][2][4];
  int gchunk = 0;
  for (int xb = 0; item < a.n_items; item += gridDim.x, xb ^= 1) {
    const Item it = item_of<S>(a, item);
    const bf16* xs = xbuf(xb);
    const int hr0 = it.ylo - it.g0;  // hidden row of staged row 0
    const int n_in = (it.yhi - it.ylo) * W;
    const int n_out = it.rows * Wo;
    const int mt = (n_out + 15) / 16;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][e][q] = 0.0f;

    for (int k = 0; k < a.n_chunks; ++k, ++gchunk) {
      const int wcur = a.n_chunks > 1 ? (gchunk & 1) : 0;
      const unsigned char* wb = wbuf(wcur);
      const int c0 = k * Cc;
      cp_async_wait_all();
      __syncthreads();  // this chunk's weights (and item's rows) landed;
                        // the previous chunk is fully consumed

      // prefetch: the next item's rows, the next chunk's weights
      if (k == 0 && item + static_cast<int>(gridDim.x) < a.n_items)
        stage_x(a, item_of<S>(a, item + gridDim.x), xbuf(xb ^ 1));
      if (a.n_chunks > 1 &&
          (k + 1 < a.n_chunks || item + static_cast<int>(gridDim.x) < a.n_items))
        stage_w(a, (k + 1) % a.n_chunks, wbuf(wcur ^ 1));
      cp_async_commit();

      if (k == 0) {  // hidden rows the depthwise reads outside the image:
                     // post-activation zeros (above hr0, and from the
                     // last staged row to the tile's last read row)
        const int hr_end = (it.rows - 1) * S + 3;
        const int hr_in = hr0 + it.yhi - it.ylo;
        const int nz = hr0 + (hr_end > hr_in ? hr_end - hr_in : 0);
        const int row16 = Wh * hs / 8;  // a hidden row in 16-byte units
        for (int i = tid; i < nz * row16; i += kThreads) {
          const int zr = i / row16;
          const int hr = zr < hr0 ? zr : hr_in + zr - hr0;
          reinterpret_cast<uint4*>(hid + hr * Wh * hs)[i - zr * row16] =
              make_uint4(0, 0, 0, 0);
        }
      }

      // 2a. expand (or, for expand=1, copy the input channels)
      if (a.expand) {
        const bf16* w1s = reinterpret_cast<const bf16*>(wb);
        const float* b1s = reinterpret_cast<const float*>(wb + L.b1);
        const int mte = (n_in + 15) / 16;
        const int ks_n = L.CinP / 16;
        const int n32 = (n16 + 1) / 2;  // units of 32 hidden channels
        for (int u = warp; u < mte * n32; u += kWarps) {
          const int mi = u / n32, nn = (u - mi * n32) * 2;
          const bool two = nn + 1 < n16;
          float c[2][2][4] = {};
          const bf16* ap = xs + (mi * 16 + (lane & 15)) * L.xs_stride + (lane >> 4) * 8;
          const bf16* bp = w1s + ((lane & 7) + ((lane >> 3) & 1) * 8) * L.w1_stride +
                           nn * 16 + (lane >> 4) * 8;
#pragma unroll 2
          for (int ks = 0; ks < ks_n; ++ks) {
            uint32_t af[4], bfr[4];
            ldsm_x4(af, ap + ks * 16);
            ldsm_x4_t(bfr, bp + ks * 16 * L.w1_stride);
            mma16816(c[0][0], af, bfr[0], bfr[1]);
            mma16816(c[0][1], af, bfr[2], bfr[3]);
            if (two) {
              ldsm_x4_t(bfr, bp + ks * 16 * L.w1_stride + 16);
              mma16816(c[1][0], af, bfr[0], bfr[1]);
              mma16816(c[1][1], af, bfr[2], bfr[3]);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = mi * 16 + g + h * 8;
            if (p >= n_in) continue;
            const int pr = fast_div(p, mW);
            bf16* dst = hid + ((hr0 + pr) * Wh + p - pr * W + pl) * hs;
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              if (t == 1 && !two) break;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int ch = (nn + t) * 16 + e * 8 + 2 * tq;
                const float v0 = relu6(c[t][e][2 * h] + b1s[ch]);
                const float v1 = relu6(c[t][e][2 * h + 1] + b1s[ch + 1]);
                *reinterpret_cast<bf162*>(dst + ch) = __floats2bfloat162_rn(v0, v1);
              }
            }
          }
        }
      } else if (a.vec_x) {  // Cin % 8 == 0: 16-byte moves
        const int cin = a.Cin, xst = L.xs_stride;
        for_rows(n_in, Cc / 8, [&](int p, int v) {
          const int ch = c0 + 8 * v;
          const int pr = fast_div(p, mW), hr = hr0 + pr, col = p - pr * W;
          uint4 u = make_uint4(0, 0, 0, 0);
          if (ch < cin) u = *reinterpret_cast<const uint4*>(xs + p * xst + ch);
          *reinterpret_cast<uint4*>(hid + (hr * Wh + col + pl) * hs + 8 * v) = u;
        });
      } else {
        const int cin = a.Cin, xst = L.xs_stride;
        for_rows(n_in, pairs, [&](int p, int j) {
          const int ch = c0 + 2 * j;
          const int pr = fast_div(p, mW), hr = hr0 + pr, col = p - pr * W;
          bf162 u = __floats2bfloat162_rn(0.0f, 0.0f);
          if (ch < cin) u = *reinterpret_cast<const bf162*>(xs + p * xst + ch);
          *reinterpret_cast<bf162*>(hid + (hr * Wh + col + pl) * hs + 2 * j) = u;
        });
      }
      __syncthreads();

      // 2b. depthwise 3x3 at stride S: groups of `pairs` threads, one
      // channel pair per thread, its 9 weights in registers; a group walks
      // 4-output-pixel row segments, reading each hidden value once per
      // segment row
      if (tid < (kThreads / pairs) * pairs) {
        constexpr int kSpan = (kSeg - 1) * S + 3;  // hidden columns a segment reads
        const int ngrp = kThreads / pairs, grp = tid / pairs, j = tid - grp * pairs;
        const int hsp = hs / 2;  // hidden pixel stride in channel pairs
        const bf162* h2 = reinterpret_cast<const bf162*>(hid) + j;
        const bf162* wd2 = reinterpret_cast<const bf162*>(wb + L.wd);
        const float* bds = reinterpret_cast<const float*>(wb + L.bd);
        bf162 wv[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) wv[t] = wd2[t * pairs + j];
        const int ch = 2 * j;
        const float bx = bds[ch], by = bds[ch + 1];
        const bool vx = c0 + ch < Ch, vy = c0 + ch + 1 < Ch;
        const int nseg = (Wo + kSeg - 1) / kSeg;
        const uint32_t mseg = magic(nseg);
        const bf162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
        for (int sg = grp; sg < it.rows * nseg; sg += ngrp) {
          const int r = fast_div(sg, mseg), x0 = (sg - r * nseg) * kSeg;
          const int hx0 = x0 * S;  // hidden column of the segment's first tap
          float ax[kSeg] = {}, ay[kSeg] = {};
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const bf162* hrow = h2 + ((r * S + dy) * Wh + hx0) * hsp;
            bf162 hv[kSpan];
#pragma unroll
            for (int q = 0; q < kSpan; ++q) hv[q] = hx0 + q < Wh ? hrow[q * hsp] : zero;
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
              for (int q = 0; q < kSeg; ++q) {
                const float2 f = __bfloat1622float2(mul_rn(hv[q * S + dx], wv[dy * 3 + dx]));
                ax[q] = __fadd_rn(ax[q], f.x);
                ay[q] = __fadd_rn(ay[q], f.y);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < kSeg; ++q) {
            if (x0 + q >= Wo) break;
            const float ox = vx ? relu6(ax[q] + bx) : 0.0f;
            const float oy = vy ? relu6(ay[q] + by) : 0.0f;
            *reinterpret_cast<bf162*>(dws + (r * Wo + x0 + q) * L.dw_stride + ch) =
                __floats2bfloat162_rn(ox, oy);
          }
        }
      }
      __syncthreads();

      // 2c. project the chunk into the register accumulators
      {
        const bf16* w2s = reinterpret_cast<const bf16*>(wb + L.w2);
        for (int ks = 0; ks < n16; ++ks) {
          uint32_t af[FM][4];
#pragma unroll
          for (int i = 0; i < FM; ++i) {
            const int mi = wm + i * WM;
            if (mi < mt)
              ldsm_x4(af[i], dws + (mi * 16 + (lane & 15)) * L.dw_stride + ks * 16 +
                                 (lane >> 4) * 8);
          }
#pragma unroll
          for (int j = 0; j < FN; ++j) {
            const int nj = wn + j * WN;
            if (nj >= nt16) continue;
            uint32_t bfr[4];
            ldsm_x4_t(bfr, w2s + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.w2_stride +
                               nj * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int i = 0; i < FM; ++i) {
              if (wm + i * WM >= mt) continue;
              mma16816(acc[i][j][0], af[i], bfr[0], bfr[1]);
              mma16816(acc[i][j][1], af[i], bfr[2], bfr[3]);
            }
          }
        }
      }
    }

    // 3. epilogue: + b2, round, residual add in bf16 (stride 1), stage,
    // store 16 B wide
    __syncthreads();  // every warp is done reading the depthwise output
    bf16* st = dws;
    const int xoff = (it.y0 - it.ylo) * W;  // staged pixel of output pixel 0
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      const int mi = wm + i * WM;
      if (mi >= mt) continue;
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int nj = wn + j * WN;
        if (nj >= nt16) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = mi * 16 + g + h * 8;
          if (p >= n_out) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = nj * 16 + e * 8 + 2 * tq;
            bf162 o = __floats2bfloat162_rn(acc[i][j][e][2 * h] + b2s[co],
                                            acc[i][j][e][2 * h + 1] + b2s[co + 1]);
            if (S == 1 && a.residual) {
              const float2 of = __bfloat1622float2(o);
              const float2 xf = __bfloat1622float2(
                  *reinterpret_cast<const bf162*>(xs + (xoff + p) * L.xs_stride + co));
              o = __floats2bfloat162_rn(of.x + xf.x, of.y + xf.y);
            }
            *reinterpret_cast<bf162*>(st + p * L.st_stride + co) = o;
          }
        }
      }
    }
    __syncthreads();
    bf16* dst = a.out + (static_cast<long long>(it.b) * a.Ho + it.y0) * Wo * Cout;
    if (a.vec_o) {
      const int sst = L.st_stride;
      for_rows(n_out, Cout / 8, [&](int p, int v) {
        *reinterpret_cast<uint4*>(dst + static_cast<long long>(p) * Cout + v * 8) =
            *reinterpret_cast<const uint4*>(st + p * sst + v * 8);
      });
    } else {
      for (int i = tid; i < n_out * Cout; i += kThreads) {
        const int p = i / Cout;
        dst[i] = st[p * L.st_stride + (i - p * Cout)];
      }
    }
  }
  cp_async_wait_all();  // nothing left in flight at exit
}

// Kernel index: variant v at stride s is v + kNumVariants * (s - 1); the
// float32 kernel (either stride) is kFmaIndex.
constexpr int kFmaIndex = 2 * kNumVariants;

template <int S>
const void* tc_kernel_s(int variant) {
  switch (variant) {
    case 0: return reinterpret_cast<const void*>(&fused_ir_tc_kernel<2, 1, S>);
    case 1: return reinterpret_cast<const void*>(&fused_ir_tc_kernel<2, 2, S>);
    case 2: return reinterpret_cast<const void*>(&fused_ir_tc_kernel<1, 3, S>);
    case 3: return reinterpret_cast<const void*>(&fused_ir_tc_kernel<1, 5, S>);
    case 4: return reinterpret_cast<const void*>(&fused_ir_tc_kernel<1, 6, S>);
    default: return nullptr;
  }
}

const void* kernel_fn(int idx) {
  if (idx == kFmaIndex) return reinterpret_cast<const void*>(&fused_ir_fma_kernel);
  return idx < kNumVariants ? tc_kernel_s<1>(idx) : tc_kernel_s<2>(idx - kNumVariants);
}

// The largest dynamic shared memory a CTA may take, allowed once per
// device and kernel.
cudaError_t allow_smem(int idx) {
  static bool done[64][kFmaIndex + 1] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev][idx]) return cudaSuccess;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel_fn(idx), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem);
  if (err == cudaSuccess && dev < 64) done[dev][idx] = true;
  return err;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int S>
void launch_tc_s(const TcArgs& a, int variant, int grid, size_t bytes, cudaStream_t s) {
  switch (variant) {
    case 0: fused_ir_tc_kernel<2, 1, S><<<grid, kThreads, bytes, s>>>(a); break;
    case 1: fused_ir_tc_kernel<2, 2, S><<<grid, kThreads, bytes, s>>>(a); break;
    case 2: fused_ir_tc_kernel<1, 3, S><<<grid, kThreads, bytes, s>>>(a); break;
    case 3: fused_ir_tc_kernel<1, 5, S><<<grid, kThreads, bytes, s>>>(a); break;
    case 4: fused_ir_tc_kernel<1, 6, S><<<grid, kThreads, bytes, s>>>(a); break;
  }
}

int launch_tc(TcArgs& a, int variant, int stride, int grid, long long smem,
              cudaStream_t s) {
  if (variant < 0 || variant >= kNumVariants || grid < 1) return cudaErrorInvalidValue;
  const int FM = kVariants[variant][0], FN = kVariants[variant][1];
  if (a.Cc < 16 || a.Cc > kMaxCc || a.Cc % 16 || a.R < 1 || a.WM < 1 ||
      a.WM > kWarps || kWarps % a.WM)
    return cudaErrorInvalidValue;
  a.L = make_layout(a.H, a.W, a.Cin, a.Cout, a.R, a.Cc, a.expand, stride);
  const int mt = (a.R * a.Wo + 15) / 16;
  if (mt > FM * a.WM || a.L.CoutP / 16 > FN * (kWarps / a.WM) || smem < a.L.total)
    return cudaErrorInvalidValue;
  a.n_row_tiles = (a.Ho + a.R - 1) / a.R;
  a.n_items = a.B * a.n_row_tiles;
  a.n_chunks = (a.Ch + a.Cc - 1) / a.Cc;
  a.vec_x = a.Cin % 8 == 0 && aligned16(a.x);
  a.vec_w = a.Ch % 8 == 0 && a.Cout % 8 == 0 && aligned16(a.w2) && aligned16(a.wd) &&
            aligned16(a.bd) && (!a.expand || (aligned16(a.w1) && aligned16(a.b1)));
  a.vec_o = a.Cout % 8 == 0 && aligned16(a.out);
  if (grid > a.n_items) grid = a.n_items;
  const cudaError_t err = allow_smem(variant + kNumVariants * (stride - 1));
  if (err != cudaSuccess) return err;
  const size_t bytes = static_cast<size_t>(smem);
  if (stride == 1)
    launch_tc_s<1>(a, variant, grid, bytes, s);
  else
    launch_tc_s<2>(a, variant, grid, bytes, s);
  return cudaGetLastError();
}

int launch_fma(const FmaArgs& a, long long smem, cudaStream_t s) {
  if (a.R < 1 || a.CoT < 1 || a.Cc < 1 ||
      static_cast<long long>(a.R) * a.Wo * a.CoT > static_cast<long long>(kFmaThreads) * kAcc ||
      smem < fma_smem(a.W, a.Cin, a.R, a.CoT, a.Cc, a.stride))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(kFmaIndex);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>(a.B) * a.n_row_tiles,
                  (a.Cout + a.CoT - 1) / a.CoT);
  fused_ir_fma_kernel<<<grid, kFmaThreads, static_cast<size_t>(smem), s>>>(a);
  return cudaGetLastError();
}

// TF "SAME" padding of a 3x3 window at `stride`: the pad before the map
// (the other goes after it).
long long same_pad_before(long long size, long long stride) {
  const long long out = (size + stride - 1) / stride;
  const long long total = (out - 1) * stride + 3 - size;
  return total > 0 ? total / 2 : 0;
}

}  // namespace

// One launch, from both routes to the kernel: the ctypes wrapper
// (ops/fused_block.py, its arrays built once per block and input shape)
// and the TorchScript op (csrc/torch_ops.cc, which passes the plan through
// unread). x [B, H, W, Cin] and out [B, Ho, Wo, Cout]
// (nnstpu_fused_output_hw); w the weight pointers {w1, b1, wd, bd, w2, b2}
// (w1 and b1 null for an expand-1 block); d the shape {B, H, W, Cin, Ch,
// Cout}; dtype the compute dtype's code; f the plan in the F_* order below
// (ops/fused_block.py _launch_fields writes it): R, CoT, Cc, variant, WM,
// grid, residual, the plan's shared-memory bytes, the stride (1 or 2) and
// the SAME pads before the rows and the columns. bfloat16 uses R, Cc,
// variant, WM and grid (persistent CTAs: the card's resident CTAs, capped
// here at the work items); float32 uses R, CoT, Cc. Each path checks the
// limits its memory safety depends on and returns cudaErrorInvalidValue
// for a plan that breaks them; the pads must be the SAME pads of the
// stride, and only a stride-1 block adds the residual.
enum {
  F_R, F_COT, F_CC, F_VARIANT, F_WM, F_GRID, F_RESIDUAL, F_SMEM, F_STRIDE,
  F_PADT, F_PADL, F_COUNT
};

// The output map of a plan on an H x W input: hw = {Ho, Wo}. Returns
// cudaErrorInvalidValue for a plan the launch would refuse for its
// geometry (field count, stride, pads).
NNSTPU_EXPORT int nnstpu_fused_output_hw(long long H, long long W,
                                         const long long* f, int n,
                                         long long* hw) {
  if (n != F_COUNT) return static_cast<int>(cudaErrorInvalidValue);
  const long long s = f[F_STRIDE];
  if ((s != 1 && s != 2) || H < 0 || W < 0 || f[F_PADT] != same_pad_before(H, s) ||
      f[F_PADL] != same_pad_before(W, s) || (f[F_RESIDUAL] && s != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  hw[0] = (H + s - 1) / s;
  hw[1] = (W + s - 1) / s;
  return 0;
}

NNSTPU_EXPORT int nnstpu_fused_inverted_residual(const void* x, void* out,
                                                 const void* const* w,
                                                 const long long* d, int dtype,
                                                 const long long* f, int n,
                                                 void* stream) {
  long long hw[2];
  const int bad = nnstpu_fused_output_hw(d[1], d[2], f, n, hw);
  if (bad) return bad;
  if (d[0] <= 0 || d[1] <= 0) return 0;
  const int expand = w[0] != nullptr;
  if (expand != (w[1] != nullptr) || (!expand && d[3] != d[4]) ||
      (f[F_RESIDUAL] && d[3] != d[5]))
    return static_cast<int>(cudaErrorInvalidValue);
  auto num = [&](long long v) { return static_cast<int>(v); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int stride = num(f[F_STRIDE]);
  if (dtype == DT_BF16) {
    TcArgs a;
    a.x = static_cast<const bf16*>(x);
    a.w1 = static_cast<const bf16*>(w[0]);
    a.b1 = static_cast<const float*>(w[1]);
    a.wd = static_cast<const bf16*>(w[2]);
    a.bd = static_cast<const float*>(w[3]);
    a.w2 = static_cast<const bf16*>(w[4]);
    a.b2 = static_cast<const float*>(w[5]);
    a.out = static_cast<bf16*>(out);
    a.B = num(d[0]), a.H = num(d[1]), a.W = num(d[2]), a.Cin = num(d[3]);
    a.Ch = num(d[4]), a.Cout = num(d[5]);
    a.Ho = num(hw[0]), a.Wo = num(hw[1]);
    a.pt = num(f[F_PADT]), a.pl = num(f[F_PADL]);
    a.R = num(f[F_R]), a.Cc = num(f[F_CC]), a.WM = num(f[F_WM]);
    a.expand = expand, a.residual = num(f[F_RESIDUAL]);
    return static_cast<int>(
        launch_tc(a, num(f[F_VARIANT]), stride, num(f[F_GRID]), f[F_SMEM], s));
  }
  if (dtype == DT_F32) {
    FmaArgs a;
    a.x = static_cast<const float*>(x);
    a.w1 = static_cast<const float*>(w[0]);
    a.b1 = static_cast<const float*>(w[1]);
    a.wd = static_cast<const float*>(w[2]);
    a.bd = static_cast<const float*>(w[3]);
    a.w2 = static_cast<const float*>(w[4]);
    a.b2 = static_cast<const float*>(w[5]);
    a.out = static_cast<float*>(out);
    a.B = num(d[0]), a.H = num(d[1]), a.W = num(d[2]), a.Cin = num(d[3]);
    a.Ch = num(d[4]), a.Cout = num(d[5]);
    a.Ho = num(hw[0]), a.Wo = num(hw[1]), a.stride = stride;
    a.pt = num(f[F_PADT]), a.pl = num(f[F_PADL]);
    a.R = num(f[F_R]), a.CoT = num(f[F_COT]), a.Cc = num(f[F_CC]);
    a.n_row_tiles = (a.Ho + a.R - 1) / a.R;
    a.expand = expand, a.residual = num(f[F_RESIDUAL]);
    return static_cast<int>(launch_fma(a, f[F_SMEM], s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// What the kernel of a plan asks of the current device: out = {registers
// per thread, dynamic shared memory bytes, resident CTAs per SM}.
// variant < 0 is the float32 kernel; stride picks the bfloat16 body.
NNSTPU_EXPORT int nnstpu_fused_attributes(int variant, int stride, long long smem,
                                          int* out) {
  if (variant >= kNumVariants || (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int idx = variant < 0 ? kFmaIndex : variant + kNumVariants * (stride - 1);
  const int threads = idx == kFmaIndex ? kFmaThreads : kThreads;
  cudaError_t err = allow_smem(idx);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel_fn(idx));
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel_fn(idx), threads,
                                                        static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(smem);
  out[2] = ctas;
  return 0;
}
