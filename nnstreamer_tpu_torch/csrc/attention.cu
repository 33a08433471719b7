// Flash attention on the tensor cores, two kernels from one template:
//
//   flash_fwd_kernel   o = softmax(q kᵀ * scale [causal mask]) v, fresh
//                      carries, the output normalised and rounded to bf16;
//   flash_chunk_kernel one ring hop: folds the attention of q against one
//                      K/V chunk into float32 carries (m, l, acc) that it
//                      loads and stores back unnormalised, in place, with
//                      causal masking at the global positions
//                      q_offset + row >= k_offset + col.
//
// q: (bh, sq, d), k, v: (bh, sk, d), bfloat16; m, l: (bh, sq) and acc:
// (bh, sq, d) float32; d in {32, 64, 128}, any sq and sk.
//
// Replaces the Pallas kernels nnstreamer_tpu/ops/attention.py::
// flash_attention_pallas and flash_chunk_pallas. There one kernel instance
// per (batch*head, q block) holds the q tile and the head's whole K/V
// stream in VMEM and runs the KV loop inside the kernel; causal instances
// stop after their diagonal block. The chunk kernel reads its offsets from
// SMEM, so one compiled kernel serves every hop, and a chunk wholly in the
// causal future passes the carries through. Its tiling gate (head_dim %
// 128, block-divisible sequences, an 8 MiB VMEM budget) is the TPU's; these
// kernels have none. Here the offsets are kernel arguments (no rebuild per
// hop) and a CTA whose rows all precede the chunk's first key returns
// before it reads K/V or touches the carries.
//
// Design (simple and right first; wgmma, TMA and warp specialisation are
// later work). One CTA of 4 warps owns one (batch*head, 64-row q tile);
// each warp owns 16 q rows. The warp's q fragments stay in registers for
// the whole loop. K/V tiles of 64 keys are streamed through shared memory
// by a loop inside the CTA: K row-major, V transposed, both rows padded by
// 16 bytes so the fragment loads are free of bank conflicts. Both products
// run on the tensor cores through mma.sync m16n8k16 (bf16 in, float32
// accumulate): s = q kᵀ with the q fragments as A and K as B, then p v with
// the s accumulators re-packed in registers as A (p never touches shared
// memory) and Vᵀ as B. The running (m, l, acc) live in float32 registers;
// the chunk kernel loads them from the carries in the accumulator layout
// (each thread its rows g and g+8, columns 2t and 2t+1 of every n-tile)
// and stores them back the same way. Rows are reduced across the 4 threads
// of a quad with shuffles. Ragged tails are masked: K/V rows past sk are
// zero in shared memory and their scores are masked, q rows past sq are
// zero and never stored. Causal CTAs stop after the K tile that holds their
// last real row's global diagonal and are launched longest first.
//
// Bound on the H100: operations at long sequence. 4*bh*sq*sk*d flops
// (about half with the causal mask) against reading q, k, v and writing o
// once: causal 8x8192x128 is 137 GFLOP and 67 MB, 0.139 ms at 989 TFLOP/s.
// At ViT's 197 tokens and d 64 it is bytes. A hop of the chunk kernel also
// moves its carries in and out: at the ring's 8x2048x128 shards a diagonal
// hop is 8.6 GFLOP against 29.6 MB (q and K/V in bf16, 12.6 MB; the f32 acc
// round trip, 16.8 MB, the largest stream; m and l), about 0.009 ms by
// either count. These kernels stage K/V with synchronous loads (no
// copy/compute overlap) and issue mma.sync, not wgmma, so they reach a
// fraction of the tensor-core rate.
//
// Rounding points, as _block_attn: s = (q kᵀ in f32) * scale; masked
// entries -1e30; m_safe = 0 for rows with no unmasked key yet, and corr = 0
// for a row whose carried m is still -1e30 (the dead-row guard, which the
// chunk kernel meets on rows that have seen no key in earlier hops);
// p = exp(s - m_safe) in f32; l = corr * l + sum(p) in f32; p rounded to
// bf16 before p v, which accumulates in f32 into corr * acc; the flash
// output acc / max(l, 1e-37) rounded to bf16 (the chunk kernel stores acc
// and l unnormalised). Only the order of the float32 sums differs from the
// plain versions at the same 64-key blocks.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // q rows per CTA
constexpr int kBlockK = 64;           // keys per K/V tile
constexpr int kPad = 8;               // bf16 of padding per shared row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d[16x8] += a[16x16] * b[16x8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(d[0]), "f"(d[1]), "f"(d[2]), "f"(d[3]));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct FlashArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;  // flash: the output
  float* m;          // chunk: the carries, updated in place
  float* l;
  float* acc;
  int sq, sk, n_tiles, q_offset, k_offset, causal;
  float scale;
};

// Fragment layout of mma m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//     a3 (g+8, 2t+8..);
//   B (16x8, k x n): b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
//   C (16x8): c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1).
// The body of one CTA; kCarry = false: flash_fwd_kernel, true:
// flash_chunk_kernel.
template <int D, bool kCarry>
__device__ __forceinline__ void flash_tile(const FlashArgs& a) {
  constexpr int KS = D / 16;          // k-steps of q kᵀ
  constexpr int NS = kBlockK / 8;     // n-tiles of s
  constexpr int NO = D / 8;           // n-tiles of the output
  constexpr int CH = D / 8;           // 16-byte chunks per K/V row
  constexpr int LDK = D + kPad;       // shared row stride of K
  constexpr int LDV = kBlockK + kPad; // shared row stride of Vᵀ

  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * LDK];
  __shared__ __align__(16) __nv_bfloat16 vt[D * LDV];

  const int sq = a.sq, sk = a.sk, n_tiles = a.n_tiles, causal = a.causal;
  // One flat grid of n_tiles * bh CTAs. Causal: tile-major from the last
  // tile, so the longest tiles of every head start first and the short ones
  // fill in at the end. Otherwise head-major, so a head's q tiles run
  // together and share its K/V in L2.
  const int bh = static_cast<int>(gridDim.x) / n_tiles;
  const int tile = causal ? n_tiles - 1 - static_cast<int>(blockIdx.x) / bh
                          : static_cast<int>(blockIdx.x) % n_tiles;
  const long long head = causal ? blockIdx.x % bh : blockIdx.x / n_tiles;
  const int q0 = tile * kBlockQ;

  // key tiles this CTA folds in: causal CTAs stop after the tile holding
  // their last real row's global diagonal; a tile whose last row precedes
  // the chunk's first key has nothing to fold (the carries pass through)
  int n_kb = (sk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last = a.q_offset + min(q0 + kBlockQ, sq) - 1 - a.k_offset;
    if (last < 0) return;  // every thread of the CTA, before any barrier
    n_kb = min(n_kb, last / kBlockK + 1);
  }

  const __nv_bfloat16* qh = a.q + head * sq * D;
  const __nv_bfloat16* kh = a.k + head * sk * D;
  const __nv_bfloat16* vh = a.v + head * sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  // the rows' global positions less the chunk's first key's
  const int qpos[2] = {row[0] + a.q_offset - a.k_offset,
                       row[1] + a.q_offset - a.k_offset};

  uint32_t qf[KS][4];
#pragma unroll
  for (int st = 0; st < KS; ++st) {
    const int c = st * 16 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // h: row g or g+8
      const bool in = row[h] < sq;
      const __nv_bfloat16* p = qh + static_cast<long long>(row[h]) * D + c;
      qf[st][h] = in ? ld32(p) : 0u;
      qf[st][h + 2] = in ? ld32(p + 8) : 0u;
    }
  }

  float acc[NO][4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  if constexpr (kCarry) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= sq) continue;
      const long long r = head * sq + row[h];
      m[h] = a.m[r];
      l[h] = a.l[r];
      const float* ap = a.acc + r * D + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float2 c = *reinterpret_cast<const float2*>(ap + n * 8);
        acc[n][2 * h] = c.x;
        acc[n][2 * h + 1] = c.y;
      }
    }
  }

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kBlockK * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < sk)
        val = *reinterpret_cast<const uint4*>(
            kh + static_cast<long long>(k0 + r) * D + c * 8);
      *reinterpret_cast<uint4*>(ks + r * LDK + c * 8) = val;
    }
    // Vᵀ: each item takes a pair of keys and 8 dims, so every shared store
    // is one 32-bit word of two neighbouring keys
    for (int i = threadIdx.x; i < (kBlockK / 2) * CH; i += kThreads) {
      const int kp = i % (kBlockK / 2), c = i / (kBlockK / 2);
      const int key = k0 + 2 * kp;
      uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
      const __nv_bfloat16* src = vh + static_cast<long long>(key) * D + c * 8;
      if (key < sk) va = *reinterpret_cast<const uint4*>(src);
      if (key + 1 < sk) vb = *reinterpret_cast<const uint4*>(src + D);
      const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&va);
      const __nv_bfloat16* y = reinterpret_cast<const __nv_bfloat16*>(&vb);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        __nv_bfloat162 pr;
        pr.x = x[j];
        pr.y = y[j];
        *reinterpret_cast<__nv_bfloat162*>(vt + (c * 8 + j) * LDV + 2 * kp) =
            pr;
      }
    }
    __syncthreads();

    // s = q kᵀ (16 rows x 64 keys per warp)
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int st = 0; st < KS; ++st) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const __nv_bfloat16* kp = ks + (n * 8 + g) * LDK + st * 16 + 2 * t;
        mma_16816(s[n], qf[st], ld32(kp), ld32(kp + 8));
      }
    }

    // scale, mask, block row max
    float mb[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const bool keep = col < sk && (!causal || qpos[h] >= col);
        s[n][e] = keep ? s[n][e] * a.scale : kNegInf;
        mb[h] = fmaxf(mb[h], s[n][e]);
      }
    }
    float m_safe[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mb[h]));
      m_safe[h] = m_new <= kNegInf / 2 ? 0.0f : m_new;
      corr[h] = m[h] <= kNegInf / 2 ? 0.0f : expf(m[h] - m_safe[h]);
      m[h] = m_new;
    }
    // p = exp(s - m_safe); a masked score gives exp(-1e30 - m_safe) = 0
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        s[n][e] = expf(s[n][e] - m_safe[h]);
        rs[h] += s[n][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l[h] = __fadd_rn(__fmul_rn(corr[h], l[h]), quad_sum(rs[h]));
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += bf16(p) v: the s accumulators of key tiles 2j, 2j+1 are the
    // A fragment of k-step j
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vp = vt + (n * 8 + g) * LDV + j * 16 + 2 * t;
        mma_16816(acc[n], pa, ld32(vp), ld32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= sq) continue;
    const long long r = head * sq + row[h];
    if constexpr (kCarry) {
      a.m[r] = m[h];
      a.l[r] = l[h];
      float* ap = a.acc + r * D + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(ap + n * 8) =
            make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    } else {
      const float den = fmaxf(l[h], 1e-37f);
      __nv_bfloat16* op = a.o + r * D;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        *reinterpret_cast<uint32_t*>(op + n * 8 + 2 * t) =
            pack_bf16(acc[n][2 * h] / den, acc[n][2 * h + 1] / den);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashArgs a) {
  flash_tile<D, false>(a);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_chunk_kernel(const FlashArgs a) {
  flash_tile<D, true>(a);
}

template <int D, bool kCarry>
void launch_d(const FlashArgs& a, unsigned int grid, cudaStream_t s) {
  if constexpr (kCarry)
    flash_chunk_kernel<D><<<grid, kThreads, 0, s>>>(a);
  else
    flash_fwd_kernel<D><<<grid, kThreads, 0, s>>>(a);
}

template <bool kCarry>
int launch(FlashArgs a, int bh, int d, cudaStream_t s) {
  if (bh <= 0 || a.sq <= 0) return 0;
  a.n_tiles = (a.sq + kBlockQ - 1) / kBlockQ;
  if (static_cast<long long>(bh) * a.n_tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid = static_cast<unsigned int>(a.n_tiles) * bh;
  switch (d) {
    case 32: launch_d<32, kCarry>(a, grid, s); break;
    case 64: launch_d<64, kCarry>(a, grid, s); break;
    case 128: launch_d<128, kCarry>(a, grid, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (bh, sq, d) and k, v: (bh, sk, d), contiguous bf16 on 16-byte
// boundaries (ops/attention.py flash_attention_cuda checks and arranges it).
NNSTPU_EXPORT int nnstpu_flash_attention(const void* q, const void* k,
                                         const void* v, void* o, int bh,
                                         int sq, int sk, int d, float scale,
                                         int causal, void* stream) {
  if (sk <= 0 && bh > 0 && sq > 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a{static_cast<const __nv_bfloat16*>(q),
              static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v),
              static_cast<__nv_bfloat16*>(o), nullptr, nullptr, nullptr,
              sq, sk, 0, 0, 0, causal, scale};
  return launch<false>(a, bh, d, static_cast<cudaStream_t>(stream));
}

// One ring hop: q (bh, sq, d), k, v (bh, sk, d) contiguous bf16 on 16-byte
// boundaries; m, l (bh, sq) and acc (bh, sq, d) contiguous float32 carries,
// updated in place (ops/attention.py flash_chunk_cuda checks and arranges
// it). q_offset and k_offset are the global positions of q's and k's first
// rows; sk may be 0 (the carries pass through).
NNSTPU_EXPORT int nnstpu_flash_chunk(const void* q, const void* k,
                                     const void* v, void* m, void* l,
                                     void* acc, int bh, int sq, int sk, int d,
                                     int q_offset, int k_offset, float scale,
                                     int causal, void* stream) {
  if (sk < 0) return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a{static_cast<const __nv_bfloat16*>(q),
              static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v), nullptr,
              static_cast<float*>(m), static_cast<float*>(l),
              static_cast<float*>(acc), sq, sk, 0, q_offset, k_offset,
              causal, scale};
  return launch<true>(a, bh, d, static_cast<cudaStream_t>(stream));
}
