// Flash attention on Hopper, two kernels from each of two CTA bodies
// (flash_fwd_kernel and flash_chunk_kernel from the tensor-core body,
// flash_fwd_simple_kernel and flash_chunk_simple_kernel from the simple
// one):
//
//   flash_fwd_*        o = softmax(q kᵀ * scale [causal mask]) v, fresh
//                      carries, the output normalised and rounded to q's
//                      dtype;
//   flash_chunk_*      one ring hop: folds the attention of q against one
//                      K/V chunk into float32 carries (m, l, acc) that it
//                      loads and stores back unnormalised, in place, with
//                      causal masking at the global positions
//                      q_offset + row >= k_offset + col.
//
// q: (bh, sq, d), k, v: (bh, sk, d), bfloat16 or float32; m, l: (bh, sq)
// and acc: (bh, sq, d) float32; any d >= 1, any sq and sk.
// The dtype and d pick the body and its instantiation (instance_of):
//   - the tensor-core body, flash_tile<D, kCarry>: bfloat16 with d one of
//     kTcDims (16, the long-context example's head dim, and the main-path
//     32, 64 and 128), row strides and column bounds compile-time;
//   - the simple body, flash_simple<NJ, kCarry>: float32 inputs, and bf16
//     at every other d, at the least D = 16 * NJ of kSimpleDims not below
//     d;
//   - above kSliceCols (256), the simple body split over the head dim,
//     flash_simple<16, kCarry, true>: the grid's third dimension cuts the
//     output's columns into slices of kSliceCols, and each CTA forms the
//     full scores and accumulates only its slice of p v.
//     float32 stays float32: both products are float32 FMAs (no TF32 and
//     no bf16 cast, which would miss the reference's tolerance).
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
// before it touches a barrier, K/V or the carries.
//
// Bound on an H100 SXM (published peaks at its 700 W limit: 989 TFLOP/s
// bf16 dense, 67 TFLOP/s float32 without tensor cores, 3.35 TB/s):
// operations at long sequence, 4*bh*sq*sk*d flops (about half with the
// causal mask) against reading q, k, v and writing o once: causal
// 8x8192x128 bf16 is 137 GFLOP and 67 MB, 0.139 ms by operations; causal
// 8x4096x128 float32 is 34 GFLOP, 0.51 ms by operations. At ViT's 197
// tokens and d 64 it is bytes: 768x197x64 moves 77 MB, 0.023 ms. A hop of
// the chunk kernel also moves its carries in and out: at the ring's
// 8x2048x128 shards a diagonal hop is 8.6 GFLOP against 29.6 MB (the f32
// acc round trip, 16.8 MB, the largest stream), about 0.009 ms either way;
// a past hop 17.2 GFLOP, 0.017 ms by operations.
//
// The tensor-core body's design for that bound: both products on wgmma,
// K/V streamed by TMA, and warp specialisation, so that the tensor cores
// are fed without threads spending instructions on copies. One CTA of
// three warpgroups owns one (batch*head, 128-row q tile):
//   - a producer warpgroup gives up its registers (setmaxnreg.dec); one
//     thread loads the q tile once and then 128-key K and V tiles into a
//     ring of three stages in dynamic shared memory with TMA
//     (cp.async.bulk.tensor, 3-D maps over (d, seq, bh), so rows past sq or
//     sk are zero-filled and never read from the next head), each stage
//     guarded by full (transaction-count) and empty mbarriers;
//   - two consumer warpgroups take its registers (setmaxnreg.inc), 64 q
//     rows each. s = q kᵀ is wgmma m64n128k16 with both operands in shared
//     memory, K-major. p stays in registers: the f32 s accumulators of two
//     neighbouring 8-column groups, rounded to bf16, are the A fragment of
//     one k-step of o += p v (the wgmma accumulator layout per warp is the
//     A-register layout), and V is read as TMA left it, (keys, d), through
//     the transpose bit (MN-major B). The tensor cores run a tile ahead:
//     a warpgroup issues s of tile j and p v of tile j - 1 together and
//     runs the softmax of tile j while p v is still in flight, so each
//     warpgroup overlaps its own exp work with its products (a K/V stage
//     is freed only when its p v is done, hence the third stage). The
//     online softmax runs in registers, rows reduced across the 4 threads
//     of a quad; the causal and ragged masks run only on tiles that cross
//     a row's diagonal or the end of the keys. The running (m, l, acc) are
//     float32 registers; the chunk kernel loads them from the carries in
//     the accumulator layout (each thread its rows g and g+8, columns 8i+2t
//     and 8i+2t+1) and stores them back the same way.
// Shared rows are swizzled as wide as a row allows (128 B at D 64, 64 B at
// D 32, 32 B at D 16, two 64-column panels at D 128), the same mode in the
// tensor maps and the wgmma descriptors. Causal CTAs stop after the K tile
// that holds their last real row's global diagonal and are launched
// longest first.
//
// Rounding points, as _block_attn: s = (q kᵀ in f32) * scale; masked
// entries -1e30; m_safe = 0 for rows with no unmasked key yet, and corr = 0
// for a row whose carried m is still -1e30 (the dead-row guard, which the
// chunk kernel meets on rows that have seen no key in earlier hops);
// p = exp(s - m_safe) in f32 (as exp2 of a fused (s - m_safe) * log2 e);
// l = corr * l + sum(p) in f32; p rounded to bf16 before p v, which
// accumulates in f32 into corr * acc; the flash output acc / max(l, 1e-37)
// rounded to bf16 (the chunk kernel stores acc and l unnormalised). Only
// the order of the float32 sums and exp's last bits differ from the plain
// versions at the same 128-key blocks.
//
// The simple body is written to be right at every d, not to be fast. One
// CTA of 256 threads owns one (batch*head, 64-row q tile), and each thread
// 4 of its rows (ty = thread / 16) by every 16th column (tx = thread % 16).
// The q tile sits in shared memory as float32, rows at an odd stride. For
// each 128-key block (kBlockK, the plain versions' BLOCK_K, so that a bf16
// p is rounded at the same running max): s = q kᵀ as 4 x 8 float32 FMA
// accumulators a thread, K staged 32 head-dim columns at a time (rows
// padded to 33 floats: no bank conflicts); the online softmax in those
// registers, rows reduced over the 16 threads that share them; p (rounded
// to bf16 for a bf16 input) through shared memory; o += p v as 4 x NJ
// FMA accumulators, V staged 32 keys at a time. Loads convert bf16 to
// float32 exactly and zero-fill past sq, sk and d. The rounding points are
// the tensor-core body's, with expf for exp and the output divided in
// IEEE float32 before its one rounding to q's dtype.
//
// Above kSliceCols the q tile no longer fits beside p and a V stage (at d
// 512 float32 it alone is 131 KB, the layout 230 KB against a CTA's 227
// KB), so the split body keeps none of it: it stages q's 64 rows through
// shared memory in the same kKc-column chunks as K, and a V stage holds
// only the CTA's slice of columns (about 75 KB at every d). Every slice
// computes the same scores in the same order, so m, l and p agree bit for
// bit across slices and with the unsplit body; the split costs
// ceil(d / 256) times the q kᵀ work and the reads of q and K, and is
// meant to be right, not fast. The split chunk kernel reads the carried m
// and l in every slice, so no slice may overwrite them in place: the first
// slice writes the new m and l to scratch outputs (passing a future CTA's
// rows through), and the launch copies them over the carries after the
// kernel, in stream order (cudaMemcpyAsync, no extra kernel).
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 128;   // q rows per CTA, 64 per consumer warpgroup
constexpr int kBlockK = 128;   // keys per K/V tile
constexpr int kStages = 3;     // K/V tiles in flight
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBlockQ == 64 * kConsumers && kBlockK == kBlockQ,
              "q and K/V tiles share one shared-memory tile shape");

// One 128-row tile of q, K or V in shared memory: kPanels panels of 128
// rows by kCols bf16, each row kRowBytes wide and swizzled across it.
template <int D>
struct Tile {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = kCols * 2;  // 32, 64 or 128: the swizzle
  static constexpr int kPanels = D / kCols;
  static constexpr int kPanelBytes = kBlockK * kRowBytes;
  static constexpr int kBytes = kPanels * kPanelBytes;
  static constexpr int kStepsPerPanel = kCols / 16;  // k-steps of q kᵀ
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr uint64_t kLayout =
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  // q, kStages K and V tiles, the barriers, and room to align to 1024 B
  static constexpr int kSmem = (1 + 2 * kStages) * kBytes + 1024 + 128;
};

// The instantiations (tests/test_torch_attention.py reads these lines):
// the tensor-core body's D, the simple body's D = 16 * NJ, and the output
// columns a CTA of the split body writes (the last simple D).
constexpr int kTcDims[] = {16, 32, 64, 128};
constexpr int kSimpleDims[] = {32, 64, 128, 256};
constexpr int kSliceCols = 256;

// The tensor-core body's arguments (it reads q, k and v through its tensor
// maps).
struct FlashArgs {
  __nv_bfloat16* o;  // flash: the output
  float* m;          // chunk: the carries, updated in place
  float* l;
  float* acc;
  int sq, sk, n_tiles, q_offset, k_offset, causal;
  float scale;
};

// The simple body's: the tensor-core body's, the inputs, head_dim and
// dtype, and the split chunk kernel's new m and l (scratch, copied over
// f.m and f.l after the kernel).
struct SimpleArgs {
  FlashArgs f;       // f.o is cast to q's dtype
  const void* q;
  const void* k;
  const void* v;
  int d, bf16;
  float* m_out;
  float* l_out;
};

// -- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of the given parity has completed (a fresh barrier
// is in phase 0: waiting on parity 1 passes at once).
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box of a 3-D map (coordinates innermost first) into shared
// memory; its bytes count against the barrier's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma operands across
// the asynchronous instructions that use them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define WG_ACC4(d, i) \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define WG_ACC16(d, i) \
  WG_ACC4(d, i), WG_ACC4(d, (i) + 4), WG_ACC4(d, (i) + 8), WG_ACC4(d, (i) + 12)
#define WG_ACC32(d) WG_ACC16(d, 0), WG_ACC16(d, 16)
#define WG_ACC64(d) WG_ACC16(d, 0), WG_ACC16(d, 16), WG_ACC16(d, 32), \
                    WG_ACC16(d, 48)

// s[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B K-major in shared
// memory (descriptors da, db); scale_d = 0 overwrites s.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// o[64 x D] += P[64 x 16] * V[16 x D]: P from registers (the A fragment a),
// V MN-major in shared memory (descriptor db, transpose bit set).
__device__ __forceinline__ void wgmma_pv(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WG_ACC16(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : WG_ACC4(d, 0), WG_ACC4(d, 4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// s[64 x 128] = q[64 x D] kᵀ for one warpgroup: q_wg its 64 q rows, kt the
// K tile, both K-major (8-row groups 8 rows apart, each k-step 32 bytes
// further along a swizzled row, 64-column panels a panel apart). Committed
// as one group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_wg,
                                         uint32_t kt) {
  using T = Tile<D>;
#pragma unroll
  for (int st = 0; st < D / 16; ++st) {
    const uint32_t off = (st / T::kStepsPerPanel) * T::kPanelBytes +
                         (st % T::kStepsPerPanel) * 32;
    wgmma_qk(sc, smem_desc(q_wg + off, 16, 8 * T::kRowBytes, T::kLayout),
             smem_desc(kt + off, 16, 8 * T::kRowBytes, T::kLayout), st > 0);
  }
  wgmma_commit();
}

// o[64 x D] += bf16(p)[64 x 128] v: pa the A fragments of p's 8 k-steps,
// vt the V tile, MN-major (8-key groups 8 rows apart, each k-step 16 rows
// further, 64-column panels a panel apart). Committed as one group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[kBlockK / 16][4],
                                         uint32_t vt) {
  using T = Tile<D>;
#pragma unroll
  for (int j = 0; j < kBlockK / 16; ++j)
    wgmma_pv(acc, pa[j],
             smem_desc(vt + 16 * j * T::kRowBytes, T::kPanelBytes,
                       8 * T::kRowBytes, T::kLayout));
  wgmma_commit();
}

// The online softmax of one 128-key tile for one thread's rows g and g+8,
// s in the accumulator layout: scale (and mask) s, update the running max m
// and sum l, set corr to the factor that rescales acc, and leave p =
// exp(s - m_safe) in s.
struct Softmax {
  float scale;
  int sk, causal, t;
  int qpos[2];   // the rows' global positions less the chunk's first key's
  int first;     // the warpgroup's least such position

  __device__ __forceinline__ void tile(float (&sc)[kBlockK / 2], int k0,
                                       float (&m)[2],
                                       float (&l)[2], float (&corr)[2]) const {
    // mask only a tile that crosses the end of the keys or, when causal, a
    // row's diagonal
    if (k0 + kBlockK > sk || (causal && first < k0 + kBlockK - 1)) {
#pragma unroll
      for (int i = 0; i < kBlockK / 2; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        const bool keep = col < sk && (!causal || qpos[(i / 2) & 1] >= col);
        sc[i] = keep ? sc[i] * scale : kNegInf;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBlockK / 2; ++i) sc[i] *= scale;
    }
    // row maxima and sums in 4 independent chains per row
    float part[2][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) part[i / 4][i % 4] = kNegInf;
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i)
      part[(i / 2) & 1][(i / 4) & 3] =
          fmaxf(part[(i / 2) & 1][(i / 4) & 3], sc[i]);
    float m_log2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mb = fmaxf(fmaxf(part[h][0], part[h][1]),
                             fmaxf(part[h][2], part[h][3]));
      const float m_new = fmaxf(m[h], quad_max(mb));
      const float m_safe = m_new <= kNegInf / 2 ? 0.0f : m_new;
      corr[h] = m[h] <= kNegInf / 2 ? 0.0f : expf(m[h] - m_safe);
      m_log2[h] = m_safe * kLog2e;
      m[h] = m_new;
    }
    // p = exp(s - m_safe); a masked score gives exp2(-1.4e30) = 0
#pragma unroll
    for (int i = 0; i < 8; ++i) part[i / 4][i % 4] = 0.0f;
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) {
      sc[i] = ex2(fmaf(sc[i], kLog2e, -m_log2[(i / 2) & 1]));
      part[(i / 2) & 1][(i / 4) & 3] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float rs = (part[h][0] + part[h][1]) + (part[h][2] + part[h][3]);
      l[h] = __fadd_rn(__fmul_rn(corr[h], l[h]), quad_sum(rs));
    }
  }
};

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) & 1];
}

// bf16(p): the s accumulators of column groups 2j and 2j+1 are the A
// fragment of k-step j of p v.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kBlockK / 16][4],
                                       const float (&sc)[kBlockK / 2]) {
#pragma unroll
  for (int j = 0; j < kBlockK / 16; ++j) {
    pa[j][0] = pack_bf16(sc[8 * j], sc[8 * j + 1]);
    pa[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
    pa[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
    pa[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
  }
}

// -- the CTA body -----------------------------------------------------------

// Accumulator layout of wgmma m64nN (f32), per thread of warp w of the
// warpgroup (g = lane / 4, t = lane % 4): d[4i + e] holds row 16w + g +
// 8 (e / 2), column 8i + 2t + e % 2. The A fragment of a k16 step in
// registers is the same layout over two 8-column groups:
// a = {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}.
// kCarry = false: flash_fwd_kernel, true: flash_chunk_kernel.
template <int D, bool kCarry>
__device__ __forceinline__ void flash_tile(const CUtensorMap& tq,
                                           const CUtensorMap& tk,
                                           const CUtensorMap& tv,
                                           const FlashArgs& a) {
  using T = Tile<D>;
  constexpr int NO = D / 8;        // 8-column groups of the output

  const int sq = a.sq, sk = a.sk, n_tiles = a.n_tiles, causal = a.causal;
  // One flat grid of n_tiles * bh CTAs. Causal: tile-major from the last
  // tile, so the longest tiles of every head start first and the short ones
  // fill in at the end. Otherwise head-major, so a head's q tiles run
  // together and share its K/V in L2.
  const int bh = static_cast<int>(gridDim.x) / n_tiles;
  const int tile = causal ? n_tiles - 1 - static_cast<int>(blockIdx.x) / bh
                          : static_cast<int>(blockIdx.x) % n_tiles;
  const int head = causal ? static_cast<int>(blockIdx.x) % bh
                          : static_cast<int>(blockIdx.x) / n_tiles;
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

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + T::kBytes;                   // + stage * kBytes
  const uint32_t v_s = base + (1 + kStages) * T::kBytes;   // + stage * kBytes
  const uint32_t bars = base + (1 + 2 * kStages) * T::kBytes;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;                        // + 8 * stage
  const uint32_t v_full = bars + 8 * (1 + kStages);
  const uint32_t empty = bars + 8 * (1 + 2 * kStages);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = static_cast<int>(threadIdx.x) / 128;
  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kBytes);
#pragma unroll
      for (int p = 0; p < T::kPanels; ++p)
        tma_load(q_s + p * T::kPanelBytes, tq, q_full, p * T::kCols, q0, head);
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % kStages;
        mbar_wait(empty + 8 * s, ((kb / kStages) & 1) ^ 1);
        const uint32_t kd = k_s + s * T::kBytes, vd = v_s + s * T::kBytes;
        mbar_expect_tx(k_full + 8 * s, T::kBytes);
#pragma unroll
        for (int p = 0; p < T::kPanels; ++p)
          tma_load(kd + p * T::kPanelBytes, tk, k_full + 8 * s, p * T::kCols,
                   kb * kBlockK, head);
        mbar_expect_tx(v_full + 8 * s, T::kBytes);
#pragma unroll
        for (int p = 0; p < T::kPanels; ++p)
          tma_load(vd + p * T::kPanelBytes, tv, v_full + 8 * s, p * T::kCols,
                   kb * kBlockK, head);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;  // consumer warpgroup: q rows 64c .. 64c + 63
    const int tid = static_cast<int>(threadIdx.x) % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row[2] = {q0 + 64 * c + 16 * warp + g,
                        q0 + 64 * c + 16 * warp + g + 8};
    const int shift = a.q_offset - a.k_offset;

    float acc[D / 2];
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    if constexpr (kCarry) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row[h] >= sq) continue;
        const long long r = static_cast<long long>(head) * sq + row[h];
        m[h] = a.m[r];
        l[h] = a.l[r];
        const float* ap = a.acc + r * D + 2 * t;
#pragma unroll
        for (int i = 0; i < NO; ++i) {
          const float2 v = *reinterpret_cast<const float2*>(ap + 8 * i);
          acc[4 * i + 2 * h] = v.x;
          acc[4 * i + 2 * h + 1] = v.y;
        }
      }
    }

    // The tensor cores run one tile ahead of the softmax: iteration kb
    // issues s = q kᵀ of tile kb and then o += bf16(p) v of tile kb - 1,
    // waits for s alone, and runs the softmax of tile kb while the previous
    // tile's p v is still on the tensor cores. pa holds bf16(p) of the
    // tile whose p v comes next. Tile 0 has no p v before it and the last
    // p v no tile after it, so both are outside the loop, which keeps the
    // loop body free of branches around the asynchronous products.
    const Softmax sm{a.scale, sk, causal, t,
                     {row[0] + shift, row[1] + shift}, q0 + 64 * c + shift};
    const uint32_t q_wg = q_s + 64 * c * T::kRowBytes;
    float sc[kBlockK / 2], corr[2];
    uint32_t pa[kBlockK / 16][4];
    mbar_wait(q_full, 0);
    if (n_kb > 0) {
      mbar_wait(k_full, 0);
      fence_regs(sc);
      wgmma_fence();
      issue_qk<D>(sc, q_wg, k_s);
      wgmma_wait<0>();
      fence_regs(sc);
      sm.tile(sc, 0, m, l, corr);
      rescale<D>(acc, corr);
      pack_p(pa, sc);
    }
    for (int kb = 1; kb < n_kb; ++kb) {
      const int s = kb % kStages, ps = (kb - 1) % kStages;
      mbar_wait(k_full + 8 * s, (kb / kStages) & 1);
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_qk<D>(sc, q_wg, k_s + s * T::kBytes);
      mbar_wait(v_full + 8 * ps, ((kb - 1) / kStages) & 1);
      issue_pv<D>(acc, pa, v_s + ps * T::kBytes);
      wgmma_wait<1>();  // s is ready; p v may still run
      fence_regs(sc);
      sm.tile(sc, kb * kBlockK, m, l, corr);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(empty + 8 * ps);  // the previous tile's K and V are used
      rescale<D>(acc, corr);
      pack_p(pa, sc);
    }
    if (n_kb > 0) {  // the last tile's p v
      const int ps = (n_kb - 1) % kStages;
      mbar_wait(v_full + 8 * ps, ((n_kb - 1) / kStages) & 1);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_pv<D>(acc, pa, v_s + ps * T::kBytes);
      wgmma_wait<0>();
      fence_regs(acc);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= sq) continue;
      const long long r = static_cast<long long>(head) * sq + row[h];
      if constexpr (kCarry) {
        a.m[r] = m[h];
        a.l[r] = l[h];
        float* ap = a.acc + r * D + 2 * t;
#pragma unroll
        for (int i = 0; i < NO; ++i)
          *reinterpret_cast<float2*>(ap + 8 * i) =
              make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      } else {
        const float den = fmaxf(l[h], 1e-37f);
        __nv_bfloat16* op = a.o + r * D + 2 * t;
#pragma unroll
        for (int i = 0; i < NO; ++i)
          *reinterpret_cast<uint32_t*>(op + 8 * i) = pack_bf16(
              acc[4 * i + 2 * h] / den, acc[4 * i + 2 * h + 1] / den);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const FlashArgs a) {
  flash_tile<D, false>(tq, tk, tv, a);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_chunk_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const FlashArgs a) {
  flash_tile<D, true>(tq, tk, tv, a);
}

// -- the simple body --------------------------------------------------------

constexpr int kSimpleQ = 64;         // q rows per CTA, 4 per thread row
constexpr int kSimpleThreads = 256;  // 16 thread rows x 16 thread columns
constexpr int kKc = 32;              // head-dim columns of K per stage
constexpr int kKld = kKc + 1;        // K stage row stride (floats)
constexpr int kVk = 32;              // keys of V per stage
constexpr int kPld = kBlockK + 1;    // p row stride (floats)
static_assert(kSimpleThreads == 16 * (kSimpleQ / 4) && kBlockK == 16 * 8,
              "a thread owns 4 rows and every 16th of a block's 128 keys");

// Shared floats of the simple body at head_dim d in the instantiation of
// width D: q at an odd row stride, p, and one stage that holds a K chunk or
// a V chunk (a thread reads V up to column D - 1 of its last row).
__host__ __device__ constexpr int simple_qld(int d) { return d | 1; }
__host__ __device__ constexpr int simple_stage(int d, int D) {
  return kBlockK * kKld > kVk * d + D ? kBlockK * kKld : kVk * d + D;
}
constexpr int simple_smem(int d, int D) {
  return 4 * (kSimpleQ * simple_qld(d) + kSimpleQ * kPld +
              simple_stage(d, D));
}
// The split body's, at every d: a kKc-column stage of q, p, and one stage
// that holds a K chunk or kVk keys of the CTA's kSliceCols columns of V.
constexpr int kSplitSmem =
    4 * (kSimpleQ * kKld + kSimpleQ * kPld +
         simple_stage(kSliceCols, kSliceCols));
static_assert(kSliceCols == 16 * 16 &&
                  kSliceCols == kSimpleDims[sizeof(kSimpleDims) /
                                                sizeof(int) - 1],
              "the split body runs the widest simple instantiation");

__device__ __forceinline__ float load_f32(const void* p, long long i,
                                          int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kCarry = false: flash_fwd_simple_kernel, true: flash_chunk_simple_kernel.
// kSplit: the CTA writes only output columns [c_lo, c_lo + dw), its slice
// blockIdx.z of kSliceCols (NJ is 16), and stages q like K. A thread's o
// columns are c_lo + tx + 16 j, j < NJ; those at dw or past it are
// computed from stage slack and never stored.
template <int NJ, bool kCarry, bool kSplit>
__device__ __forceinline__ void flash_simple(const SimpleArgs& in) {
  const FlashArgs& a = in.f;
  const int sq = a.sq, sk = a.sk, d = in.d, causal = a.causal, bf16 = in.bf16;
  const int n_tiles = a.n_tiles;
  const int bh = static_cast<int>(gridDim.x) / n_tiles;
  const int tile = causal ? n_tiles - 1 - static_cast<int>(blockIdx.x) / bh
                          : static_cast<int>(blockIdx.x) % n_tiles;
  const int head = causal ? static_cast<int>(blockIdx.x) % bh
                          : static_cast<int>(blockIdx.x) / n_tiles;
  const int q0 = tile * kSimpleQ;
  const int tid = static_cast<int>(threadIdx.x);
  const int c_lo = kSplit ? static_cast<int>(blockIdx.z) * kSliceCols : 0;
  const int dw = kSplit ? min(kSliceCols, d - c_lo) : d;

  int n_kb = (sk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last = a.q_offset + min(q0 + kSimpleQ, sq) - 1 - a.k_offset;
    if (last < 0) {
      // every thread of the CTA, before any barrier; the split chunk
      // kernel's first slice passes its rows' m and l through to the
      // scratch the launch copies back
      if constexpr (kCarry && kSplit) {
        if (blockIdx.z == 0 && tid < kSimpleQ && q0 + tid < sq) {
          const long long r = static_cast<long long>(head) * sq + q0 + tid;
          in.m_out[r] = a.m[r];
          in.l_out[r] = a.l[r];
        }
      }
      return;
    }
    n_kb = min(n_kb, last / kBlockK + 1);
  }

  extern __shared__ float smem_f[];
  const int qld = kSplit ? kKld : simple_qld(d);
  float* qs = smem_f;                  // [kSimpleQ][qld]: q or its stage
  float* ps = qs + kSimpleQ * qld;     // [kSimpleQ][kPld]
  float* st = ps + kSimpleQ * kPld;    // K: [kBlockK][kKld]; V: [kVk][dw]

  const int ty = tid / 16, tx = tid % 16;
  const long long qbase = (static_cast<long long>(head) * sq + q0) * d;
  const long long kbase = static_cast<long long>(head) * sk * d;
  if constexpr (!kSplit) {
    for (int i = tid; i < kSimpleQ * d; i += kSimpleThreads) {
      const int r = i / d, c = i - r * d;
      qs[r * qld + c] = q0 + r < sq ? load_f32(in.q, qbase + i, bf16) : 0.0f;
    }
  }

  float m[4], l[4], o[4][NJ];
  int qpos[4];  // the rows' global positions less the chunk's first key's
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    qpos[i] = row + a.q_offset - a.k_offset;
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[i][j] = 0.0f;
    if (kCarry && row < sq) {
      const long long r = static_cast<long long>(head) * sq + row;
      m[i] = a.m[r];
      l[i] = a.l[r];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (tx + 16 * j < dw) o[i][j] = a.acc[r * d + c_lo + tx + 16 * j];
    }
  }

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBlockK;
    // s = q kᵀ over the block's 128 keys, K (and in the split body q)
    // staged kKc columns at a time
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
    for (int c0 = 0; c0 < d; c0 += kKc) {
      const int w = min(kKc, d - c0);
      __syncthreads();  // the stages are free; q (first pass) is written
      for (int i = tid; i < kBlockK * kKc; i += kSimpleThreads) {
        const int r = i / kKc, c = i % kKc;
        st[r * kKld + c] =
            k0 + r < sk && c < w
                ? load_f32(in.k, kbase + static_cast<long long>(k0 + r) * d +
                                    c0 + c, bf16)
                : 0.0f;
      }
      if constexpr (kSplit) {
        for (int i = tid; i < kSimpleQ * kKc; i += kSimpleThreads) {
          const int r = i / kKc, c = i % kKc;
          qs[r * kKld + c] =
              q0 + r < sq && c < w
                  ? load_f32(in.q, qbase + static_cast<long long>(r) * d +
                                      c0 + c, bf16)
                  : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < w; ++c) {
        float qv[4], kv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = qs[(4 * ty + i) * qld + (kSplit ? 0 : c0) + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) kv[j] = st[(tx + 16 * j) * kKld + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
    // the online softmax of the block, p to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mb = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = col < sk && (!causal || qpos[i] >= col);
        s[i][j] = keep ? s[i][j] * a.scale : kNegInf;
        mb = fmaxf(mb, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mb));
      const float m_safe = m_new <= kNegInf / 2 ? 0.0f : m_new;
      const float corr = m[i] <= kNegInf / 2 ? 0.0f : expf(m[i] - m_safe);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = s[i][j] <= kNegInf / 2 ? 0.0f : expf(s[i][j] - m_safe);
        rs += p;
        ps[(4 * ty + i) * kPld + tx + 16 * j] =
            bf16 ? round_to<__nv_bfloat16>(p) : p;
      }
      l[i] = __fadd_rn(__fmul_rn(corr, l[i]), row_sum16(rs));
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[i][j] *= corr;
    }
    // o += p v, V (the CTA's dw columns of it) staged kVk keys at a time
    for (int v0 = 0; v0 < kBlockK && k0 + v0 < sk; v0 += kVk) {
      __syncthreads();  // p is written; the stage is free
      const long long vbase = kbase + static_cast<long long>(k0 + v0) * d;
      const int rows = min(kVk, sk - k0 - v0);
      if constexpr (kSplit) {
        for (int i = tid; i < kVk * dw; i += kSimpleThreads) {
          const int r = i / dw, c = i - r * dw;
          st[i] = r < rows ? load_f32(in.v, vbase + static_cast<long long>(
                                                        r) * d + c_lo + c,
                                      bf16)
                           : 0.0f;
        }
      } else {
        for (int i = tid; i < kVk * d; i += kSimpleThreads)
          st[i] = i < rows * d ? load_f32(in.v, vbase + i, bf16) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kVk; ++kk) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * kPld + v0 + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float vv = st[kk * dw + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pv[i], vv, o[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
    const long long r = static_cast<long long>(head) * sq + row;
    if constexpr (kCarry) {
      if (tx == 0) {
        if constexpr (kSplit) {
          if (blockIdx.z == 0) {
            in.m_out[r] = m[i];
            in.l_out[r] = l[i];
          }
        } else {
          a.m[r] = m[i];
          a.l[r] = l[i];
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (tx + 16 * j < dw) a.acc[r * d + c_lo + tx + 16 * j] = o[i][j];
    } else {
      const float den = fmaxf(l[i], 1e-37f);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        if (col >= dw) continue;
        const float y = __fdiv_rn(o[i][j], den);
        if (bf16)
          a.o[r * d + c_lo + col] = from_f32<__nv_bfloat16>(y);
        else
          reinterpret_cast<float*>(a.o)[r * d + c_lo + col] = y;
      }
    }
  }
}

template <int NJ, bool kSplit>
__global__ void __launch_bounds__(kSimpleThreads)
    flash_fwd_simple_kernel(const SimpleArgs a) {
  flash_simple<NJ, false, kSplit>(a);
}

template <int NJ, bool kSplit>
__global__ void __launch_bounds__(kSimpleThreads)
    flash_chunk_simple_kernel(const SimpleArgs a) {
  flash_simple<NJ, true, kSplit>(a);
}

// -- host side --------------------------------------------------------------

// Which body and instantiation run head_dim d in the given dtype: the
// tensor-core body for bf16 with d one of kTcDims, else the simple body at
// the least D of kSimpleDims not below d, else (d above kSliceCols) the
// split body in ceil(d / kSliceCols) slices. false when no kernel takes
// them.
struct Instance {
  bool tc;
  int D;
  int slices;  // > 1: the split body
};

bool instance_of(int d, int dtype, Instance* in) {
  if (d < 1 || (dtype != DT_BF16 && dtype != DT_F32)) return false;
  if (dtype == DT_BF16)
    for (int D : kTcDims)
      if (D == d) {
        *in = {true, D, 1};
        return true;
      }
  for (int D : kSimpleDims)
    if (D >= d) {
      *in = {false, D, 1};
      return true;
    }
  const int slices = (d + kSliceCols - 1) / kSliceCols;
  if (slices > 65535) return false;  // the grid's third dimension
  *in = {false, kSliceCols, slices};
  return true;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: fetched once through the
// runtime's driver entry point, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 3-D map (d, rows, bh) of one contiguous bf16 tensor, read in boxes of
// one panel: Tile<D>::kCols columns by 128 rows of one head, swizzled as the
// kernel's descriptors expect. Rows past `rows` read as zeros.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int rows, int bh) {
  using T = Tile<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(T::kCols),
                             static_cast<cuuint32_t>(kBlockK), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : (T::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kCarry>
constexpr auto tc_kernel =
    kCarry ? &flash_chunk_kernel<D> : &flash_fwd_kernel<D>;
template <int NJ, bool kCarry, bool kSplit = false>
constexpr auto simple_kernel =
    kCarry ? &flash_chunk_simple_kernel<NJ, kSplit>
           : &flash_fwd_simple_kernel<NJ, kSplit>;

// Dynamic shared memory above 48 KB needs the attribute, once per device
// and kernel.
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int D, bool kCarry>
int launch_tc(const SimpleArgs& in, int bh, unsigned int grid,
              cudaStream_t s) {
  constexpr auto kernel = tc_kernel<D, kCarry>;
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(&tq, in.q, in.f.sq, bh) ||
      !make_map<D>(&tk, in.k, in.f.sk, bh) ||
      !make_map<D>(&tv, in.v, in.f.sk, bh))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem<kernel>(Tile<D>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, Tile<D>::kSmem, s>>>(tq, tk, tv, in.f);
  return static_cast<int>(cudaGetLastError());
}

template <int NJ, bool kCarry>
int launch_simple(const SimpleArgs& in, unsigned int grid, cudaStream_t s) {
  const cudaError_t err = allow_smem<simple_kernel<NJ, kCarry>>(
      simple_smem(16 * NJ, 16 * NJ));
  if (err != cudaSuccess) return static_cast<int>(err);
  simple_kernel<NJ, kCarry><<<grid, kSimpleThreads,
                              simple_smem(in.d, 16 * NJ), s>>>(in);
  return static_cast<int>(cudaGetLastError());
}

// The split body: `slices` CTAs along the grid's third dimension for each
// q tile; the chunk kernel's new m and l land in scratch and are copied
// over the carries after it, in stream order.
template <bool kCarry>
int launch_split(const SimpleArgs& in, unsigned int grid, int slices,
                 int bh, cudaStream_t s) {
  constexpr auto kernel = simple_kernel<16, kCarry, true>;
  cudaError_t err = allow_smem<kernel>(kSplitSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kCarry && (in.m_out == nullptr || in.l_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(grid, 1, static_cast<unsigned int>(slices)), kSimpleThreads,
           kSplitSmem, s>>>(in);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kCarry) return static_cast<int>(err);
  const size_t bytes = static_cast<size_t>(bh) * in.f.sq * sizeof(float);
  err = cudaMemcpyAsync(in.f.m, in.m_out, bytes, cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(in.f.l, in.l_out, bytes, cudaMemcpyDeviceToDevice,
                          s);
  return static_cast<int>(err);
}

// in.f.n_tiles and in.bf16 are set here.
template <bool kCarry>
int launch(SimpleArgs in, int bh, int dtype, cudaStream_t s) {
  Instance inst;
  if (!instance_of(in.d, dtype, &inst))
    return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs& a = in.f;
  if (bh <= 0 || a.sq <= 0 || a.sk <= 0) return 0;
  in.bf16 = dtype == DT_BF16;
  const int rows = inst.tc ? kBlockQ : kSimpleQ;
  a.n_tiles = (a.sq + rows - 1) / rows;
  if (static_cast<long long>(bh) * a.n_tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid = static_cast<unsigned int>(a.n_tiles) * bh;
  if (inst.slices > 1)
    return launch_split<kCarry>(in, grid, inst.slices, bh, s);
  if (inst.tc) {
    switch (inst.D) {
      case 16: return launch_tc<16, kCarry>(in, bh, grid, s);
      case 32: return launch_tc<32, kCarry>(in, bh, grid, s);
      case 64: return launch_tc<64, kCarry>(in, bh, grid, s);
      case 128: return launch_tc<128, kCarry>(in, bh, grid, s);
    }
  } else {
    switch (inst.D) {
      case 32: return launch_simple<2, kCarry>(in, grid, s);
      case 64: return launch_simple<4, kCarry>(in, grid, s);
      case 128: return launch_simple<8, kCarry>(in, grid, s);
      case 256: return launch_simple<16, kCarry>(in, grid, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename Kernel>
int attributes_of(Kernel kernel, cudaError_t allowed, int threads, int smem,
                  int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = allowed;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = smem;
  out[2] = ctas;
  return 0;
}

template <int D, bool kCarry>
int attributes_tc(int* out) {
  constexpr auto kernel = tc_kernel<D, kCarry>;
  return attributes_of(kernel, allow_smem<kernel>(Tile<D>::kSmem), kThreads,
                       Tile<D>::kSmem, out);
}

template <int NJ, bool kCarry>
int attributes_simple(int d, int* out) {
  return attributes_of(
      simple_kernel<NJ, kCarry>,
      allow_smem<simple_kernel<NJ, kCarry>>(simple_smem(16 * NJ, 16 * NJ)),
      kSimpleThreads, simple_smem(d, 16 * NJ), out);
}

template <bool kCarry>
int attributes(int d, int dtype, int* out) {
  Instance in;
  if (!instance_of(d, dtype, &in))
    return static_cast<int>(cudaErrorInvalidValue);
  out[3] = in.tc ? 1 : (in.slices > 1 ? 2 : 0);
  out[4] = in.D;
  if (in.slices > 1) {
    constexpr auto kernel = simple_kernel<16, kCarry, true>;
    return attributes_of(kernel, allow_smem<kernel>(kSplitSmem),
                         kSimpleThreads, kSplitSmem, out);
  }
  if (in.tc) {
    switch (in.D) {
      case 16: return attributes_tc<16, kCarry>(out);
      case 32: return attributes_tc<32, kCarry>(out);
      case 64: return attributes_tc<64, kCarry>(out);
      case 128: return attributes_tc<128, kCarry>(out);
    }
  } else {
    switch (in.D) {
      case 32: return attributes_simple<2, kCarry>(d, out);
      case 64: return attributes_simple<4, kCarry>(d, out);
      case 128: return attributes_simple<8, kCarry>(d, out);
      case 256: return attributes_simple<16, kCarry>(d, out);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o: (bh, sq, d) and k, v: (bh, sk, d), contiguous, of dtype DT_BF16 or
// DT_F32, on 16-byte boundaries (ops/attention.py flash_attention_cuda
// checks and arranges it).
NNSTPU_EXPORT int nnstpu_flash_attention(const void* q, const void* k,
                                         const void* v, void* o, int bh,
                                         int sq, int sk, int d, int dtype,
                                         float scale, int causal,
                                         void* stream) {
  if (sk <= 0 && bh > 0 && sq > 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const SimpleArgs in{{static_cast<__nv_bfloat16*>(o), nullptr, nullptr,
                       nullptr, sq, sk, 0, 0, 0, causal, scale},
                      q, k, v, d, 0, nullptr, nullptr};
  return launch<false>(in, bh, dtype, static_cast<cudaStream_t>(stream));
}

// One ring hop: q (bh, sq, d), k, v (bh, sk, d) contiguous, of dtype
// DT_BF16 or DT_F32, on 16-byte boundaries; m, l (bh, sq) and acc (bh, sq,
// d) contiguous float32 carries, updated in place (ops/attention.py
// flash_chunk_cuda checks and arranges it). ml: for d above kSliceCols,
// float32 scratch of 2 * bh * sq (the split kernel's new m, then l), else
// unused. q_offset and k_offset are the global positions of q's and k's
// first rows; sk may be 0 (the carries pass through, nothing is launched).
NNSTPU_EXPORT int nnstpu_flash_chunk(const void* q, const void* k,
                                     const void* v, void* m, void* l,
                                     void* acc, void* ml, int bh, int sq,
                                     int sk, int d, int dtype, int q_offset,
                                     int k_offset, float scale, int causal,
                                     void* stream) {
  if (sk < 0) return static_cast<int>(cudaErrorInvalidValue);
  float* m_out = static_cast<float*>(ml);
  float* l_out =
      m_out == nullptr ? nullptr : m_out + static_cast<size_t>(bh) * sq;
  const SimpleArgs in{{nullptr, static_cast<float*>(m), static_cast<float*>(l),
                       static_cast<float*>(acc), sq, sk, 0, q_offset,
                       k_offset, causal, scale},
                      q, k, v, d, 0, m_out, l_out};
  return launch<true>(in, bh, dtype, static_cast<cudaStream_t>(stream));
}

// What the instantiation that head_dim d in dtype reaches asks of the card,
// on the current device: out[0] registers per thread at launch (the
// tensor-core body's warpgroups then move them with setmaxnreg), out[1]
// dynamic shared memory bytes, out[2] resident CTAs per SM, out[3] 1 for
// the tensor-core body, 0 for the simple one and 2 for the split one,
// out[4] its D (the split body's: the columns a CTA writes).
NNSTPU_EXPORT int nnstpu_flash_attributes(int d, int carry, int dtype,
                                          int* out) {
  return carry ? attributes<true>(d, dtype, out)
               : attributes<false>(d, dtype, out);
}
