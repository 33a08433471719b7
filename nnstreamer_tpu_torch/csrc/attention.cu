// Flash attention on Hopper: two kernels, each built from one of three CTA
// bodies:
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
//   - the tensor-core body, flash_tile<D, kCarry> (flash_fwd_kernel,
//     flash_chunk_kernel): bfloat16 with d one of kTcDims (16, the
//     long-context example's head dim; 32, 64 and 128; 256), the q tile
//     resident, K/V tiles of tc_key_block(D) keys (kTcKeyBlocks: 128 up to
//     D 128, 64 at D 256);
//   - the tensor-core split body, flash_split_tile<kCarry>
//     (flash_*_split_kernel): bfloat16 with d above kSliceCols and a
//     multiple of kPanelCols (320, 384, 448, 512, ...): the grid's third
//     dimension cuts the output's columns into slices of kSliceCols, q and
//     K stream through shared memory in kPanelCols-column panels, K/V
//     tiles of kSplitKeyBlock keys;
//   - the simple body, flash_simple<NJ, kCarry[, split]>
//     (flash_*_simple_kernel): float32 at every d, and bfloat16 at every
//     other d (8, 20, 48, 96, 192, 257, ...), at the least D = 16 * NJ of
//     kSimpleDims not below d, and above kSliceCols split over the head
//     dim as the tensor-core split is. float32 stays float32: both products
//     are float32 FMAs (no TF32 and no bf16 cast, which would miss the
//     reference's tolerance).
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
// 8x8192x128 bf16 is 137 GFLOP and 67 MB, 0.139 ms by operations, and so
// is causal 4x8192x256; causal 8x4096x128 float32 is 34 GFLOP, 0.51 ms by
// operations. At ViT's 197 tokens and d 64 it is bytes: 768x197x64 moves
// 77 MB, 0.023 ms; so is causal 8x1024 at d 384 and 512 bf16 (25 and 34 MB,
// 0.0075 and 0.0100 ms, against 6.4 and 8.6 GFLOP). A hop of the chunk
// kernel also moves its carries in and out: at the ring's 8x2048x128
// shards a diagonal hop is 8.6 GFLOP against 29.6 MB (the f32 acc round
// trip, 16.8 MB, the largest stream), about 0.009 ms either way; a past
// hop 17.2 GFLOP, 0.017 ms by operations.
//
// The tensor-core body's design for that bound: both products on wgmma,
// K/V streamed by TMA, and warp specialisation, so that the tensor cores
// are fed without threads spending instructions on copies. One CTA of
// three warpgroups owns one (batch*head, 128-row q tile):
//   - a producer warpgroup gives up its registers (setmaxnreg.dec); one
//     thread loads the q tile once and then the K tiles, another the V
//     tiles, into a ring of kStages stages in dynamic shared memory with
//     TMA (cp.async.bulk.tensor, 3-D maps over (d, seq, bh), so rows past
//     sq or sk are zero-filled and never read from the next head), each
//     K and each V stage guarded by its own full (transaction-count) and
//     empty mbarriers: a K stage is free once its s is done, a V stage once
//     its p v is;
//   - two consumer warpgroups take its registers (setmaxnreg.inc), 64 q
//     rows each. s = q kᵀ is wgmma m64nBKk16 with both operands in shared
//     memory, K-major. p stays in registers: the f32 s accumulators of two
//     neighbouring 8-column groups, rounded to bf16, are the A fragment of
//     one k-step of o += p v (the wgmma accumulator layout per warp is the
//     A-register layout), and V is read as TMA left it, (keys, d), through
//     the transpose bit (MN-major B), one m64nDk16 a k-step. The tensor
//     cores run a tile ahead: a warpgroup issues s of tile j and p v of
//     tile j - 1 together and runs the softmax of tile j while p v is still
//     in flight, so each warpgroup overlaps its own exp work with its
//     products. The online softmax runs in registers, rows reduced across
//     the 4 threads of a quad; the causal and ragged masks run only on
//     tiles that cross a row's diagonal or the end of the keys. The running
//     (m, l, acc) are float32 registers; the chunk kernel loads them from
//     the carries in the accumulator layout (each thread its rows g and
//     g+8, columns 8i+2t and 8i+2t+1) and stores them back the same way.
// Shared rows are swizzled as wide as a row allows (128 B at D 64, 64 B at
// D 32, 32 B at D 16, 64-column panels of 128 B above), the same mode in
// the tensor maps and the wgmma descriptors. Causal CTAs stop after the K
// tile that holds their last real row's global diagonal and are launched
// longest first.
//
// The tile at D 256. A 128 x 256 bf16 tile is 64 KiB, so the D 128 tile (q
// and three stages of 128-key K and V, 7 x 32 KiB) would need 448 KiB
// against a CTA's 227 KiB. At D 256 the K/V tile is 64 keys: q 64 KiB plus
// two stages of K and V at 32 KiB each is 192 KiB (kStages is the most
// stages, up to 3, that fit). A consumer thread then holds acc, 64 x 256
// float32 over 128 threads = 128 registers, s for 64 keys (32) and bf16(p)
// (16), 176 of the 240 it has after setmaxnreg. With separate K and V
// empty barriers two stages give the producer the same lead as three
// did: K of tile j + 2 loads once s of tile j is done, V once its p v is.
//
// The split body above kSliceCols. A 128-row q tile at d 512 alone is 128
// KiB, and the accumulator of a 64-row warpgroup at d 512 would be 256
// registers a thread, so a CTA keeps only its slice of kSliceCols output
// columns (the last slice of d 320 or 384 is 64 or 128 wide, and its other
// columns are computed on stale shared memory and never stored). For each
// 64-key tile, s = q kᵀ accumulates over d in kPanelCols-column panels:
// one producer thread streams (q panel, K panel) pairs, 16 + 8 KiB, through
// a ring of Split::kStages (6) stages, and the consumers free each panel
// once its wgmma is done; another producer thread loads the slice's
// columns of the V tile (at most 32 KiB) into a ring of two. p v runs on
// wgmma with p in registers as in the tensor-core body, a tile behind s: a
// warpgroup issues p v of tile j - 1 and then the panels of s of tile j
// behind it, and waits for all of them before its softmax (the panel
// loop's trip count is known only at run time, and a product left in
// flight across it made the compiler serialise the wgmmas); the other
// warpgroup's products fill the tensor cores during a softmax. The
// registers are the D 256 tile's. Every slice computes the same scores in
// the same order, so m, l and p agree bit for bit across slices. Cost:
// slices * (d + kSliceCols) / (2 d) times the least tensor-core work (1.5x
// at d 512, 1.67x at d 384, 1.8x at d 320), and per 64-key tile a CTA
// reads 192 B * d + 32 KiB from L2 (224 KiB at d 512 for 12.6 MFLOP),
// which at the card's peak rate would ask some 18 TB/s of L2: L2 reads of
// the q panels, not the tensor cores, should bound the split at long
// sequence. At the 8 x 1024 heads the wide phase of chip_smoke.py times,
// one wave of 128 CTAs, the bound is bytes (0.0075 ms at d 384, 0.0100 at
// d 512) and the longest CTA's 16 key tiles set the time. The split chunk kernel
// reads the carried m and l in every slice, so no slice may overwrite them
// in place: the first slice writes the new m and l to scratch outputs
// (passing a future CTA's rows through), and the launch copies them over
// the carries after the kernel, in stream order (cudaMemcpyAsync, no extra
// kernel).
//
// Rounding points, as _block_attn: s = (q kᵀ in f32) * scale; masked
// entries -1e30; m_safe = 0 for rows with no unmasked key yet, and corr = 0
// for a row whose carried m is still -1e30 (the dead-row guard, which the
// chunk kernel meets on rows that have seen no key in earlier hops);
// p = exp(s - m_safe) in f32 (as exp2 of a fused (s - m_safe) * log2 e);
// l = corr * l + sum(p) in f32; p rounded to bf16 before p v, which
// accumulates in f32 into corr * acc; the flash output acc / max(l, 1e-37)
// rounded to bf16 (the chunk kernel stores acc and l unnormalised). A bf16
// p is rounded at the running max of its key block, so each instance's
// plain version runs at that instance's key block (ops/attention.py
// key_block); only the order of the float32 sums and exp's last bits
// differ from it.
//
// The simple body takes what the tensor cores cannot: float32, whose
// products must stay float32, and bf16 widths that are no wgmma shape. It is
// written to be right at every d. One CTA of 256 threads owns one
// (batch*head, 64-row q tile), and each thread 4 of its rows (ty = thread
// / 16) by every 16th column (tx = thread % 16). The q tile sits in shared
// memory as float32, rows at an odd stride. For each 128-key block
// (kBlockK, the plain versions' BLOCK_K, so that a bf16 p is rounded at the
// same running max): s = q kᵀ as 4 x 8 float32 FMA accumulators a thread,
// K staged 32 head-dim columns at a time (rows padded to 33 floats: no
// bank conflicts); the online softmax in those registers, rows reduced over
// the 16 threads that share them; p (rounded to bf16 for a bf16 input)
// through shared memory; o += p v as 4 x NJ FMA accumulators, V staged 32
// keys at a time. Loads convert bf16 to float32 exactly and zero-fill past
// sq, sk and d. The rounding points are the tensor-core body's, with expf
// for exp and the output divided in IEEE float32 before its one rounding
// to q's dtype. Above kSliceCols the q tile no longer fits beside p and a V
// stage (at d 512 float32 it alone is 131 KB), so its split keeps none of
// it: it stages q's 64 rows through shared memory in the same kKc-column
// chunks as K, and a V stage holds only the CTA's slice of columns; it
// costs ceil(d / 256) times the q kᵀ work and hands the chunk kernel's m
// and l over as the tensor-core split does.
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 128;   // q rows per CTA, 64 per consumer warpgroup
constexpr int kBlockK = 128;   // keys per K/V tile of the simple body
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kMaxSmem = 232448;  // a CTA's dynamic shared memory on sm_90
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBlockQ == 64 * kConsumers, "64 q rows a consumer warpgroup");

// The instantiations (tests/test_torch_attention.py reads these lines):
// the tensor-core body's D and the keys of its K/V tiles at each D, the
// simple body's D = 16 * NJ, the output columns a CTA of either split body
// writes (the last simple D), and the tensor-core split's head-dim panel
// and key block.
constexpr int kTcDims[] = {16, 32, 64, 128, 256};
constexpr int kTcKeyBlocks[] = {128, 128, 128, 128, 64};
constexpr int kSimpleDims[] = {32, 64, 128, 256};
constexpr int kSliceCols = 256;
constexpr int kPanelCols = 64;
constexpr int kSplitKeyBlock = 64;

constexpr int tc_key_block(int D) {
  for (int i = 0; i < static_cast<int>(sizeof(kTcDims) / sizeof(int)); ++i)
    if (kTcDims[i] == D) return kTcKeyBlocks[i];
  return 0;
}

// The tensor-core body's tiles at D in shared memory: the 128-row q tile
// and kStages K and V tiles of kBK rows, each kPanels panels of kCols bf16
// a row, each row kRowBytes wide and swizzled across it.
template <int D>
struct Tile {
  static constexpr int kBK = tc_key_block(D);
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = kCols * 2;  // 32, 64 or 128: the swizzle
  static constexpr int kPanels = D / kCols;
  static constexpr int kQPanelBytes = kBlockQ * kRowBytes;
  static constexpr int kKvPanelBytes = kBK * kRowBytes;
  static constexpr int kQBytes = kPanels * kQPanelBytes;
  static constexpr int kKvBytes = kPanels * kKvPanelBytes;
  static constexpr int kStepsPerPanel = kCols / 16;  // k-steps of q kᵀ
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr uint64_t kLayout =
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  // as many K/V stages as fit beside q, the barriers and room to align to
  // 1024 B, up to 3
  static constexpr int kFit = (kMaxSmem - 1024 - 128 - kQBytes) / (2 * kKvBytes);
  static constexpr int kStages = kFit < 3 ? kFit : 3;
  static constexpr int kSmem = kQBytes + 2 * kStages * kKvBytes + 1024 + 128;
  static_assert(kBK == 64 || kBK == 128, "a K/V tile is 64 or 128 keys");
  static_assert(kStages >= 2 && kSmem <= kMaxSmem, "two stages must fit");
  static_assert(D / 2 <= 128, "a consumer's accumulator is at most 128 regs");
};

// The tensor-core split body's shared memory: kSplitStages (q panel, K
// panel) pairs and two V tiles of the slice's kSliceCols columns.
struct Split {
  static constexpr int kRowBytes = kPanelCols * 2;  // 128: the swizzle
  static constexpr int kQPanelBytes = kBlockQ * kRowBytes;
  static constexpr int kKPanelBytes = kSplitKeyBlock * kRowBytes;
  static constexpr int kStageBytes = kQPanelBytes + kKPanelBytes;
  static constexpr int kVPanelBytes = kSplitKeyBlock * kRowBytes;
  static constexpr int kVBytes = (kSliceCols / kPanelCols) * kVPanelBytes;
  static constexpr int kStages = 6;
  static constexpr int kVStages = 2;
  static constexpr int kSmem =
      kStages * kStageBytes + kVStages * kVBytes + 1024 + 128;
  static_assert(kSmem <= kMaxSmem, "the split body's stages must fit");
  static_assert(8 * (2 * kStages + 2 * kVStages) <= 128,
                "the barriers fit their 128 bytes");
};

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

// The simple and split bodies': the tensor-core body's, the inputs,
// head_dim and dtype, and the split chunk kernels' new m and l (scratch,
// copied over f.m and f.l after the kernel).
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
#define WG_ACC128(d) WG_ACC16(d, 0), WG_ACC16(d, 16), WG_ACC16(d, 32), \
                     WG_ACC16(d, 48), WG_ACC16(d, 64), WG_ACC16(d, 80), \
                     WG_ACC16(d, 96), WG_ACC16(d, 112)

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

// s[64 x 64] (+)= A[64 x 16] * B[16 x 64], as above for 64-key tiles.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// o[64 x D] += P[64 x 16] * V[16 x D]: P from registers (the A fragment a),
// V MN-major in shared memory (descriptor db, transpose bit set).
__device__ __forceinline__ void wgmma_pv(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_ACC128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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

// s[64 x BK] (+)= q[64 x 16 * steps] kᵀ for one warpgroup, `steps` k-steps
// of one shared-memory panel: q_wg its 64 q rows, kt the K panel, both
// K-major with rows of `row_bytes` (8-row groups 8 rows apart, each k-step
// 32 bytes further along a swizzled row). first: the first k-step
// overwrites s.
template <int BK>
__device__ __forceinline__ void qk_panel(float (&sc)[BK / 2], uint32_t q_wg,
                                         uint32_t kt, int steps,
                                         int row_bytes, uint64_t layout,
                                         bool first) {
#pragma unroll
  for (int st = 0; st < 4; ++st)
    if (st < steps)
      wgmma_qk(sc, smem_desc(q_wg + 32 * st, 16, 8 * row_bytes, layout),
               smem_desc(kt + 32 * st, 16, 8 * row_bytes, layout),
               !(first && st == 0));
}

// s[64 x BK] = q[64 x D] kᵀ for one warpgroup: the tensor-core body's
// q tile (q_wg its 64 rows) against one K tile, panel by panel. Committed
// as one group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[Tile<D>::kBK / 2],
                                         uint32_t q_wg, uint32_t kt) {
  using T = Tile<D>;
#pragma unroll
  for (int p = 0; p < T::kPanels; ++p)
    qk_panel<T::kBK>(sc, q_wg + p * T::kQPanelBytes,
                     kt + p * T::kKvPanelBytes, T::kStepsPerPanel,
                     T::kRowBytes, T::kLayout, p == 0);
  wgmma_commit();
}

// o[64 x N] += bf16(p)[64 x BK] v: pa the A fragments of p's BK / 16
// k-steps, vt the V tile, MN-major (8-key groups 8 rows apart, each k-step
// 16 rows further, 64-column panels panel_bytes apart). Committed as one
// group.
template <int BK, int N>
__device__ __forceinline__ void issue_pv(float (&acc)[N / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t vt, int row_bytes,
                                         int panel_bytes, uint64_t layout) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    wgmma_pv(acc, pa[j],
             smem_desc(vt + 16 * j * row_bytes, panel_bytes, 8 * row_bytes,
                       layout));
  wgmma_commit();
}

// The online softmax of one BK-key tile for one thread's rows g and g+8,
// s in the accumulator layout: scale (and mask) s, update the running max m
// and sum l, set corr to the factor that rescales acc, and leave p =
// exp(s - m_safe) in s.
struct Softmax {
  float scale;
  int sk, causal, t;
  int qpos[2];   // the rows' global positions less the chunk's first key's
  int first;     // the warpgroup's least such position

  template <int BK>
  __device__ __forceinline__ void tile(float (&sc)[BK / 2], int k0,
                                       float (&m)[2],
                                       float (&l)[2], float (&corr)[2]) const {
    // mask only a tile that crosses the end of the keys or, when causal, a
    // row's diagonal
    if (k0 + BK > sk || (causal && first < k0 + BK - 1)) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        const bool keep = col < sk && (!causal || qpos[(i / 2) & 1] >= col);
        sc[i] = keep ? sc[i] * scale : kNegInf;
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] *= scale;
    }
    // row maxima and sums in 4 independent chains per row
    float part[2][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) part[i / 4][i % 4] = kNegInf;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
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
    for (int i = 0; i < BK / 2; ++i) {
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

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= corr[(i / 2) & 1];
}

// bf16(p): the s accumulators of column groups 2j and 2j+1 are the A
// fragment of k-step j of p v.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&sc)[BK / 2]) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    pa[j][0] = pack_bf16(sc[8 * j], sc[8 * j + 1]);
    pa[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
    pa[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
    pa[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
  }
}

// Which (batch*head, q tile) a CTA of the tensor-core bodies owns, and the
// key tiles of BK keys it folds in: causal CTAs stop after the tile holding
// their last real row's global diagonal, and a CTA whose last row precedes
// the chunk's first key has none (n_kb < 0: it passes the carries through).
// One flat grid of n_tiles * bh CTAs: causal tile-major from the last tile,
// so the longest tiles of every head start first and the short ones fill
// in at the end; otherwise head-major, so a head's q tiles run together and
// share its K/V in L2.
struct CtaTile {
  int head, q0, n_kb;

  __device__ __forceinline__ CtaTile(const FlashArgs& a, int bk) {
    const int bh = static_cast<int>(gridDim.x) / a.n_tiles;
    const int tile = a.causal
                         ? a.n_tiles - 1 - static_cast<int>(blockIdx.x) / bh
                         : static_cast<int>(blockIdx.x) % a.n_tiles;
    head = a.causal ? static_cast<int>(blockIdx.x) % bh
                    : static_cast<int>(blockIdx.x) / a.n_tiles;
    q0 = tile * kBlockQ;
    n_kb = (a.sk + bk - 1) / bk;
    if (a.causal) {
      const int last = a.q_offset + min(q0 + kBlockQ, a.sq) - 1 - a.k_offset;
      n_kb = last < 0 ? -1 : min(n_kb, last / bk + 1);
    }
  }
};

// A consumer thread's rows (g and g+8 of its warp's 16) and its running
// (m, l, acc) over the columns [c_lo, c_lo + width) of its slice (the whole
// row at c_lo 0, width d), loaded from the carries or fresh.
template <int N>
struct RowState {
  int row[2];
  float m[2], l[2];
  float acc[N / 2];

  __device__ __forceinline__ void init(const FlashArgs& a, int head, int q0,
                                       int c, int warp, int g, int t, int d,
                                       int c_lo, int width, bool carry) {
    row[0] = q0 + 64 * c + 16 * warp + g;
    row[1] = row[0] + 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = kNegInf;
      l[h] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
    if (!carry) return;
    // every register is set on every path (a select, not a skipped
    // store), so the compiler sees no partial definition of the
    // accumulators that wgmma later reads
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = row[h] < a.sq;
      const long long r =
          static_cast<long long>(head) * a.sq + (live ? row[h] : 0);
      m[h] = live ? a.m[r] : kNegInf;
      l[h] = live ? a.l[r] : 0.0f;
      const float* ap = a.acc + r * d + c_lo + 2 * t;
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        const float2 v =
            live && 8 * i + 2 * t < width
                ? *reinterpret_cast<const float2*>(ap + 8 * i)
                : make_float2(0.0f, 0.0f);
        acc[4 * i + 2 * h] = v.x;
        acc[4 * i + 2 * h + 1] = v.y;
      }
    }
  }

  // The chunk kernel's carries (m and l to m_out, l_out: the carries
  // themselves, or the split's scratch, written by slice 0 only), or the
  // flash output acc / max(l, 1e-37) rounded to bf16.
  __device__ __forceinline__ void store(const FlashArgs& a, int head, int t,
                                        int d, int c_lo, int width,
                                        bool carry, float* m_out,
                                        float* l_out) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= a.sq) continue;
      const long long r = static_cast<long long>(head) * a.sq + row[h];
      if (carry) {
        if (m_out != nullptr) {
          m_out[r] = m[h];
          l_out[r] = l[h];
        }
        float* ap = a.acc + r * d + c_lo + 2 * t;
#pragma unroll
        for (int i = 0; i < N / 8; ++i)
          if (8 * i + 2 * t < width)
            *reinterpret_cast<float2*>(ap + 8 * i) =
                make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      } else {
        const float den = fmaxf(l[h], 1e-37f);
        __nv_bfloat16* op = a.o + r * d + c_lo + 2 * t;
#pragma unroll
        for (int i = 0; i < N / 8; ++i)
          if (8 * i + 2 * t < width)
            *reinterpret_cast<uint32_t*>(op + 8 * i) = pack_bf16(
                acc[4 * i + 2 * h] / den, acc[4 * i + 2 * h + 1] / den);
      }
    }
  }
};

// -- the tensor-core body ---------------------------------------------------

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
  constexpr int BK = T::kBK, S = T::kStages;

  const CtaTile ct(a, BK);
  if (ct.n_kb < 0) return;  // every thread of the CTA, before any barrier
  const int head = ct.head, q0 = ct.q0, n_kb = ct.n_kb;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + T::kQBytes;               // + stage * kKvBytes
  const uint32_t v_s = k_s + S * T::kKvBytes;           // + stage * kKvBytes
  const uint32_t bars = v_s + S * T::kKvBytes;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;                     // + 8 * stage
  const uint32_t v_full = k_full + 8 * S;
  const uint32_t k_empty = v_full + 8 * S;
  const uint32_t v_empty = k_empty + 8 * S;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 128 * kConsumers);
      mbar_init(v_empty + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = static_cast<int>(threadIdx.x) / 128;
  if (wg == 0) {
    // producer: thread 0 loads q and the K tiles, thread 32 the V tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int p = 0; p < T::kPanels; ++p)
        tma_load(q_s + p * T::kQPanelBytes, tq, q_full, p * T::kCols, q0,
                 head);
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % S;
        mbar_wait(k_empty + 8 * s, ((kb / S) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * s, T::kKvBytes);
#pragma unroll
        for (int p = 0; p < T::kPanels; ++p)
          tma_load(k_s + s * T::kKvBytes + p * T::kKvPanelBytes, tk,
                   k_full + 8 * s, p * T::kCols, kb * BK, head);
      }
    } else if (threadIdx.x == 32) {
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % S;
        mbar_wait(v_empty + 8 * s, ((kb / S) & 1) ^ 1);
        mbar_expect_tx(v_full + 8 * s, T::kKvBytes);
#pragma unroll
        for (int p = 0; p < T::kPanels; ++p)
          tma_load(v_s + s * T::kKvBytes + p * T::kKvPanelBytes, tv,
                   v_full + 8 * s, p * T::kCols, kb * BK, head);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;  // consumer warpgroup: q rows 64c .. 64c + 63
    const int tid = static_cast<int>(threadIdx.x) % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int shift = a.q_offset - a.k_offset;
    RowState<D> rs;
    rs.init(a, head, q0, c, warp, g, t, D, 0, D, kCarry);

    // The tensor cores run one tile ahead of the softmax: iteration kb
    // issues s = q kᵀ of tile kb and then o += bf16(p) v of tile kb - 1,
    // waits for s alone, and runs the softmax of tile kb while the previous
    // tile's p v is still on the tensor cores. pa holds bf16(p) of the
    // tile whose p v comes next. Tile 0 has no p v before it and the last
    // p v no tile after it, so both are outside the loop, which keeps the
    // loop body free of branches around the asynchronous products.
    const Softmax sm{a.scale, a.sk, a.causal, t,
                     {rs.row[0] + shift, rs.row[1] + shift},
                     q0 + 64 * c + shift};
    const uint32_t q_wg = q_s + 64 * c * T::kRowBytes;
    float sc[BK / 2], corr[2];
    uint32_t pa[BK / 16][4];
    mbar_wait(q_full, 0);
    if (n_kb > 0) {
      mbar_wait(k_full, 0);
      fence_regs(sc);
      wgmma_fence();
      issue_qk<D>(sc, q_wg, k_s);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(k_empty);  // tile 0's K is used
      sm.tile<BK>(sc, 0, rs.m, rs.l, corr);
      rescale(rs.acc, corr);
      pack_p<BK>(pa, sc);
    }
    for (int kb = 1; kb < n_kb; ++kb) {
      const int s = kb % S, ps = (kb - 1) % S;
      mbar_wait(k_full + 8 * s, (kb / S) & 1);
      fence_regs(sc);
      fence_regs(rs.acc);
      fence_regs(pa);
      wgmma_fence();
      issue_qk<D>(sc, q_wg, k_s + s * T::kKvBytes);
      mbar_wait(v_full + 8 * ps, ((kb - 1) / S) & 1);
      issue_pv<BK, D>(rs.acc, pa, v_s + ps * T::kKvBytes, T::kRowBytes,
                      T::kKvPanelBytes, T::kLayout);
      wgmma_wait<1>();  // s is ready; p v may still run
      fence_regs(sc);
      mbar_arrive(k_empty + 8 * s);  // this tile's K is used
      sm.tile<BK>(sc, kb * BK, rs.m, rs.l, corr);
      wgmma_wait<0>();
      fence_regs(rs.acc);
      fence_regs(pa);
      mbar_arrive(v_empty + 8 * ps);  // the previous tile's V is used
      rescale(rs.acc, corr);
      pack_p<BK>(pa, sc);
    }
    if (n_kb > 0) {  // the last tile's p v
      const int ps = (n_kb - 1) % S;
      mbar_wait(v_full + 8 * ps, ((n_kb - 1) / S) & 1);
      fence_regs(rs.acc);
      fence_regs(pa);
      wgmma_fence();
      issue_pv<BK, D>(rs.acc, pa, v_s + ps * T::kKvBytes, T::kRowBytes,
                      T::kKvPanelBytes, T::kLayout);
      wgmma_wait<0>();
      fence_regs(rs.acc);
    }
    rs.store(a, head, t, D, 0, D, kCarry, kCarry ? a.m : nullptr, a.l);
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

// -- the tensor-core split body ---------------------------------------------

// One CTA: q tile blockIdx.x's rows (as the tensor-core body), output
// columns [c_lo, c_lo + width) of slice blockIdx.z. The q panel of a stage
// is the 128-row tile's kPanelCols columns (64 rows a consumer), the K
// panel the key tile's same columns; the slice's V tile is width / 64
// panels of 64 columns (the rest of the stage is never loaded, and the
// output columns it feeds are never stored).
template <bool kCarry>
__device__ __forceinline__ void flash_split_tile(const CUtensorMap& tq,
                                                 const CUtensorMap& tk,
                                                 const CUtensorMap& tv,
                                                 const SimpleArgs& in) {
  constexpr int BK = kSplitKeyBlock, S = Split::kStages,
                VS = Split::kVStages;
  constexpr uint64_t kLayout = 1;  // 128-byte rows, 128-byte swizzle
  const FlashArgs& a = in.f;
  const int d = in.d;
  const int n_panels = d / kPanelCols;
  const int c_lo = static_cast<int>(blockIdx.z) * kSliceCols;
  const int width = min(kSliceCols, d - c_lo);
  const int v_panels = width / kPanelCols;

  const CtaTile ct(a, BK);
  const int head = ct.head, q0 = ct.q0, n_kb = ct.n_kb;
  if (n_kb < 0) {
    // every thread of the CTA, before any barrier; the chunk kernel's
    // first slice passes its rows' m and l through to the scratch the
    // launch copies back
    if constexpr (kCarry) {
      const int tid = static_cast<int>(threadIdx.x);
      if (blockIdx.z == 0 && tid < kBlockQ && q0 + tid < a.sq) {
        const long long r = static_cast<long long>(head) * a.sq + q0 + tid;
        in.m_out[r] = a.m[r];
        in.l_out[r] = a.l[r];
      }
    }
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t pq = base;  // + stage * kStageBytes; K at + kQPanelBytes
  const uint32_t v_s = base + S * Split::kStageBytes;  // + stage * kVBytes
  const uint32_t bars = v_s + VS * Split::kVBytes;
  const uint32_t p_full = bars;                         // + 8 * stage
  const uint32_t p_empty = p_full + 8 * S;
  const uint32_t v_full = p_empty + 8 * S;
  const uint32_t v_empty = v_full + 8 * VS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(p_full + 8 * s, 1);
      mbar_init(p_empty + 8 * s, 128 * kConsumers);
    }
    for (int s = 0; s < VS; ++s) {
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = static_cast<int>(threadIdx.x) / 128;
  if (wg == 0) {
    // producer: thread 0 streams the (q panel, K panel) pairs of every key
    // tile, thread 32 the slice's V tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;
      for (int kb = 0; kb < n_kb; ++kb)
        for (int p = 0; p < n_panels; ++p, ++it) {
          const int s = it % S;
          const uint32_t dst = pq + s * Split::kStageBytes;
          mbar_wait(p_empty + 8 * s, ((it / S) & 1) ^ 1);
          mbar_expect_tx(p_full + 8 * s, Split::kStageBytes);
          tma_load(dst, tq, p_full + 8 * s, p * kPanelCols, q0, head);
          tma_load(dst + Split::kQPanelBytes, tk, p_full + 8 * s,
                   p * kPanelCols, kb * BK, head);
        }
    } else if (threadIdx.x == 32) {
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % VS;
        mbar_wait(v_empty + 8 * s, ((kb / VS) & 1) ^ 1);
        mbar_expect_tx(v_full + 8 * s, v_panels * Split::kVPanelBytes);
        for (int p = 0; p < v_panels; ++p)
          tma_load(v_s + s * Split::kVBytes + p * Split::kVPanelBytes, tv,
                   v_full + 8 * s, c_lo + p * kPanelCols, kb * BK, head);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = static_cast<int>(threadIdx.x) % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int shift = a.q_offset - a.k_offset;
    RowState<kSliceCols> rs;
    rs.init(a, head, q0, c, warp, g, t, d, c_lo, width, kCarry);
    const Softmax sm{a.scale, a.sk, a.causal, t,
                     {rs.row[0] + shift, rs.row[1] + shift},
                     q0 + 64 * c + shift};
    const uint32_t q_off = 64 * c * Split::kRowBytes;  // the consumer's rows
    float sc[BK / 2], corr[2];
    uint32_t pa[BK / 16][4];
    int it = 0;
    // Iteration kb: p v of tile kb - 1, then s of tile kb panel by panel
    // behind it on the tensor cores, each panel's stage freed once its
    // wgmma is done (the one after it is then in flight). All of them are
    // done before the softmax reads s, which keeps the number of products
    // in flight known to the compiler across the runtime panel loop; the
    // other consumer warpgroup's products fill the tensor cores meanwhile.
    for (int kb = 0; kb < n_kb; ++kb) {
      fence_regs(sc);
      fence_regs(rs.acc);
      fence_regs(pa);
      wgmma_fence();
      if (kb > 0) {
        const int ps = (kb - 1) % VS;
        mbar_wait(v_full + 8 * ps, ((kb - 1) / VS) & 1);
        issue_pv<BK, kSliceCols>(rs.acc, pa, v_s + ps * Split::kVBytes,
                                 Split::kRowBytes, Split::kVPanelBytes,
                                 kLayout);
      }
      int prev = 0;
      for (int p = 0; p < n_panels; ++p, ++it) {
        const int s = it % S;
        const uint32_t src = pq + s * Split::kStageBytes;
        mbar_wait(p_full + 8 * s, (it / S) & 1);
        qk_panel<BK>(sc, src + q_off, src + Split::kQPanelBytes, 4,
                     Split::kRowBytes, kLayout, p == 0);
        wgmma_commit();
        if (p > 0) {
          wgmma_wait<1>();
          mbar_arrive(p_empty + 8 * prev);
        }
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(rs.acc);
      fence_regs(pa);
      mbar_arrive(p_empty + 8 * prev);  // the last panel is used
      if (kb > 0) mbar_arrive(v_empty + 8 * ((kb - 1) % VS));
      sm.tile<BK>(sc, kb * BK, rs.m, rs.l, corr);
      rescale(rs.acc, corr);
      pack_p<BK>(pa, sc);
    }
    if (n_kb > 0) {  // the last tile's p v
      const int ps = (n_kb - 1) % VS;
      mbar_wait(v_full + 8 * ps, ((n_kb - 1) / VS) & 1);
      fence_regs(rs.acc);
      fence_regs(pa);
      wgmma_fence();
      issue_pv<BK, kSliceCols>(rs.acc, pa, v_s + ps * Split::kVBytes,
                               Split::kRowBytes, Split::kVPanelBytes,
                               kLayout);
      wgmma_wait<0>();
      fence_regs(rs.acc);
    }
    const bool first = blockIdx.z == 0;
    rs.store(a, head, t, d, c_lo, width, kCarry,
             kCarry && first ? in.m_out : nullptr, in.l_out);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_split_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const SimpleArgs a) {
  flash_split_tile<false>(tq, tk, tv, a);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_chunk_split_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const SimpleArgs a) {
  flash_split_tile<true>(tq, tk, tv, a);
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
// tensor-core body for bf16 with d one of kTcDims; its split for bf16 above
// kSliceCols at a multiple of kPanelCols; else the simple body at the
// least D of kSimpleDims not below d, else (d above kSliceCols) the simple
// split. false when no kernel takes them.
enum Body { kSimple = 0, kTensorCore = 1, kSimpleSplit = 2, kTcSplit = 3 };

struct Instance {
  Body body;
  int D;          // the split bodies': the columns a CTA writes
  int slices;     // > 1: a split body
  int key_block;  // keys per K/V tile: the plain version's block_k
};

bool instance_of(int d, int dtype, Instance* in) {
  if (d < 1 || (dtype != DT_BF16 && dtype != DT_F32)) return false;
  const int slices = (d + kSliceCols - 1) / kSliceCols;
  if (slices > 65535) return false;  // the grid's third dimension
  if (dtype == DT_BF16) {
    for (int D : kTcDims)
      if (D == d) {
        *in = {kTensorCore, D, 1, tc_key_block(D)};
        return true;
      }
    if (d > kSliceCols && d % kPanelCols == 0) {
      *in = {kTcSplit, kSliceCols, slices, kSplitKeyBlock};
      return true;
    }
  }
  for (int D : kSimpleDims)
    if (D >= d) {
      *in = {kSimple, D, 1, kBlockK};
      return true;
    }
  *in = {kSimpleSplit, kSliceCols, slices, kBlockK};
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
// one panel: box_cols columns (16, 32 or 64: the row's swizzle) by
// box_rows rows of one head, swizzled as the kernel's descriptors expect.
// Rows past `rows` and columns past d read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int d, int rows, int bh,
              int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                     : (box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                       : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q's map in boxes of 128 rows, k's and v's in boxes of the key block.
bool make_maps(const SimpleArgs& in, int bh, int box_cols, int key_block,
               CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv) {
  return make_map(tq, in.q, in.d, in.f.sq, bh, box_cols, kBlockQ) &&
         make_map(tk, in.k, in.d, in.f.sk, bh, box_cols, key_block) &&
         make_map(tv, in.v, in.d, in.f.sk, bh, box_cols, key_block);
}

template <int D, bool kCarry>
constexpr auto tc_kernel =
    kCarry ? &flash_chunk_kernel<D> : &flash_fwd_kernel<D>;
template <bool kCarry>
constexpr auto tc_split_kernel =
    kCarry ? &flash_chunk_split_kernel : &flash_fwd_split_kernel;
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
  using T = Tile<D>;
  constexpr auto kernel = tc_kernel<D, kCarry>;
  CUtensorMap tq, tk, tv;
  if (!make_maps(in, bh, T::kCols, T::kBK, &tq, &tk, &tv))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem<kernel>(T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, T::kSmem, s>>>(tq, tk, tv, in.f);
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

// After a split chunk kernel: its new m and l, in scratch, over the
// carries, in stream order.
int copy_ml(const SimpleArgs& in, int bh, cudaStream_t s) {
  const size_t bytes = static_cast<size_t>(bh) * in.f.sq * sizeof(float);
  cudaError_t err =
      cudaMemcpyAsync(in.f.m, in.m_out, bytes, cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(in.f.l, in.l_out, bytes, cudaMemcpyDeviceToDevice,
                          s);
  return static_cast<int>(err);
}

// The split bodies: `slices` CTAs along the grid's third dimension for
// each q tile; the chunk kernel's new m and l land in scratch and are
// copied over the carries after it.
template <bool kCarry>
int launch_split(const SimpleArgs& in, Body body, unsigned int grid,
                 int slices, int bh, cudaStream_t s) {
  if (kCarry && (in.m_out == nullptr || in.l_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks(grid, 1, static_cast<unsigned int>(slices));
  cudaError_t err;
  if (body == kTcSplit) {
    constexpr auto kernel = tc_split_kernel<kCarry>;
    CUtensorMap tq, tk, tv;
    if (!make_maps(in, bh, kPanelCols, kSplitKeyBlock, &tq, &tk, &tv))
      return static_cast<int>(cudaErrorInvalidValue);
    err = allow_smem<kernel>(Split::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, kThreads, Split::kSmem, s>>>(tq, tk, tv, in);
  } else {
    constexpr auto kernel = simple_kernel<16, kCarry, true>;
    err = allow_smem<kernel>(kSplitSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, kSimpleThreads, kSplitSmem, s>>>(in);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !kCarry) return static_cast<int>(err);
  return copy_ml(in, bh, s);
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
  const bool tc = inst.body == kTensorCore || inst.body == kTcSplit;
  const int rows = tc ? kBlockQ : kSimpleQ;
  a.n_tiles = (a.sq + rows - 1) / rows;
  if (static_cast<long long>(bh) * a.n_tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid = static_cast<unsigned int>(a.n_tiles) * bh;
  if (inst.slices > 1)
    return launch_split<kCarry>(in, inst.body, grid, inst.slices, bh, s);
  if (inst.body == kTensorCore) {
    switch (inst.D) {
      case 16: return launch_tc<16, kCarry>(in, bh, grid, s);
      case 32: return launch_tc<32, kCarry>(in, bh, grid, s);
      case 64: return launch_tc<64, kCarry>(in, bh, grid, s);
      case 128: return launch_tc<128, kCarry>(in, bh, grid, s);
      case 256: return launch_tc<256, kCarry>(in, bh, grid, s);
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
  out[3] = in.body;
  out[4] = in.D;
  out[5] = in.key_block;
  if (in.body == kTcSplit) {
    constexpr auto kernel = tc_split_kernel<kCarry>;
    return attributes_of(kernel, allow_smem<kernel>(Split::kSmem), kThreads,
                         Split::kSmem, out);
  }
  if (in.body == kSimpleSplit) {
    constexpr auto kernel = simple_kernel<16, kCarry, true>;
    return attributes_of(kernel, allow_smem<kernel>(kSplitSmem),
                         kSimpleThreads, kSplitSmem, out);
  }
  if (in.body == kTensorCore) {
    switch (in.D) {
      case 16: return attributes_tc<16, kCarry>(out);
      case 32: return attributes_tc<32, kCarry>(out);
      case 64: return attributes_tc<64, kCarry>(out);
      case 128: return attributes_tc<128, kCarry>(out);
      case 256: return attributes_tc<256, kCarry>(out);
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
// float32 scratch of 2 * bh * sq (the split kernels' new m, then l), else
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
// tensor-core bodies' warpgroups then move them with setmaxnreg), out[1]
// dynamic shared memory bytes, out[2] resident CTAs per SM, out[3] the body
// (0 simple, 1 tensor-core, 2 simple split, 3 tensor-core split), out[4]
// its D (a split body's: the columns a CTA writes), out[5] the keys of its
// K/V tiles.
NNSTPU_EXPORT int nnstpu_flash_attributes(int d, int carry, int dtype,
                                          int* out) {
  return carry ? attributes<true>(d, dtype, out)
               : attributes<false>(d, dtype, out);
}
