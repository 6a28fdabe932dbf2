// The tile engine shared by the attention kernels of the port: B10
// (block-sparse), B11 (dense flash), B4/B8 (prefill survivor gather) and
// B2/B6 (decode survivor gather, one split of its slots). One block of
// query rows, one warp per 16 of them, streams a list of key tiles
// through a ring in shared memory and folds each into an f32 online
// softmax on the tensor cores.
//
// - Tiles: the caller names tile t of its list by its source row (where
//   its K/V rows start in the operand arrays: a page of the pool, a block
//   of the contiguous cache, or simply the key position) and its logical
//   key position kpos0, separately, with its count of valid keys.
// - Rows: a position policy gives each query row's position (computed,
//   q_first + r, for B10/B11; read from q_positions for B4/B8; the cache
//   length − 1 for the decode rows). A row at position −1 is dead (a
//   sentinel or padding row): every key is masked for it, so it comes out
//   0. A tile wholly above the largest live position of the block (the
//   wgmma path) or of the warp (mma.sync) is skipped.
// - Ring: STAGES stages of one K and one V tile of KT keys, filled by
//   16-byte cp.async.cg copies issued STAGES − 1 tiles ahead of the
//   tile being computed, one __syncthreads per tile. Keys past a tile's
//   valid count are zero-filled.
// - Head dims: the operands hold rows of d columns (their row stride),
//   and the block runs the instantiation D = mpmrf::kernel_head_dim(d)
//   ≥ d; Q, K and V columns d .. D − 1 are zero-filled in shared memory,
//   so every product over them adds exact zeros, and only d columns of
//   each output row are written.
// - Layout: every bf16 tile (Q/O stage, K, V) is stored as 64-column
//   blocks of 128-byte rows with the 16-byte chunks XOR-swizzled by the
//   row (the 128-byte swizzle of wgmma and TMA), so the eight rows an
//   ldmatrix reads at one chunk fall in eight bank groups; narrower
//   heads (d 16, 32) swizzle within their shorter rows.
// - Products, two paths into one f32 accumulator layout (lane holds
//   rows g = lane/4 and g + 8 of its warp's 16, columns 2·(lane%4) +
//   {0, 1} of each 8-wide tile):
//   * Group (d ∈ {64, 128}, query blocks of 64 or 128): a block of one
//     warpgroup and 64 rows issues wgmma m64n64k16 — S = Q·Kᵀ with Q
//     and K read from shared memory by descriptor, P·V with P from
//     registers and V read transposed. At d 128 a block holds 112 KB of
//     shared memory, so two run on each SM and one's softmax overlaps
//     the other's products (a query block of 128 is two such blocks).
//   * Warp (every other shape): the query block in one block, Q held as
//     ldmatrix fragments, K by ldmatrix and V by ldmatrix.trans,
//     mma.sync m16n8k16.
// - Softmax: the scale is applied in f32; only tiles that hold invalid
//   keys or cross a row's position are masked. The reference's rules
//   hold: forbidden scores are NEG_INF, p = 0 wherever s ≤ NEG_INF/2,
//   and the softmax is folded once per tile (row max and sum across the
//   quad with __shfl_xor_sync).
// - P·V at f32 accuracy: p is split into hi = bf16(p) and
//   lo = bf16(p − hi), both multiplied by the same V tile into one f32
//   accumulator. P rounded once to bf16 fails the gather tolerance on
//   early query rows, where two or three keys carry the row and their
//   values cancel (tests/test_torch_full_sequence.py); l sums the f32 p.
// - Epilogue (run): acc / max(l, 1e-30), rounded once to bf16, staged
//   through the Q rows in shared memory and stored in 16-byte writes; a
//   caller of key_loop may instead keep the raw (m, l, acc).
// A tile whose every pair is masked leaves (m, l, acc) bit-identical
// (corr = 1, p = 0), which is why the kernels may skip such tiles.
#pragma once

#include "mpmrf_common.cuh"

namespace flash {

constexpr int KT = 64;      // keys per ring stage
constexpr int STAGES = 3;   // ring depth
constexpr int ALIGN = 1024; // a 128-byte swizzle atom: 8 rows of 128 bytes
constexpr float LOG2E = 1.4426950408889634f;

// Let `kernel` take `smem` bytes of dynamic shared memory, with the
// shared-memory carve-out at its maximum, on the current device. The
// attributes are set only when a launch needs more than the kernel was
// last given there (`given`: the caller's per-kernel record, per
// device), so a steady stream of launches makes no attribute calls.
template <class Kernel>
inline void allow_smem(Kernel kernel, size_t smem, size_t (&given)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  const bool kept = dev >= 0 && dev < 64;
  if (kept && smem <= given[dev]) return;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  if (kept) given[dev] = smem;
}

// Query rows per block of the instantiation D: one warpgroup of 64 for
// the wgmma path (a query block of 128 takes two blocks, which then run
// two to an SM), else the query block, one warp per 16 rows.
inline int block_rows(int D, int bq) {
  return D >= 64 && bq % 64 == 0 ? 64 : bq;
}

// Dynamic shared memory of one block of `rows` query rows of the
// instantiation D: the Q/O stage and the ring
// (kernels/flash_attention.py::engine_smem_bytes mirrors it). At D 128
// it is 112 KB, so two blocks share an SM.
inline size_t smem_bytes(int D, int rows) {
  return sizeof(__nv_bfloat16) * (size_t)D * (rows + 2 * STAGES * KT);
}

// Offset, in 16-byte chunks, of chunk c of row r of a tile of `rows`
// rows of D bf16.
template <int D>
__device__ __forceinline__ int swz(int rows, int r, int c) {
  constexpr int C = D / 8;  // chunks per row
  if constexpr (C >= 8)
    return (c >> 3) * rows * 8 + r * 8 + ((c & 7) ^ (r & 7));
  else
    return r * C + (c ^ ((r / (8 / C)) & (C - 1)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory writes become visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a · b on the tensor cores: A 16 × 16 (row), B 16 × 8 (col), f32.
__device__ __forceinline__ void mma(float* c, const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// --- wgmma ----------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at shared address `addr`:
// 8-row groups of 128-byte rows, 1024 bytes apart. Every product here
// spans one swizzle atom in its other direction (16 deep along K for
// K-major Q and K; 64 wide along N for V read transposed), so the
// second stride is never used and is given the same value.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t stride = ALIGN >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (stride << 16) |
         (stride << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins accumulator registers in place across an asynchronous product.
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define FLASH_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define FLASH_OUT32(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 × 64, f32) = [d +] A · Bᵀ, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FLASH_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 × 64, f32) += A · B, A from registers (mma.sync's A layout per
// warp), B N-major in shared memory (read transposed).
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FLASH_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// --- shared by both paths ---------------------------------------------------

// 2^x on the special-function unit (relative error ~2⁻²²; results below
// 2⁻¹²⁶ flush to 0, far under anything the bf16 output can show).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x, y) as bf16x2 words hi = bf16(·) and lo = bf16(· − hi).
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The A fragments (hi, lo) of keys 16j .. 16j + 15 of P.
__device__ __forceinline__ void p_frags(const float* s, int j,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(s[8 * j + 0], s[8 * j + 1], hi[0], lo[0]);
  split(s[8 * j + 2], s[8 * j + 3], hi[1], lo[1]);
  split(s[8 * j + 4], s[8 * j + 5], hi[2], lo[2]);
  split(s[8 * j + 6], s[8 * j + 7], hi[3], lo[3]);
}

// --- query-row positions ------------------------------------------------------

// The positions of the lane's rows g and g + 8 of its warp's 16, and the
// least and largest position among those 16 rows (−1: a dead row).
struct RowPos {
  int p[2];
  int lo, hi;
};

// Row r of the block sits at position q_first + r (B10, B11).
struct Contiguous {
  int q_first;
  __device__ __forceinline__ int operator()(int r) const {
    return q_first + r;
  }
};

// RowPos of this warp's rows under the position policy `pos` (block
// row → position, −1 for a dead row).
template <class Pos>
__device__ __forceinline__ RowPos warp_rows(const Pos& pos) {
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  RowPos rp;
  rp.p[0] = pos(r0 + (lane >> 2));
  rp.p[1] = pos(r0 + (lane >> 2) + 8);
  rp.lo = min(rp.p[0], rp.p[1]);
  rp.hi = max(rp.p[0], rp.p[1]);
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    rp.lo = min(rp.lo, __shfl_xor_sync(0xffffffffu, rp.lo, off));
    rp.hi = max(rp.hi, __shfl_xor_sync(0xffffffffu, rp.hi, off));
  }
  return rp;
}

// Scale and mask the lane's part of a 16 × KT slice of S (`s`, 8-key
// tile t at s[4t..4t+3]), fold it into the running (m, l) of rows g and
// g + 8, rescale the accumulator `o` (NO floats, the same layout), and
// leave p in `s`. Keys kpos0 + key; rows at positions rp.p.
template <int NO>
__device__ __forceinline__ void fold(float* s, float (&m)[2], float (&l)[2],
                                     float* o, int nv, int kpos0,
                                     const RowPos& rp, bool causal,
                                     float sm_scale) {
  const int lane = threadIdx.x & 31, qd = lane & 3;
  const bool masked = nv < KT || (causal && kpos0 + KT - 1 > rp.lo);
  float tm[2] = {MPMRF_NEG_INF, MPMRF_NEG_INF};
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    float x = s[i] * sm_scale;
    if (masked) {
      const int key = 8 * (i >> 2) + 2 * qd + (i & 1);
      if (key >= nv || (causal && kpos0 + key > rp.p[(i >> 1) & 1]))
        x = MPMRF_NEG_INF;
    }
    s[i] = x;
    tm[(i >> 1) & 1] = fmaxf(tm[(i >> 1) & 1], x);
  }
  float corr[2], ml[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 1));
    tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 2));
    const float mn = fmaxf(m[r], tm[r]);
    corr[r] = ex2((m[r] - mn) * LOG2E);
    m[r] = mn;
    ml[r] = mn * LOG2E;
  }
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    const float x = s[i];
    const int r = (i >> 1) & 1;
    // exp(x − m) as 2^(x·log2 e − m·log2 e), one FMA and one MUFU op
    const float p =
        x <= MPMRF_NEG_INF / 2 ? 0.f : ex2(__fmaf_rn(x, LOG2E, -ml[r]));
    s[i] = p;
    rs[r] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = corr[r] * l[r] + rs[r];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];
}

// acc / max(l, 1e-30) rounded once to bf16 (o: D/2 floats, 8-column
// tile t at o[4t..4t+3]), staged in rows 16w .. 16w + 15 of the bq-row
// stage `qs` (w: this warp) and written to the 16 rows at `out`, row
// stride and head dim ld ≤ D (columns past ld are not written).
template <int D>
__device__ __forceinline__ void store_rows(const float* o, const float (&l)[2],
                                           __nv_bfloat16* qs, int bq,
                                           __nv_bfloat16* out, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = l[r];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    den[r] = fmaxf(x, 1e-30f);
  }
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    *reinterpret_cast<__nv_bfloat162*>(qs + swz<D>(bq, r0 + g, t) * 8 +
                                       2 * qd) =
        __floats2bfloat162_rn(o[4 * t] / den[0], o[4 * t + 1] / den[0]);
    *reinterpret_cast<__nv_bfloat162*>(qs + swz<D>(bq, r0 + g + 8, t) * 8 +
                                       2 * qd) =
        __floats2bfloat162_rn(o[4 * t + 2] / den[1], o[4 * t + 3] / den[1]);
  }
  __syncwarp();
  constexpr int C = D / 8;
  for (int i = lane; i < 16 * C; i += 32)
    if ((i % C) * 8 < ld)
      *reinterpret_cast<int4*>(out + (i / C) * ld + (i % C) * 8) =
          *reinterpret_cast<const int4*>(qs + swz<D>(bq, r0 + i / C, i % C) *
                                                  8);
}

// --- the two product paths ----------------------------------------------------
//
// Both expose one interface to the key loop: init and attend (fold one
// key tile into the rows; done when it returns). `rp` holds the warp's
// row positions, `q_last` the block's largest live position.

// One warp's 16 rows on mma.sync; every call completes before it returns.
template <int D>
struct Warp {
  static constexpr int THREADS = 0;  // one warp per 16 rows of the block
  static constexpr int NK = D / 16;  // 16-deep slices of d
  uint32_t qf[NK][4];
  float o[D / 2];
  float m[2], l[2];

  __device__ __forceinline__ void init(const __nv_bfloat16* qs, int bq) {
    const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      ldsm_x4(smem_u32(qs + swz<D>(bq, r0 + (lane & 15),
                                   2 * kk + (lane >> 4)) * 8),
              qf[kk]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = MPMRF_NEG_INF;
    l[0] = l[1] = 0.f;
  }

  // Fold keys kpos0 .. kpos0 + nv − 1 (ks / vs: KT × D, rows ≥ nv
  // zero) into the rows. With `causal`, key kpos is visible to a row at
  // position qpos iff kpos <= qpos.
  __device__ __forceinline__ void attend(const __nv_bfloat16* ks,
                                         const __nv_bfloat16* vs, int nv,
                                         int kpos0, const RowPos& rp,
                                         int q_last, bool causal,
                                         float sm_scale) {
    (void)q_last;
    if (causal && kpos0 > rp.hi) return;  // wholly above these rows
    const int lane = threadIdx.x & 31;
    float s[KT / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int j = 0; j < KT / 16; ++j) {
        if (j * 16 >= nv) continue;
        uint32_t b[4];
        ldsm_x4(smem_u32(ks + swz<D>(KT, 16 * j + (lane & 7) +
                                             ((lane >> 4) << 3),
                                     2 * kk + ((lane >> 3) & 1)) * 8),
                b);
        mma(s + 8 * j, qf[kk], b[0], b[1]);
        mma(s + 8 * j + 4, qf[kk], b[2], b[3]);
      }
    fold<D / 2>(s, m, l, o, nv, kpos0, rp, causal, sm_scale);
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      if (j * 16 >= nv) continue;
      uint32_t hi[4], lo[4];
      p_frags(s, j, hi, lo);
#pragma unroll
      for (int dp = 0; dp < NK; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(smem_u32(vs + swz<D>(KT, 16 * j + (lane & 7) +
                                               (((lane >> 3) & 1) << 3),
                                       2 * dp + (lane >> 4)) * 8),
                  b);
        mma(o + 8 * dp, hi, b[0], b[1]);
        mma(o + 8 * dp, lo, b[0], b[1]);
        mma(o + 8 * dp + 4, hi, b[2], b[3]);
        mma(o + 8 * dp + 4, lo, b[2], b[3]);
      }
    }
  }
};

// A block of one warpgroup's 64 rows on wgmma (D ∈ {64, 128}).
template <int D>
struct Group {
  static constexpr int THREADS = 128;
  static constexpr int NB = D / 64;  // 64-wide column blocks of the output
  float o[D / 2];                    // block b at o[32b .. 32b + 31]
  float m[2], l[2];
  uint32_t qaddr;  // the Q rows in shared memory

  __device__ __forceinline__ void init(const __nv_bfloat16* qs, int bq) {
    (void)bq;  // 64
    qaddr = smem_u32(qs);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = MPMRF_NEG_INF;
    l[0] = l[1] = 0.f;
  }

  __device__ __forceinline__ void attend(const __nv_bfloat16* ks,
                                         const __nv_bfloat16* vs, int nv,
                                         int kpos0, const RowPos& rp,
                                         int q_last, bool causal,
                                         float sm_scale) {
    // wholly above the block's rows (a uniform branch: wgmma is issued
    // by the four warps together)
    if (causal && kpos0 > q_last) return;
    float s[KT / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) s[i] = 0.f;
    const uint32_t kaddr = smem_u32(ks), vaddr = smem_u32(vs);
    pin<KT / 2>(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc(qaddr + (kk >> 2) * 64 * 128 + (kk & 3) * 32),
               desc(kaddr + (kk >> 2) * KT * 128 + (kk & 3) * 32), kk);
    wg_commit();
    wg_wait();
    pin<KT / 2>(s);
    fold<D / 2>(s, m, l, o, nv, kpos0, rp, causal, sm_scale);
    uint32_t hi[KT / 16][4], lo[KT / 16][4];
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) p_frags(s, j, hi[j], lo[j]);
    pin<D / 2>(o);
    wg_fence();
#pragma unroll
    for (int j = 0; j < KT / 16; ++j)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const uint64_t vd = desc(vaddr + b * KT * 128 + j * 16 * 128);
        wgmma_rs(o + 32 * b, hi[j], vd);
        wgmma_rs(o + 32 * b, lo[j], vd);
      }
    wg_commit();
    wg_wait();
    pin<D / 2>(o);
  }
};

// --- the block's key loop -------------------------------------------------------

// Rows [0, nv) of the KT-row tile at `src` (row stride and head dim
// ld ≤ D) into the KT × D tile `dst`; rows nv..KT-1 and columns past ld
// are zero-filled (a masked key's p = 0 must meet a finite V row, and a
// padded column adds nothing to a product). With a block of THREADS
// threads (0: any) whose steps span a multiple of 8 rows, each thread
// keeps one chunk column and its swizzle for every step, so its offsets
// (and whether its column is padded) are computed once.
template <int D, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int nv,
                                          int ld) {
  constexpr int C = D / 8;
  if constexpr (THREADS > 0 && THREADS % (8 * C) == 0 && C >= 8) {
    constexpr int STEP = THREADS / C;  // rows per step
    const int r0 = threadIdx.x / C, c = threadIdx.x % C;
    const bool col = c * 8 < ld;       // not a padded column
    const uint32_t d0 = smem_u32(dst + swz<D>(KT, r0, c) * 8);
    const __nv_bfloat16* s0 = src + r0 * ld + c * 8;
#pragma unroll
    for (int j = 0; j < KT / STEP; ++j) {
      const bool in = col && r0 + j * STEP < nv;
      cp_async16(d0 + j * STEP * 128, in ? s0 + j * STEP * ld : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < KT * C; i += blockDim.x) {
      const int r = i / C, c = i % C;
      const bool in = r < nv && c * 8 < ld;
      cp_async16(smem_u32(dst + swz<D>(KT, r, c) * 8),
                 in ? src + r * ld + c * 8 : src, in);
    }
  }
}

// The block's dynamic shared memory. The wgmma descriptors' swizzle
// needs it aligned to a 1024-byte atom, as it is on sm_90 (no static
// shared memory precedes it); a launch that breaks that traps.
__device__ __forceinline__ __nv_bfloat16* smem_base() {
  extern __shared__ __align__(ALIGN) uint8_t flash_smem[];
  if (smem_u32(flash_smem) & (ALIGN - 1)) __trap();
  return reinterpret_cast<__nv_bfloat16*>(flash_smem);
}

// Copy this warp's 16 query rows (from `q`, the block's first row; row
// stride and head dim ld ≤ D, columns past it zero-filled) into the
// bq-row stage `qs` (uncommitted: the first tile's group carries them).
template <int D>
__device__ __forceinline__ void issue_q(__nv_bfloat16* qs,
                                        const __nv_bfloat16* q, int bq,
                                        int ld) {
  constexpr int C = D / 8;
  const int r0 = (threadIdx.x >> 5) * 16;
  for (int i = threadIdx.x & 31; i < 16 * C; i += 32) {
    const bool in = (i % C) * 8 < ld;
    cp_async16(smem_u32(qs + swz<D>(bq, r0 + i / C, i % C) * 8),
               in ? q + (size_t)(r0 + i / C) * ld + (i % C) * 8 : q, in);
  }
}

// The key loop of one block, into `rows` (init'ed here). `tiles(t, src,
// kpos0, nv)` names tile t of `n_tiles`: nv ≤ KT keys at logical
// positions kpos0 .. kpos0 + nv − 1, whose K and V rows start at row
// `src` of `k` / `v` (row stride ld, the operands' head dim, ≤ D).
// `smem` (smem_base) holds the bq Q/O rows, then the ring; the caller
// has issued the Q rows. `pos` gives block row r's position (−1: dead)
// and q_last is the block's largest live position.
template <int D, class Rows, class Pos, class Tiles>
__device__ __forceinline__ void key_loop(Rows& rows,
                                         const __nv_bfloat16* __restrict__ k,
                                         const __nv_bfloat16* __restrict__ v,
                                         __nv_bfloat16* smem, int bq,
                                         const Pos& pos, int q_last,
                                         bool causal, float sm_scale,
                                         int n_tiles, const Tiles& tiles,
                                         int ld) {
  __nv_bfloat16* ring = smem + bq * D;
  auto kst = [&](int t) { return ring + (t % STAGES) * 2 * KT * D; };
  auto issue = [&](int t) {
    if (t < n_tiles) {
      int src, kpos0, nv;
      tiles(t, src, kpos0, nv);
      load_tile<D, Rows::THREADS>(kst(t), k + (size_t)src * ld, nv, ld);
      load_tile<D, Rows::THREADS>(kst(t) + KT * D, v + (size_t)src * ld,
                                  nv, ld);
    }
    cp_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);
  const RowPos rp = warp_rows(pos);
  cp_wait<STAGES - 2>();  // the Q rows (group 0) are in
  fence_async_smem();
  __syncthreads();
  rows.init(smem, bq);
  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<STAGES - 2>();
    fence_async_smem();
    __syncthreads();  // tile t is in; tile t − 1's stage is free
    issue(t + STAGES - 1);
    int src, kpos0, nv;
    tiles(t, src, kpos0, nv);
    rows.attend(kst(t), kst(t) + KT * D, nv, kpos0, rp, q_last, causal,
                sm_scale);
  }
}

// key_loop on the block's product path, then the epilogue: block row r
// is written to out + r·ld (ld: the operands' head dim, ≤ D).
template <int D, class Pos, class Tiles>
__device__ __forceinline__ void run(const __nv_bfloat16* __restrict__ k,
                                    const __nv_bfloat16* __restrict__ v,
                                    __nv_bfloat16* __restrict__ out,
                                    __nv_bfloat16* smem, int bq,
                                    const Pos& pos, int q_last, bool causal,
                                    float sm_scale, int n_tiles,
                                    const Tiles& tiles, int ld) {
  __nv_bfloat16* rows_out = out + (size_t)(threadIdx.x >> 5) * 16 * ld;
  if constexpr (D >= 64) {
    if (bq == 64) {
      Group<D> rows;
      key_loop<D>(rows, k, v, smem, bq, pos, q_last, causal, sm_scale,
                  n_tiles, tiles, ld);
      store_rows<D>(rows.o, rows.l, smem, bq, rows_out, ld);
      return;
    }
  }
  Warp<D> rows;
  key_loop<D>(rows, k, v, smem, bq, pos, q_last, causal, sm_scale, n_tiles,
              tiles, ld);
  store_rows<D>(rows.o, rows.l, smem, bq, rows_out, ld);
}

}  // namespace flash
