// The integer filter engine shared by the MP-MRF filter kernels of the
// port: B3 (paged prefill), B7 (contiguous prefill), B9 (full sequence,
// precomputed planes) and the decode filter B1 (paged) / B5
// (contiguous). Each output is the max, over a tile of (query row, key)
// pairs, of both filter rounds' scores
//     s_r = (f32(acc_r) · qs_row) · ks_key        (round to nearest)
// with acc_r an exact int32 dot of int8 bit planes, pairs the mask
// forbids counted as NEG_INF. B3/B7/B9 are one body (filter_block) under
// three policies (Kind): where a row's position and scale come from,
// where a key tile's planes come from, and what its key scale is. The
// decode kind (decode_block, below) is a body of its own built from the
// same parts: its G ≤ 16 query rows are too few for an m-tile, so its
// keys go on the products' M side.
//
// - Head dims: the operands hold rows of d = a.d columns, and a block
//   runs the instantiation D = mpmrf::kernel_head_dim(d) ≥ d: it reads d
//   columns of each row and zero-fills columns d .. D − 1 of its query
//   stage and of its code / plane tiles (zero codes derive zero planes),
//   so every int8 dot over them adds exact zeros and the scores are those
//   of the d-column dots, bit for bit. Shared memory, the product path
//   and the tiles' layout are the instantiation's.
// - Blocks: one block owns a (bh row, query block) pair, or one run of
//   it: the query block's visible key blocks (those at or below its
//   largest live position) are cut into min(S, T) contiguous runs of
//   equal length, S fixed per launch so that the launch makes about four
//   blocks per SM (filter_runs). Each output (qb, j) is written by
//   exactly one block: the block whose run holds j, or, for a key block
//   above every row, block (j − T) mod S, which writes NEG_INF without
//   reading anything.
//   Query blocks go in reverse order; B3/B7 run a bh row's query blocks
//   together (they read the same pages, which then come from L2), B9
//   every row's last query block first (the longest causal triangles).
// - Keys: a cp.async ring in shared memory. B9 streams its k_msb and
//   k_rem rows straight into 128-byte-swizzled plane tiles (three
//   stages). B3/B7 stream the int16 codes (two stages) and derive both
//   int8 planes once per block, one tile ahead of the products:
//   msb = code >> (16 − lo) and hi = code >> (16 − hi), four lanes to a
//   word, from the codes' high bytes by a packed arithmetic shift of
//   min(8 − lo, 7) and 8 − hi (at lo = 0 the msb plane is the code's
//   sign, which the shift by 7 gives; the wrappers compute the shifts,
//   kernels/mpmrf_decode.py::plane_shifts).
// - Products on the int8 tensor cores, s8 × s8 → s32, two per key tile
//   with the same query operand. B3/B7 multiply q by msb and by the hi
//   plane: acc1 = (acc0 << (hi − lo)) + q·remᵀ = q·(msb·2^(hi−lo) +
//   rem)ᵀ = q·hiᵀ, exactly; every operand fits int8 for
//   0 ≤ lo < hi ≤ 8. B9 multiplies its given planes:
//   acc1 = acc0·2^shift + q·remᵀ. Two paths (product_path):
//   * wgmma (d 128, query and key blocks of multiples of 64): a
//     warpgroup per 64 query rows issues m64n64k32 with the query stage
//     and the key planes read from shared memory by descriptor, the
//     query stage kept for the block's whole life;
//   * mma.sync (every other shape): one warp per 16 query rows, the
//     query plane held as A fragments in registers for the block's whole
//     life, the key planes by ldmatrix; m16n8k32, or m16n8k16 at d 16.
// - Epilogue, per key tile in registers. The rescale is a chain of
//   round-to-nearest products by positive finite factors, so it is
//   monotone in acc: the max of the scores is the score of the largest
//   acc. Each thread keeps, per row, the largest acc among its valid
//   pairs (an int32 max: Hopper's three-way DPX max on a tile wholly
//   visible to the warp's rows, masked pairs skipped elsewhere) and
//   rescales it once in the reference's association; a tile whose key
//   scales differ (B7 across scale groups: seen while its planes are
//   derived, ORed over the block at the next barrier) or a row whose
//   factors are not positive and finite takes the per-pair rescale. Then the max over the thread's
//   rows, over the warp by shuffles, and across warps through shared
//   memory: warp 0 writes (s0, s1) of tile t while tile t + 1 computes.
//   As in the reference (and the plain versions), the result is bit for
//   bit the max of the scores, NEG_INF where no pair is valid.
//
// The decode kind (B1/B5: one output per logical key block j of a bh
// row, the G folded query rows of a decode step against the bk keys of
// page bt[b, j], masked at kpos < cache_length[b]) is bound by bytes: it
// reads each live page's int16 codes once, G·bk·d·4 int8 operations a
// page are nothing beside them. So it streams pages:
// - Blocks: one per (bh row, run) of the row's T = ⌈len / bk⌉ live key
//   blocks, cut into min(S, T) runs (key_run); S per launch so that the
//   launch is one wave of the blocks the card holds at once
//   (decode_runs: 8 at the serving path's 64 rows, four blocks per SM),
//   since each block streams its pages and a second wave would only add
//   its start-up. A key block past the length gets NEG_INF from block
//   (j − T) mod S without a read. The block reads its length, (B1) its
//   row of the table, its q rows and their scales together, so one round
//   trip to memory comes before the first page's.
// - Keys: a ring of DECODE_STAGES whole pages by cp.async, two in flight
//   while one is multiplied (a third stage in flight costs a block per
//   SM at 16 KB pages: three instead of four, and with them fewer, longer
//   runs; it measured slower). Each thread copies the 16 codes (two
//   16-byte chunks) of a key row it will derive, so it derives them in
//   place, with no barrier, one page ahead of the products: the msb
//   chunk replaces the first, the hi chunk the second. Rows are
//   XOR-swizzled by 16-byte chunk, so ldmatrix reads conflict-free.
// - Products: mma.sync s8 with the keys on the M side: four warps, each
//   one m16 tile of a 64-key page; A = 16 keys × 32 bytes of a derived
//   plane by ldmatrix, B = the G rows (one n8 tile, two for 8 < G ≤ 16)
//   as fragments narrowed from the int32 q plane once per block and held
//   for the block's life. acc0 = q·msbᵀ and acc1 = q·hiᵀ, as above.
// - Epilogue: the shared one — per query row the largest valid acc,
//   rescaled once (the per-pair rescale where a factor is not positive
//   and finite), the max over the warp by shuffles and across the four
//   warps through shared memory, one (s0, s1) per (b, j).
#pragma once

#include <climits>

#include "flash_common.cuh"

namespace filt {

enum class Kind { kPagedPrefill, kPrefill, kFull, kPagedDecode, kDecode };

constexpr int CODE_STAGES = 2;    // B3/B7: int16 code tiles in flight
constexpr int PLANE_STAGES = 3;   // B9: int8 plane tiles in flight
constexpr int DECODE_STAGES = 3;  // B1/B5: pages in the ring
constexpr int DECODE_WARPS = 4;   // B1/B5: one m16 tile of a 64-key page each
constexpr int MAX_WARPS = 8;      // query blocks of at most 128 rows

// Everything a launch passes; unused fields are 0 for a kind.
struct Args {
  const void* q_plane;       // int32 (B1/B3/B5/B7) or int8 (B9) [bh, n_q, d]
  const float* q_scale;      // [bh, n_q]
  const int32_t* q_pos;      // B3/B7 [bh, n_q]
  const int32_t* len;        // B1/B5 [bh] cache lengths
  const void* k0;            // B1/B3/B5/B7 int16 codes; B9 int8 k_msb
  const int8_t* k_rem;       // B9
  // B1/B3 [pages] (per page); B5 [bh, n_kb] (per block); B7 [bh, n_k]
  // (per row)
  const float* k_scale;
  const int32_t* table;      // B1/B3 [bh, mb]
  float* s0;
  float* s1;
  int n_q, bq, bk, n_kb, runs;  // runs: S, the key runs per query block
                                // (B1/B5: n_q = G, per bh row)
  int lo, hi;                // B1/B3/B5/B7 plane widths
  int msb_shift, hi_shift;   // their packed shifts of the codes' high bytes
  int shift, causal, q_offset;  // B9
  int d;                     // the operands' head dim (row stride), ≤ D
};

// Offset, in bytes, of 16-byte chunk c of row r of an int8 tile of
// `rows` rows of D bytes: the tile engine's swizzle of the same bytes.
template <int D>
__device__ __forceinline__ int off(int rows, int r, int c) {
  return flash::swz<D / 2>(rows, r, c) * 16;
}

__device__ __forceinline__ void mma_k32(int* c, const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_k16(int* c, const uint32_t (&a)[4],
                                        uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// Arithmetic right shift by s (0..7) of each of the four int8 lanes of
// h: the logical shift masked to the lane, then the lane's sign bit
// (bit 7 − s) spread over the vacated bits by one multiply, which no
// lane carries out of (2^(7−s) · (2^(s+1) − 2) < 256).
struct LaneShift {
  int s;
  uint32_t mask, sign, fill;
  __device__ __forceinline__ explicit LaneShift(int s_) : s(s_) {
    mask = 0x01010101u * (0xFFu >> s);
    sign = 0x01010101u * (0x80u >> s);
    fill = (2u << s) - 2u;
  }
  __device__ __forceinline__ uint32_t operator()(uint32_t h) const {
    const uint32_t u = (h >> s) & mask;
    return u | ((u & sign) * fill);
  }
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ bool positive_finite(float x) {
  return x > 0.f && x <= 3.40282347e38f;  // NaN fails both
}

// Four int32 plane values (each fits int8) narrowed to four int8 lanes.
__device__ __forceinline__ uint32_t narrow4(const int4& v) {
  return __byte_perm(__byte_perm(v.x, v.y, 0x0040),
                     __byte_perm(v.z, v.w, 0x0040), 0x5410);
}

// 16 int16 codes (two 16-byte chunks x, y) → their msb and hi plane
// bytes, from the codes' high bytes (code >> 8, four to a word).
__device__ __forceinline__ void derive16(const int4& x, const int4& y,
                                         const LaneShift& msb_of,
                                         const LaneShift& hi_of, uint4& msb,
                                         uint4& hi) {
  const uint32_t h[4] = {__byte_perm(x.x, x.y, 0x7531),
                         __byte_perm(x.z, x.w, 0x7531),
                         __byte_perm(y.x, y.y, 0x7531),
                         __byte_perm(y.z, y.w, 0x7531)};
  msb = make_uint4(msb_of(h[0]), msb_of(h[1]), msb_of(h[2]), msb_of(h[3]));
  hi = make_uint4(hi_of(h[0]), hi_of(h[1]), hi_of(h[2]), hi_of(h[3]));
}

// --- the epilogue ---------------------------------------------------------
// The reference's rescale of one acc: (f32(acc) · qs) · ks, each product
// rounded to nearest.
__device__ __forceinline__ float rescale(int acc, float qs, float ks) {
  return __fmul_rn(__fmul_rn((float)acc, qs), ks);
}

// Each of a thread's R rows' largest valid acc (INT_MIN: none), rescaled
// once, into the thread's maxima m0, m1 (positive finite factors: the
// rescale is monotone in acc).
template <int R>
__device__ __forceinline__ void rescale_rows(const int* rm0, const int* rm1,
                                             const float* qsf, float ks0,
                                             float ks1, float& m0,
                                             float& m1) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (rm0[k] == INT_MIN) continue;  // no valid pair in this row
    m0 = fmaxf(m0, rescale(rm0[k], qsf[k], ks0));
    m1 = fmaxf(m1, rescale(rm1[k], qsf[k], ks1));
  }
}

// The max of (m0, m1) over the warp, stored by lane 0 at slot[0..1].
__device__ __forceinline__ void warp_max_to(float m0, float m1,
                                            float* slot) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  if ((threadIdx.x & 31) == 0) {
    slot[0] = m0;
    slot[1] = m1;
  }
}

// Warp 0 folds the `warps` warps' maxima rr[2·w], rr[2·w + 1] and writes
// them to *o0, *o1.
__device__ __forceinline__ void flush_warps(const float* rr, int warps,
                                            float* o0, float* o1) {
  const int lane = threadIdx.x & 31;
  if ((threadIdx.x >> 5) != 0) return;
  float v0 = lane < warps ? rr[2 * lane] : MPMRF_NEG_INF;
  float v1 = lane < warps ? rr[2 * lane + 1] : MPMRF_NEG_INF;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, o));
    v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, o));
  }
  if (lane == 0) {
    *o0 = v0;
    *o1 = v1;
  }
}

// Runs of the query block's T visible key blocks: run s of min(S, T).
__device__ __forceinline__ void key_run(int T, int S, int s, int& j0,
                                        int& j1) {
  const int n = min(S, T);
  j0 = s < n ? s * T / n : 0;
  j1 = s < n ? (s + 1) * T / n : 0;
}

// The launch's S: enough runs per query block that the launch makes
// about four blocks per SM, at most one per key block.
inline int filter_runs(int pairs, int n_kb, int sms) {
  const int want = (4 * sms + pairs - 1) / pairs;
  return max(1, min(n_kb, want));
}

// SMs of the current device, read once per device.
inline int sm_count() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
  int n = 132;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev >= 0 && dev < 64) cached[dev] = n;
  return n;
}

// The product path of a launch, as the kernels' MT template argument:
// 0 = wgmma, one warpgroup per 64 query rows (d 128, query and key
// blocks of multiples of 64); 1 = mma.sync, one 16-row m-tile per warp.
inline int product_path(int d, int bq, int bk) {
  return d == 128 && bq % 64 == 0 && bk % 64 == 0 ? 0 : 1;
}

// On mma.sync the query stage is needed only until its A fragments are
// loaded, so it lives in the last (msb, hi) plane region — B3/B7's
// second plane buffer, B9's third ring stage — when it fits there. wgmma
// reads it from shared memory at every tile.
__host__ __device__ inline bool q_in_planes(int mt, int bq, int bk) {
  return mt > 0 && bq <= 2 * bk;
}

// B1/B5: bytes of one ring stage, a page's codes and its scale.
__host__ __device__ inline int decode_stage(int d, int bk) {
  return bk * 2 * d + 16;
}

// Dynamic shared memory of one block: the query stage where it does not
// sit in the planes, the plane tiles (B3/B7: two buffers of derived
// planes; B9: the ring), (B3/B7) the code ring and the planes' key
// scales, then the cross-warp maxima and the warps' largest positions.
// Every plane tile and the query stage start on a 1024-byte boundary.
// B1/B5: the ring of pages, the cross-warp maxima, (B1) the row's block
// table of n_kb entries.
inline size_t smem_bytes(Kind kind, int mt, int d, int bq, int bk,
                         int n_kb) {
  if (kind == Kind::kPagedDecode || kind == Kind::kDecode)
    return (size_t)DECODE_STAGES * decode_stage(d, bk) +
           sizeof(float) * 2 * MAX_WARPS * 2 +
           (kind == Kind::kPagedDecode ? sizeof(int) * n_kb : 0);
  size_t planes = kind == Kind::kFull
                      ? (size_t)PLANE_STAGES * 2 * bk * d
                      : (size_t)2 * 2 * bk * d +
                            (size_t)CODE_STAGES * (bk * 2 * d + bk * 4) +
                            2 * bk * 4;
  return (q_in_planes(mt, bq, bk) ? 0 : (size_t)bq * d) + planes +
         sizeof(float) * 2 * MAX_WARPS * 2 + sizeof(int) * MAX_WARPS;
}

#define FILT_OUT32(d)                                                        \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),   \
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),          \
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),      \
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),      \
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),      \
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),      \
      "+r"(d[31])

// d (64 × 64, s32) = [d +] A · Bᵀ, s8 A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " FLASH_D32
      ", %32, %33, p;\n}\n"
      : FILT_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// Waits for all but the last committed group of wgmma products.
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Pins accumulator registers in place across an asynchronous product.
template <int N>
__device__ __forceinline__ void pin(int* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int D, int MT, Kind K>
__device__ __forceinline__ void filter_block(const Args& a) {
  constexpr bool kCodes = K != Kind::kFull;
  constexpr bool kGroup = MT == 0;          // wgmma (see product_path)
  constexpr int KS = D >= 32 ? D / 32 : 1;  // k-steps of 32 bytes over d
  constexpr int C = D / 16;                 // 16-byte chunks per plane row
  constexpr int ROWS = 2;                   // query rows per thread
  constexpr int RW = 16;                    // query rows per warp
  const int warps = blockDim.x >> 5, nthr = blockDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int bq = a.bq, bk = a.bk, n_kb = a.n_kb, n_k = n_kb * bk;
  // B3/B7: x = (query block, run), the run fastest, y = the bh row, so
  // the query blocks that read one row's pages run together; B9: x = the
  // run, y = the bh row, z = the query block, so the longest causal
  // triangles of every row start first. Query blocks in reverse order.
  int s, b, qb, n_qb;
  if constexpr (kCodes) {
    const int x = gridDim.x - 1 - blockIdx.x;
    n_qb = gridDim.x / a.runs;
    qb = x / a.runs;
    s = x % a.runs;
  } else {
    n_qb = gridDim.z;
    qb = n_qb - 1 - blockIdx.z;
    s = blockIdx.x;
  }
  b = blockIdx.y;
  const size_t row0 = (size_t)b * a.n_q + (size_t)qb * bq;
  const size_t out0 = ((size_t)b * n_qb + qb) * n_kb;

  // --- shared memory ------------------------------------------------------
  uint8_t* base = reinterpret_cast<uint8_t*>(flash::smem_base());
  const bool q_alias = q_in_planes(MT, bq, bk);
  const int plane_tile = bk * D;
  const int code_stage = bk * 2 * D + bk * 4;       // B3/B7: codes, scales
  // B3/B7: [2][msb, hi] derived planes; B9: the ring of [msb, rem] stages
  uint8_t* planes = base + (q_alias ? 0 : bq * D);
  uint8_t* ring = kCodes ? planes + 2 * 2 * plane_tile : planes;
  float* pscale = reinterpret_cast<float*>(ring + CODE_STAGES * code_stage);
  float* red = kCodes ? pscale + 2 * bk
                      : reinterpret_cast<float*>(
                            planes + PLANE_STAGES * 2 * plane_tile);
  int* wmax = reinterpret_cast<int*>(red + 2 * MAX_WARPS * 2);
  uint8_t* qs_tile = !q_alias ? base                // [bq][D] int8, swizzled
                     : kCodes ? planes + 2 * plane_tile
                              : planes + 2 * 2 * plane_tile;

  // --- this thread's rows: positions (−1: dead) and scale factors -----------
  int pos[ROWS];
  float qsf[ROWS];
  bool rows_ok = true;
  const float q_factor = kCodes ? (float)(1 << (16 - a.hi)) : 1.f;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int r = warp * RW + g + 8 * k;
    if constexpr (kCodes) {
      const int p = a.q_pos[row0 + r];
      pos[k] = p < n_k ? p : -1;
      qsf[k] = __fmul_rn(a.q_scale[row0 + r], q_factor);
    } else {
      pos[k] = a.causal ? a.q_offset + qb * bq + r : INT_MAX;
      qsf[k] = a.q_scale[row0 + r];
    }
    rows_ok &= pos[k] < 0 || positive_finite(qsf[k]);
  }
  int wmin = pos[0], wmx = pos[0];
#pragma unroll
  for (int k = 1; k < ROWS; ++k) {
    wmin = min(wmin, pos[k]);
    wmx = max(wmx, pos[k]);
  }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, o));
    wmx = max(wmx, __shfl_xor_sync(0xffffffffu, wmx, o));
  }
  if (lane == 0) wmax[warp] = wmx;
  __syncthreads();
  int bmax = wmax[0];
  for (int w = 1; w < warps; ++w) bmax = max(bmax, wmax[w]);
  // the largest position of the warp's warpgroup: wgmma is issued by
  // its four warps together
  const int gmx = kGroup ? max(max(wmax[warp & ~3], wmax[(warp & ~3) + 1]),
                               max(wmax[(warp & ~3) + 2],
                                   wmax[(warp & ~3) + 3]))
                         : wmx;

  // --- the query block's visible key blocks, this block's run of them -------
  const int T = bmax < 0 ? 0 : min(n_kb, bmax / bk + 1);
  for (int j = T + s + tid * a.runs; j < n_kb; j += nthr * a.runs) {
    a.s0[out0 + j] = MPMRF_NEG_INF;  // above every row of the block
    a.s1[out0 + j] = MPMRF_NEG_INF;
  }
  int j0, j1;
  key_run(T, a.runs, s, j0, j1);
  const int n = j1 - j0;
  if (n <= 0) return;

  // --- staging ----------------------------------------------------------------
  const int d = a.d;
  if constexpr (kCodes) {  // the int32 plane narrowed to int8 on load
    const int32_t* q = static_cast<const int32_t*>(a.q_plane) + row0 * d;
#pragma unroll 2
    for (int i = tid; i < bq * C; i += nthr) {
      const int r = i / C, c = i % C;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);  // a padded column
      if (16 * c < d) {
        const int4* src = reinterpret_cast<const int4*>(q + r * d + 16 * c);
        x = make_uint4(narrow4(src[0]), narrow4(src[1]), narrow4(src[2]),
                       narrow4(src[3]));
      }
      *reinterpret_cast<uint4*>(qs_tile + off<D>(bq, r, c)) = x;
    }
    flash::fence_async_smem();
  } else {                 // int8 already: copied with the first tile
    const int8_t* q = static_cast<const int8_t*>(a.q_plane) + row0 * d;
    for (int i = tid; i < bq * C; i += nthr) {
      const int r = i / C, c = i % C;
      const bool in = 16 * c < d;
      flash::cp_async16(flash::smem_u32(qs_tile + off<D>(bq, r, c)),
                        in ? q + r * d + 16 * c : q, in);
    }
  }

  // tile t's sources into its ring stage. B3/B7 read the block id of
  // tile t + 1 here (B3: from the table), so that its load is not waited
  // for until the next call, an iteration later.
  const auto block_id = [&](int t) {
    return mpmrf::block_of<K == Kind::kPagedPrefill>(a.table, b, j0 + t,
                                                     n_kb);
  };
  int next_blk = kCodes ? block_id(0) : 0;
  const auto issue = [&](int t) {
    if (t < n) {
      if constexpr (kCodes) {
        const int blk = next_blk;
        if (t + 1 < n) next_blk = block_id(t + 1);
        const uint8_t* src =
            static_cast<const uint8_t*>(a.k0) + (size_t)blk * bk * 2 * d;
        uint8_t* dst = ring + (t % CODE_STAGES) * code_stage;
        if (d == D) {  // the block's codes are one contiguous run
          for (int i = tid; i < bk * D / 8; i += nthr)
            flash::cp_async16(flash::smem_u32(dst + 16 * i), src + 16 * i,
                              true);
        } else {       // rows of 2·d bytes into rows of 2·D, zero-filled
          constexpr int CC = D / 8;  // 16-byte chunks of a row's codes
          for (int i = tid; i < bk * CC; i += nthr) {
            const int r = i / CC, c = i % CC;
            const bool in = 8 * c < d;
            flash::cp_async16(flash::smem_u32(dst + 16 * i),
                              in ? src + r * 2 * d + 16 * c : src, in);
          }
        }
        if constexpr (K == Kind::kPrefill) {  // the tile's row scales
          const float* ks = a.k_scale + (size_t)blk * bk;
          for (int i = tid; i < bk / 4; i += nthr)
            flash::cp_async16(flash::smem_u32(dst + bk * 2 * D + 16 * i),
                              ks + 4 * i, true);
        } else if (tid == 0) {                // the page's scale
          cp_async4(flash::smem_u32(dst + bk * 2 * D), a.k_scale + blk);
        }
      } else {
        const size_t krow = ((size_t)b * n_k + (size_t)(j0 + t) * bk) * d;
        const int8_t* msb = static_cast<const int8_t*>(a.k0) + krow;
        const int8_t* rem = a.k_rem + krow;
        uint8_t* dst = ring + (t % PLANE_STAGES) * 2 * plane_tile;
        for (int i = tid; i < bk * C; i += nthr) {
          const int r = i / C, c = i % C;
          const int o = off<D>(bk, r, c);
          const bool in = 16 * c < d;
          flash::cp_async16(flash::smem_u32(dst + o),
                            in ? msb + r * d + 16 * c : msb, in);
          flash::cp_async16(flash::smem_u32(dst + plane_tile + o),
                            in ? rem + r * d + 16 * c : rem, in);
        }
      }
    }
    flash::cp_commit();
  };

  // B3/B7: tile t's codes (ring stage t mod 2) → its two int8 planes and
  // key scales (buffer t mod 2). Returns, for B7, whether this thread saw
  // a key-row scale differ from the tile's first: the next barrier ORs it
  // over the block.
  const auto convert = [&](int t) {
    int differs = 0;
    const LaneShift msb_of(a.msb_shift), hi_of(a.hi_shift);
    const uint8_t* src = ring + (t % CODE_STAGES) * code_stage;
    uint8_t* dst = planes + (t & 1) * 2 * plane_tile;
    for (int i = tid; i < bk * C; i += nthr) {
      const int r = i / C, c = i % C;
      const int4* cp = reinterpret_cast<const int4*>(src + r * 2 * D + 32 * c);
      const int o = off<D>(bk, r, c);
      derive16(cp[0], cp[1], msb_of, hi_of,
               *reinterpret_cast<uint4*>(dst + o),
               *reinterpret_cast<uint4*>(dst + plane_tile + o));
    }
    if constexpr (K == Kind::kPrefill) {
      const int4* ks = reinterpret_cast<const int4*>(src + bk * 2 * D);
      const int first = ks[0].x;
      for (int i = tid; i < bk / 4; i += nthr) {
        const int4 v = ks[i];
        differs |= (v.x != first) | (v.y != first) | (v.z != first) |
                   (v.w != first);
        reinterpret_cast<int4*>(pscale + (t & 1) * bk)[i] = v;
      }
    } else if (tid == 0) {
      pscale[(t & 1) * bk] =
          *reinterpret_cast<const float*>(src + bk * 2 * D);
    }
    flash::fence_async_smem();  // the planes become visible to wgmma
    return differs;
  };

  // mma.sync: the query rows as A fragments, held for the block's life
  uint32_t qa[KS][4];
  const auto load_q = [&]() {
    if constexpr (!kGroup) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        flash::ldsm_x4(
            flash::smem_u32(qs_tile +
                            off<D>(bq, warp * RW + (lane & 15),
                                   D >= 32 ? 2 * kk + (lane >> 4) : 0)),
            qa[kk]);
    }
  };

  // warp 0 folds the warps' maxima of tile t and writes its (s0, s1)
  const auto flush = [&](int t) {
    flush_warps(red + (t & 1) * MAX_WARPS * 2, warps, a.s0 + out0 + j0 + t,
                a.s1 + out0 + j0 + t);
  };

  const int shift_mul = 1 << a.shift;
  const float k_factor0 = kCodes ? (float)(1 << (16 - a.lo)) : 1.f;
  const float k_factor1 = q_factor;
  // tile t: planes p0 (msb) and p0 + plane_tile (hi, or B9's remainder)
  // (`uniform`: B7's key-row scales of the tile are all one)
  const auto compute = [&](int t, const uint8_t* p0, bool uniform) {
    const int kbase = (j0 + t) * bk;
    float m0 = MPMRF_NEG_INF, m1 = MPMRF_NEG_INF;
    float ks0 = 1.f, ks1 = 1.f;
    // the tile's key scales: B3's page scale, B7's key-row scales
    const float* kcol = pscale + (t & 1) * bk;
    if constexpr (kCodes) {
      const float ks = kcol[0];
      ks0 = __fmul_rn(ks, k_factor0);
      ks1 = __fmul_rn(ks, k_factor1);
    }
    const bool fast =
        rows_ok && uniform && positive_finite(ks0) && positive_finite(ks1);
    const bool masked = kbase + bk - 1 > wmin;
    // the per-row rescale on a tile wholly visible to the warp's rows
    const bool plain = fast && !masked;
    int rm0[ROWS], rm1[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) rm0[k] = rm1[k] = INT_MIN;
    // One 8-key fragment into the rows' maxima: f0 / f1 the two planes'
    // accumulators (c0, c1: row 0, keys col, col + 1; c2, c3: row 1). A
    // plain tile takes an int max, three-way (Hopper's DPX); otherwise
    // each pair is masked, and rescaled unless `fast`.
    const auto fold = [&](const int* f0, const int* f1, int col) {
      int x1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x1[i] = K == Kind::kFull ? f0[i] * shift_mul + f1[i] : f1[i];
      if (plain) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rm0[h] = __vimax3_s32(rm0[h], f0[2 * h], f0[2 * h + 1]);
          rm1[h] = __vimax3_s32(rm1[h], x1[2 * h], x1[2 * h + 1]);
        }
        return;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = i >> 1, c = col + 2 * tig + (i & 1);
        if (kbase + c > pos[k]) continue;  // masked (dead rows too)
        if (fast) {
          rm0[k] = max(rm0[k], f0[i]);
          rm1[k] = max(rm1[k], x1[i]);
        } else {  // the per-pair rescale
          float c0 = ks0, c1 = ks1;
          if constexpr (K == Kind::kPrefill) {
            c0 = __fmul_rn(kcol[c], k_factor0);
            c1 = __fmul_rn(kcol[c], k_factor1);
          }
          m0 = fmaxf(m0, rescale(f0[i], qsf[k], c0));
          m1 = fmaxf(m1, rescale(x1[i], qsf[k], c1));
        }
      }
    };
    const uint8_t* p1 = p0 + plane_tile;
    if constexpr (kGroup) {
      // wholly above the warpgroup's rows (a uniform branch: wgmma is
      // issued by its four warps together)
      if (kbase <= gmx) {
        const uint32_t qaddr = flash::smem_u32(qs_tile + (warp >> 2) * 64 * D);
        for (int n0 = 0; n0 < bk; n0 += 64) {
          int d0[32], d1[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) d0[i] = d1[i] = 0;
          const uint32_t a0 = flash::smem_u32(p0 + n0 * D);
          const uint32_t a1 = flash::smem_u32(p1 + n0 * D);
          pin<32>(d0);
          pin<32>(d1);
          flash::wg_fence();
          // two commit groups, so that a plain tile's msb maxima are
          // taken while the second product runs
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            wgmma_s8(d0, flash::desc(qaddr + kk * 32),
                     flash::desc(a0 + kk * 32), kk);
          flash::wg_commit();
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            wgmma_s8(d1, flash::desc(qaddr + kk * 32),
                     flash::desc(a1 + kk * 32), kk);
          // (the waits are warpgroup-wide, so every warp makes both)
          flash::wg_commit();
          wg_wait1();
          pin<32>(d0);
          if (plain) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                rm0[h] = __vimax3_s32(rm0[h], d0[4 * j + 2 * h],
                                      d0[4 * j + 2 * h + 1]);
          }
          flash::wg_wait();
          pin<32>(d1);
          if (plain) {
            if constexpr (K == Kind::kFull) {  // acc1 = acc0·2^shift + accr
#pragma unroll
              for (int i = 0; i < 32; ++i) d1[i] += d0[i] * shift_mul;
            }
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                rm1[h] = __vimax3_s32(rm1[h], d1[4 * j + 2 * h],
                                      d1[4 * j + 2 * h + 1]);
          } else if (kbase + n0 <= wmx) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              fold(d0 + 4 * j, d1 + 4 * j, n0 + 8 * j);
          }
        }
      }
    } else if (kbase <= wmx) {  // some row of the warp sees the tile
      for (int gk = 0; 16 * gk < bk; ++gk) {
        // a key block of 8 mod 16 keys ends in a group of 8: its second
        // n-tile repeats the first and is not folded
        const bool half = 16 * gk + 16 > bk;
        int acc[2][2][4];  // [n-tile][plane]
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int pl = 0; pl < 2; ++pl)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[nt][pl][i] = 0;
        const int rr = 16 * gk + (lane & 7) + (half ? 0 : (lane >> 4) << 3);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int cc = D >= 32 ? 2 * kk + ((lane >> 3) & 1) : 0;
          uint32_t bm[4], bh[4];
          flash::ldsm_x4(flash::smem_u32(p0 + off<D>(bk, rr, cc)), bm);
          flash::ldsm_x4(flash::smem_u32(p1 + off<D>(bk, rr, cc)), bh);
          if constexpr (D >= 32) {
            mma_k32(acc[0][0], qa[kk], bm[0], bm[1]);
            mma_k32(acc[1][0], qa[kk], bm[2], bm[3]);
            mma_k32(acc[0][1], qa[kk], bh[0], bh[1]);
            mma_k32(acc[1][1], qa[kk], bh[2], bh[3]);
          } else {
            mma_k16(acc[0][0], qa[kk], bm[0]);
            mma_k16(acc[1][0], qa[kk], bm[2]);
            mma_k16(acc[0][1], qa[kk], bh[0]);
            mma_k16(acc[1][1], qa[kk], bh[2]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2 - half; ++nt)
          fold(acc[nt][0], acc[nt][1], 16 * gk + 8 * nt);
      }
    }
    // each row's largest valid acc, rescaled once
    if (fast) rescale_rows<ROWS>(rm0, rm1, qsf, ks0, ks1, m0, m1);
    warp_max_to(m0, m1, red + (t & 1) * MAX_WARPS * 2 + 2 * warp);
  };

  // --- the key loop: one __syncthreads per tile ---------------------------------
  if constexpr (kCodes) {
    issue(0);
    issue(1);
    flash::cp_wait<1>();
    __syncthreads();  // tile 0's codes and the query stage are in
    load_q();
    int differs = convert(0);
    for (int t = 0; t < n; ++t) {
      flash::cp_wait<0>();
      // tile t's planes, tile t + 1's codes are in
      const bool uniform = !__syncthreads_or(differs);
      if (t > 0) flush(t - 1);
      issue(t + 2);     // into tile t's code stage, converted already
      differs = t + 1 < n ? convert(t + 1) : 0;
      compute(t, planes + (t & 1) * 2 * plane_tile, uniform);
    }
  } else {
    issue(0);         // with the query stage
    issue(1);
    for (int t = 0; t < n; ++t) {
      flash::cp_wait<1>();
      flash::fence_async_smem();
      __syncthreads();  // tile t is in; tile t − 1's stage is free
      if (t == 0) {
        load_q();
        __syncthreads();  // the query stage may be ring stage 2
      } else {
        flush(t - 1);
      }
      issue(t + 2);
      compute(t, ring + (t % PLANE_STAGES) * 2 * plane_tile, true);
    }
  }
  __syncthreads();
  flush(n - 1);
}

// B1/B5's S: as many runs per row as the card holds blocks of `kernel`
// at once (a single wave: a row's pages stream through its runs, so a
// second wave would only add its start-up), at most one per key block.
// The blocks per SM are asked once per device and shared-memory size.
template <class Kernel>
inline int decode_runs(Kernel kernel, int threads, size_t smem, int bh,
                       int n_kb) {
  static int per_sm[64];
  static size_t asked[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int n = 1;
  if (dev >= 0 && dev < 64 && asked[dev] == smem && per_sm[dev] > 0) {
    n = per_sm[dev];
  } else {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
    n = max(1, n);
    if (dev >= 0 && dev < 64) {
      per_sm[dev] = n;
      asked[dev] = smem;
    }
  }
  return max(1, min(n_kb, n * sm_count() / bh));
}

// B1/B5: byte offset of 16-byte chunk x of key row r in a ring stage (a
// page of bk rows of 2·D bytes); the chunks are XOR-swizzled by the row,
// so the eight rows an ldmatrix reads at one chunk fall in eight bank
// groups (at d ≥ 64).
template <int D>
__device__ __forceinline__ int code_off(int r, int x) {
  constexpr int SW = D / 8 - 1 < 7 ? D / 8 - 1 : 7;
  return r * 2 * D + 16 * (x ^ (r & SW));
}

// The decode kind (B1: kPaged, B5: contiguous), one block of
// DECODE_WARPS warps per (run, bh row); see the note at the top.
template <int D, bool kPaged>
__device__ __forceinline__ void decode_block(const Args& a) {
  constexpr int KS = D >= 32 ? D / 32 : 1;  // k-steps of 32 bytes over d
  constexpr int P = D / 16;                 // 16-code pieces per key row
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int s = blockIdx.x, b = blockIdx.y;
  const int G = a.n_q, bk = a.bk, n_kb = a.n_kb;
  const size_t out0 = (size_t)b * n_kb;
  uint8_t* ring = reinterpret_cast<uint8_t*>(flash::smem_base());
  const int stage = decode_stage(D, bk);
  float* red = reinterpret_cast<float*>(ring + DECODE_STAGES * stage);
  int* ids = reinterpret_cast<int*>(red + 2 * MAX_WARPS * 2);  // B1: [n_kb]

  // --- what needs nothing else, loaded together: the row's length, (B1)
  // its block table, the G rows as B fragments (rows ≥ G zero, narrowed
  // once per block) and this thread's accumulator rows 8·nt + 2·tig + h:
  // their scales and liveness
  const int len = a.len[b];
  if constexpr (kPaged) {
    for (int j = tid; j < n_kb; j += nthr) ids[j] = a.table[out0 + j];
  }
  const bool two = G > 8;  // a second n8 tile
  const int d = a.d;       // columns d .. D − 1: zero (see the top)
  const int32_t* q = static_cast<const int32_t*>(a.q_plane) + (size_t)b * G * d;
  uint32_t qb[2][KS][2];
  float qsf[4];
  bool live[4];
  bool rows_ok = true;
  const float q_factor = (float)(1 << (16 - a.hi));
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int row = 8 * nt + g;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int col = 32 * kk + 4 * tig;
      const int32_t* p = q + row * d + col;
      qb[nt][kk][0] = row < G && col < d
                          ? narrow4(*reinterpret_cast<const int4*>(p))
                          : 0u;
      qb[nt][kk][1] = row < G && D >= 32 && col + 16 < d
                          ? narrow4(*reinterpret_cast<const int4*>(p + 16))
                          : 0u;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 8 * nt + 2 * tig + h;
      live[2 * nt + h] = r < G;
      qsf[2 * nt + h] =
          r < G ? __fmul_rn(a.q_scale[(size_t)b * G + r], q_factor) : 0.f;
      rows_ok &= r >= G || positive_finite(qsf[2 * nt + h]);
    }
  }
  if constexpr (kPaged) __syncthreads();  // the table is in

  // --- the row's live key blocks, this block's run of them --------------------
  const int T = len <= 0 ? 0 : min(n_kb, (len - 1) / bk + 1);
  for (int j = T + s + tid * a.runs; j < n_kb; j += nthr * a.runs) {
    a.s0[out0 + j] = MPMRF_NEG_INF;  // past the length
    a.s1[out0 + j] = MPMRF_NEG_INF;
  }
  int j0, j1;
  key_run(T, a.runs, s, j0, j1);
  const int n = j1 - j0;
  if (n <= 0) return;

  // page t of the run into ring stage t mod DECODE_STAGES: each thread
  // copies the two chunks of the 16-code pieces it will derive, tid 0
  // the page's scale
  const auto issue = [&](int t) {
    if (t < n) {
      const int blk = kPaged ? ids[j0 + t] : b * n_kb + j0 + t;
      const uint8_t* src =
          static_cast<const uint8_t*>(a.k0) + (size_t)blk * bk * 2 * d;
      uint8_t* dst = ring + (t % DECODE_STAGES) * stage;
      if (d == D) {  // the page's codes are one contiguous run
        for (int i = tid; i < bk * P; i += nthr) {
          const int r = i / P, c = i % P;
          flash::cp_async16(flash::smem_u32(dst + code_off<D>(r, 2 * c)),
                            src + 32 * i, true);
          flash::cp_async16(flash::smem_u32(dst + code_off<D>(r, 2 * c + 1)),
                            src + 32 * i + 16, true);
        }
      } else {       // rows of 2·d bytes; a piece of padded columns: zeros
        for (int i = tid; i < bk * P; i += nthr) {
          const int r = i / P, c = i % P;
          const bool in = 16 * c < d;
          const uint8_t* piece = in ? src + r * 2 * d + 32 * c : src;
          flash::cp_async16(flash::smem_u32(dst + code_off<D>(r, 2 * c)),
                            piece, in);
          flash::cp_async16(flash::smem_u32(dst + code_off<D>(r, 2 * c + 1)),
                            in ? piece + 16 : src, in);
        }
      }
      if (tid == 0) cp_async4(flash::smem_u32(dst + bk * 2 * D), a.k_scale + blk);
    }
    flash::cp_commit();
  };

  // page t's codes → its msb and hi planes, in place: each thread the
  // pieces it copied (its own cp.async copies are complete once it has
  // waited for them, so no barrier comes between)
  const LaneShift msb_of(a.msb_shift), hi_of(a.hi_shift);
  const auto convert = [&](int t) {
    uint8_t* tile = ring + (t % DECODE_STAGES) * stage;
    for (int i = tid; i < bk * P; i += nthr) {
      const int r = i / P, c = i % P;
      uint4* x = reinterpret_cast<uint4*>(tile + code_off<D>(r, 2 * c));
      uint4* y = reinterpret_cast<uint4*>(tile + code_off<D>(r, 2 * c + 1));
      derive16(*reinterpret_cast<const int4*>(x),
               *reinterpret_cast<const int4*>(y), msb_of, hi_of, *x, *y);
    }
  };

  const float k_factor0 = (float)(1 << (16 - a.lo));
  const float k_factor1 = q_factor;
  // page t: this warp's m16 tiles of it into the warp's (s0, s1) maxima
  const auto compute = [&](int t) {
    const uint8_t* tile = ring + (t % DECODE_STAGES) * stage;
    const int nvalid = min(bk, len - (j0 + t) * bk);  // keys below the length
    const float ks = *reinterpret_cast<const float*>(tile + bk * 2 * D);
    const float ks0 = __fmul_rn(ks, k_factor0), ks1 = __fmul_rn(ks, k_factor1);
    const bool fast = rows_ok && positive_finite(ks0) && positive_finite(ks1);
    float m0 = MPMRF_NEG_INF, m1 = MPMRF_NEG_INF;
    int rm0[4], rm1[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) rm0[k] = rm1[k] = INT_MIN;
    for (int mt = warp; 16 * mt < bk; mt += DECODE_WARPS) {
      int acc[2][2][4];  // [n-tile][plane]
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int pl = 0; pl < 2; ++pl)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][pl][i] = 0;
      // lanes 8i .. 8i + 7 address matrix i: keys 0–7 / 8–15 of the tile
      // (a key block of 8 mod 16 keys repeats its last key: masked)
      const int row = min(16 * mt + (lane & 7) + ((lane >> 3) & 1) * 8, bk - 1);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t am[4], ah[4];
        if constexpr (D >= 32) {  // msb, then hi: bytes 0–15 and 16–31
          const int x = 4 * kk + 2 * (lane >> 4);
          flash::ldsm_x4(flash::smem_u32(tile + code_off<D>(row, x)), am);
          flash::ldsm_x4(flash::smem_u32(tile + code_off<D>(row, x + 1)), ah);
        } else {                  // d 16: msb (chunk 0) and hi (chunk 1)
          uint32_t r[4];
          flash::ldsm_x4(flash::smem_u32(tile + code_off<D>(row, lane >> 4)),
                         r);
          am[0] = r[0], am[1] = r[1], ah[0] = r[2], ah[1] = r[3];
          am[2] = am[3] = ah[2] = ah[3] = 0u;
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          if (nt == 1 && !two) break;
          if constexpr (D >= 32) {
            mma_k32(acc[nt][0], am, qb[nt][kk][0], qb[nt][kk][1]);
            mma_k32(acc[nt][1], ah, qb[nt][kk][0], qb[nt][kk][1]);
          } else {
            mma_k16(acc[nt][0], am, qb[nt][kk][0]);
            mma_k16(acc[nt][1], ah, qb[nt][kk][0]);
          }
        }
      }
      // acc[nt][pl][2·e + h]: key 16·mt + g + 8·e, row 8·nt + 2·tig + h
      const bool whole = 16 * mt + 16 <= nvalid;  // every key of it valid
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 2 * nt + h;
          if (!live[k]) continue;  // a padding row
          const int* f0 = acc[nt][0];
          const int* f1 = acc[nt][1];
          if (fast && whole) {  // an int max, three-way (Hopper's DPX)
            rm0[k] = __vimax3_s32(rm0[k], f0[h], f0[2 + h]);
            rm1[k] = __vimax3_s32(rm1[k], f1[h], f1[2 + h]);
            continue;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (16 * mt + g + 8 * e >= nvalid) continue;  // masked
            if (fast) {
              rm0[k] = max(rm0[k], f0[2 * e + h]);
              rm1[k] = max(rm1[k], f1[2 * e + h]);
            } else {  // the per-pair rescale
              m0 = fmaxf(m0, rescale(f0[2 * e + h], qsf[k], ks0));
              m1 = fmaxf(m1, rescale(f1[2 * e + h], qsf[k], ks1));
            }
          }
        }
      }
    }
    if (fast) rescale_rows<4>(rm0, rm1, qsf, ks0, ks1, m0, m1);
    warp_max_to(m0, m1, red + (t & 1) * MAX_WARPS * 2 + 2 * warp);
  };
  const auto flush = [&](int t) {
    flush_warps(red + (t & 1) * MAX_WARPS * 2, DECODE_WARPS,
                a.s0 + out0 + j0 + t, a.s1 + out0 + j0 + t);
  };

  // --- the page loop: one __syncthreads per page ----------------------------
  // While page t is multiplied, pages t + 1 and t + 2 are in flight; page
  // t + 1 is then derived, so its planes are ready at the next barrier.
#pragma unroll
  for (int t = 0; t < DECODE_STAGES - 1; ++t) issue(t);
  flash::cp_wait<DECODE_STAGES - 2>();  // this thread's pieces of page 0
  convert(0);
  for (int t = 0; t < n; ++t) {
    __syncthreads();  // page t's planes are in; page t − 1's stage is free
    if (t > 0) flush(t - 1);
    issue(t + DECODE_STAGES - 1);
    compute(t);
    flash::cp_wait<DECODE_STAGES - 2>();  // this thread's pieces of t + 1
    if (t + 1 < n) convert(t + 1);
  }
  __syncthreads();
  flush(n - 1);
}

// Launch `kernel` (filter_block's instantiation for head dim d on the
// product path `mt`, or decode_block's) over `bh` rows of `n_qb` query
// blocks (the decode kind: one row of G, n_qb 1).
template <class Kernel>
inline int launch(Kernel kernel, size_t (&given)[64], Kind kind, int mt,
                  int d, int bh, int n_qb, Args a, cudaStream_t stream) {
  const bool decode = kind == Kind::kPagedDecode || kind == Kind::kDecode;
  const size_t smem = smem_bytes(kind, mt, d, a.bq, a.bk, a.n_kb);
  flash::allow_smem(kernel, smem, given);
  const int threads = decode ? 32 * DECODE_WARPS : a.bq / 16 * 32;
  a.runs = decode ? decode_runs(kernel, threads, smem, bh, a.n_kb)
                  : filter_runs(bh * n_qb, a.n_kb, sm_count());
  const dim3 grid = kind == Kind::kFull ? dim3(a.runs, bh, n_qb)
                                        : dim3(a.runs * n_qb, bh);
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace filt
