// MP-MRF decode kernels for Hopper (sm_90a), paged and contiguous, with
// a plain C interface for ctypes.
//
// B1 mpmrf_paged_filter_scores — replaces the TPU kernel
//   repro/kernels/mpmrf_decode.py::mpmrf_paged_filter_scores
//   (_paged_filter_kernel): both filter rounds' block maxima of the G
//   folded query rows of each bh row against physical page bt[b, j]'s
//   int16 codes, keys below the cache length, for every logical block j.
//   Bound on the H100 by bytes: each live page's codes are read once
//   (16 KB at bk 64, d 128) and G·bk·d·4 int8 operations a page are
//   nothing beside them; a block wholly past the length is NEG_INF and
//   never read. The design is the decode kind of the integer filter
//   engine (filter_engine.cuh, decode_block): one block of four warps
//   per run of a row's live pages, one wave of four blocks per SM (where
//   one block per page left half the launch empty and ran each page's
//   load, derivation and reductions in series), the pages streamed
//   through a three-stage cp.async ring with two in flight while one is
//   multiplied, the msb and hi planes derived in place one page ahead,
//   the products on the int8 tensor cores (mma.sync s8, keys on M, the G
//   rows as n8 fragments held for the block's life: exact int32 sums)
//   and each row's largest acc rescaled once in the reference's
//   association, so the scores equal the reference and the plain version
//   bit for bit at every 0 ≤ lo < hi ≤ 8 (the products take the hi plane,
//   which always fits int8, and not the remainder plane, which reaches
//   255 at lo 0, hi 8).
//
// B5 mpmrf_decode_filter_scores — replaces
//   repro/kernels/mpmrf_decode.py::mpmrf_decode_filter_scores
//   (_decode_filter_kernel): B1 over a contiguous [bh, n_k, d] code
//   cache with per-block scales [bh, n_kb]. That cache is a page pool
//   whose table is implicit (block j of row b is block b·n_kb + j, its
//   scale the same entry), so B5 is B1's kernel body instantiated for
//   the contiguous layout (block_of<false>): the same bytes bound, the
//   same early exit, and scores equal to B1's on the same rows, bit for
//   bit. A length past n_k (an idle slot's max_len + 1 sentinel) masks
//   nothing.
//
// B2 paged_decode_gather_attention — replaces
//   repro/kernels/mpmrf_decode.py::paged_decode_gather_attention
//   (_paged_gather_kernel): attention of the G folded query rows of each
//   bh row over its survivor pages bt[b, idx[b, s]], keys below the
//   cache length, with the reference's rules (scores ≤ NEG_INF/2 give
//   p = 0; the output is acc / max(l, 1e-30), so a row with no live key
//   yields 0).
//
//   Bound by bytes (the survivor pages of K and V; G·bk·d products per
//   slot are nothing beside them), but at 64 bh rows one block per row
//   filled half the SMs and walked its slots in series. So the slots are
//   split, flash-decoding style: a grid (splits, bh) in which each block
//   takes a fixed run of consecutive slots (the wrapper's rule,
//   kernels/mpmrf_decode.py::decode_split_slots: 4 slots a split, 256
//   blocks on the serving path) and streams its kept slots (valid, with
//   keys below the length; in table order) through the cp.async ring of
//   the tile engine of flash_common.cuh. The G rows are the live rows of
//   one warpgroup of 64 on the wgmma path (heads of 64 or 128 after
//   padding; the other rows are dead and cost only tensor-core time),
//   else of one warp of 16 on mma.sync; a head dim below the
//   instantiation's is zero-padded; P·V runs as bf16 hi + lo. Each block
//   writes its f32 partials (m, l and the unnormalised acc of its G
//   rows) to a workspace the wrapper allocates; a split that keeps
//   nothing leaves m = NEG_INF, l = 0. The last block of the row to
//   arrive on the row's counter (which it sets back to 0) merges the
//   splits in split order — never in arrival order, so the result is the
//   same from run to run and B2 = B6 on the same rows — with weights
//   exp(m_i − M), and writes acc / max(l, 1e-30) in bf16: an empty split
//   weighs 0 beside a live one, and a row with no live key comes out 0.
//   One launch per call. The split depends on the budget only, not on
//   bh, so a row's output never depends on the batch it was decoded in.
//
// B6 decode_gather_attention — replaces
//   repro/kernels/mpmrf_decode.py::decode_gather_attention
//   (_decode_gather_kernel): B2 with idx[b, s] naming block
//   b·n_kb + idx[b, s] of the contiguous K/V cache — the same kernel
//   body, the same bytes bound, outputs equal to B2's on the same rows.
#include <type_traits>

#include "filter_engine.cuh"

// One block of the decode kind of the filter engine: a run of one bh
// row's live key blocks (filter_engine.cuh, decode_block).
template <int D, bool kPaged>
__global__ void __launch_bounds__(32 * filt::DECODE_WARPS)
    decode_filter_kernel(filt::Args a) {
  filt::decode_block<D, kPaged>(a);
}

// The G folded rows of a decode step padded to the block's rows: a live
// row sits at position len − 1 (it sees the keys below the cache
// length), a padding row is dead.
struct DecodeRows {
  int g, len;
  __device__ __forceinline__ int operator()(int r) const {
    return r < g ? len - 1 : -1;
  }
};

// Rows of a decode block: one warpgroup of 64 on the wgmma path (heads
// of 64 or 128 columns after padding), else one warp of 16.
template <int D>
__host__ __device__ constexpr int decode_rows() {
  return D >= 64 ? 64 : 16;
}

// One split (blockIdx.x) of one bh row's survivor slots. Its partials,
// row i: acc at part_acc[((b·splits + sp)·g + i)·d ..], (m, l) at
// part_ml[2·((b·splits + sp)·g + i) ..]. The last block of the row to
// finish (count[b], reset to 0 after) merges the row's splits.
template <int D, bool kPaged>
__global__ void __launch_bounds__(D >= 64 ? 128 : 32) decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ val,
    const int32_t* __restrict__ block_table,
    const int32_t* __restrict__ cache_len, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int* __restrict__ count,
    __nv_bfloat16* __restrict__ out, int g, int d, int bk, int budget,
    int mb, int split_slots, float sm_scale) {
  constexpr int C = D / 8, ROWS = decode_rows<D>();
  using Rows = std::conditional_t<(D >= 64), flash::Group<D>, flash::Warp<D>>;
  const int sp = blockIdx.x, splits = gridDim.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int len = cache_len[b];
  __nv_bfloat16* smem = flash::smem_base();
  float* ring = reinterpret_cast<float*>(smem + ROWS * D);
  int* kept_kb = reinterpret_cast<int*>(
      smem + (ROWS + 2 * flash::STAGES * flash::KT) * D);
  int* kept_src = kept_kb + split_slots;
  int* info = kept_src + split_slots;  // [0] kept count, [1] last block

  // the G query rows, padding rows and columns zero (joins the first
  // tile's copy group)
  const __nv_bfloat16* qrow = q + (size_t)b * g * d;
  for (int i = tid; i < ROWS * C; i += blockDim.x) {
    const int r = i / C, c = i % C;
    const bool in = r < g && c * 8 < d;
    flash::cp_async16(flash::smem_u32(smem + flash::swz<D>(ROWS, r, c) * 8),
                      in ? qrow + r * d + c * 8 : qrow, in);
  }
  // this split's kept slots (valid, with keys below the length), in
  // table order
  if (tid < 32) {
    int n = 0;
    for (int j0 = 0; j0 < split_slots; j0 += 32) {
      const int j = j0 + lane, s = sp * split_slots + j;
      int kb = 0;
      bool keep = false;
      if (j < split_slots && s < budget) {
        kb = idx[(size_t)b * budget + s];
        keep = val[(size_t)b * budget + s] != 0 && kb * bk < len;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int at = n + __popc(mask & ((1u << lane) - 1));
        kept_kb[at] = kb;
        kept_src[at] = mpmrf::block_of<kPaged>(block_table, b, kb, mb);
      }
      n += __popc(mask);
    }
    if (lane == 0) info[0] = n;
  }
  __syncthreads();

  const int per = (bk + flash::KT - 1) / flash::KT;  // ring tiles per page
  const auto tiles = [kept_kb, kept_src, bk, per](int t, int& src,
                                                  int& kpos0, int& nv) {
    const int s = t / per, c = t % per;
    src = kept_src[s] * bk + c * flash::KT;
    kpos0 = kept_kb[s] * bk + c * flash::KT;
    nv = min(flash::KT, bk - c * flash::KT);
  };
  Rows rows;
  flash::key_loop<D>(rows, k_pages, v_pages, smem, ROWS, DecodeRows{g, len},
                     len - 1, true, sm_scale, info[0] * per, tiles, d);

  // this split's partials of the live rows
  const int qd = lane & 3;
  const size_t base = ((size_t)b * splits + sp) * g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = rows.l[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = (tid >> 5) * 16 + (lane >> 2) + 8 * r;
    if (row >= g) continue;
    float* acc = part_acc + (base + row) * d;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const int col = 8 * t + 2 * qd;
      if (col < d)
        *reinterpret_cast<float2*>(acc + col) =
            make_float2(rows.o[4 * t + 2 * r], rows.o[4 * t + 2 * r + 1]);
    }
    if (qd == 0)
      *reinterpret_cast<float2*>(part_ml + 2 * (base + row)) =
          make_float2(rows.m[r], l);
  }

  // the row's last block merges its splits, in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) info[1] = atomicAdd(count + b, 1) == splits - 1;
  __syncthreads();
  if (!info[1]) return;
  __threadfence();
  // (m, l) of every split into the free ring, then per row the weights
  // exp(m_i − M) in place of m_i and the sum of w_i·l_i after them
  const size_t first = (size_t)b * splits * g;  // row b, split 0, row 0
  for (int i = tid; i < g * splits; i += blockDim.x) {
    const int row = i / splits, s = i % splits;
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(
        part_ml + 2 * (first + (size_t)s * g + row)));
    ring[2 * i] = ml.x;
    ring[2 * i + 1] = ml.y;
  }
  __syncthreads();
  float* den = ring + 2 * g * splits;
  for (int row = tid; row < g; row += blockDim.x) {
    float* w = ring + 2 * row * splits;
    float big = MPMRF_NEG_INF;
    for (int s = 0; s < splits; ++s) big = fmaxf(big, w[2 * s]);
    float l = 0.f;
    for (int s = 0; s < splits; ++s) {
      w[2 * s] = expf(w[2 * s] - big);
      l += w[2 * s] * w[2 * s + 1];
    }
    den[row] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < g * d; i += blockDim.x) {
    const int row = i / d, col = i % d;
    const float* w = ring + 2 * row * splits;
    const float* acc = part_acc + (first + row) * d + col;
    float a = 0.f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s)
      a += w[2 * s] * __ldcg(acc + (size_t)s * g * d);
    out[((size_t)b * g + row) * d + col] = __float2bfloat16(a / den[row]);
  }
  if (tid == 0) count[b] = 0;
}

template <int D, bool kPaged>
static int launch_filter(const filt::Args& a, int bh, cudaStream_t stream) {
  static size_t given[64];
  return filt::launch(decode_filter_kernel<D, kPaged>, given,
                      kPaged ? filt::Kind::kPagedDecode : filt::Kind::kDecode,
                      1, D, bh, 1, a, stream);
}

// mb: blocks per bh row (table width, or n_kb of the contiguous cache);
// msb_shift / hi_shift: the planes' packed shifts of the codes' high
// bytes (kernels/mpmrf_decode.py::plane_shifts)
template <bool kPaged>
static int filter_scores(const void* q_plane, const void* q_scale,
                         const void* codes, const void* blk_scale,
                         const void* block_table, const void* cache_len,
                         void* s0, void* s1, int bh, int g, int d, int bk,
                         int mb, int lo, int hi, int msb_shift, int hi_shift,
                         void* stream) {
  cudaGetLastError();
  if (g < 1 || g > 16 || bk < 8 || bk > 128 || bk % 8 != 0)
    return (int)cudaErrorInvalidValue;
  filt::Args a{};
  a.q_plane = q_plane;
  a.q_scale = (const float*)q_scale;
  a.len = (const int32_t*)cache_len;
  a.k0 = codes;
  a.k_scale = (const float*)blk_scale;
  a.table = (const int32_t*)block_table;
  a.s0 = (float*)s0;
  a.s1 = (float*)s1;
  a.n_q = g;
  a.bk = bk;
  a.n_kb = mb;
  a.lo = lo;
  a.hi = hi;
  a.msb_shift = msb_shift;
  a.hi_shift = hi_shift;
  a.d = d;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mpmrf::kernel_head_dim(d)) {
    case 16: return launch_filter<16, kPaged>(a, bh, st);
    case 32: return launch_filter<32, kPaged>(a, bh, st);
    case 64: return launch_filter<64, kPaged>(a, bh, st);
    case 128: return launch_filter<128, kPaged>(a, bh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D, bool kPaged>
static void launch_split(dim3 grid, cudaStream_t stream, const void* q,
                         const void* k, const void* v, const void* idx,
                         const void* val, const void* block_table,
                         const void* cache_len, float* part_acc,
                         float* part_ml, int* count, void* out, int g, int d,
                         int bk, int budget, int mb, int split_slots,
                         float sm_scale) {
  // the engine's stage and ring, then the kept lists and two flags
  const size_t smem = flash::smem_bytes(D, decode_rows<D>()) +
                      sizeof(int) * (2 * (size_t)split_slots + 2);
  static size_t given[64];
  flash::allow_smem(decode_split_kernel<D, kPaged>, smem, given);
  decode_split_kernel<D, kPaged>
      <<<grid, 2 * decode_rows<D>(), smem, stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
          (const __nv_bfloat16*)v, (const int32_t*)idx, (const int32_t*)val,
          (const int32_t*)block_table, (const int32_t*)cache_len, part_acc,
          part_ml, count, (__nv_bfloat16*)out, g, d, bk, budget, mb,
          split_slots, sm_scale);
}

// work: the wrapper's f32 workspace of bh·splits·g·(d + 2) floats, the
// acc partials then the (m, l) pairs, splits = ⌈budget / split_slots⌉
// (at most 32: the merge keeps 2·g·splits + g floats in the ring);
// count: bh int32 zeros, left zero by every call
template <bool kPaged>
static int gather_attention(const void* q, const void* k, const void* v,
                            const void* idx, const void* val,
                            const void* block_table, const void* cache_len,
                            void* out, void* work, void* count, int bh,
                            int g, int d, int bk, int budget, int mb,
                            int split_slots, float sm_scale, void* stream) {
  cudaGetLastError();
  const int splits =
      budget > split_slots ? (budget + split_slots - 1) / split_slots : 1;
  const int dp = mpmrf::kernel_head_dim(d);
  if (g < 1 || g > 16 || dp == 0 || split_slots < 1 || splits > 32)
    return (int)cudaErrorInvalidValue;
  float* part_acc = (float*)work;
  float* part_ml = part_acc + (size_t)bh * splits * g * d;
  const dim3 grid(splits, bh);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dp) {
    case 16:
      launch_split<16, kPaged>(grid, st, q, k, v, idx, val, block_table,
                               cache_len, part_acc, part_ml, (int*)count, out,
                               g, d, bk, budget, mb, split_slots, sm_scale);
      break;
    case 32:
      launch_split<32, kPaged>(grid, st, q, k, v, idx, val, block_table,
                               cache_len, part_acc, part_ml, (int*)count, out,
                               g, d, bk, budget, mb, split_slots, sm_scale);
      break;
    case 64:
      launch_split<64, kPaged>(grid, st, q, k, v, idx, val, block_table,
                               cache_len, part_acc, part_ml, (int*)count, out,
                               g, d, bk, budget, mb, split_slots, sm_scale);
      break;
    default:
      launch_split<128, kPaged>(grid, st, q, k, v, idx, val, block_table,
                                cache_len, part_acc, part_ml, (int*)count,
                                out, g, d, bk, budget, mb, split_slots,
                                sm_scale);
  }
  return (int)cudaGetLastError();
}

extern "C" int mpmrf_paged_filter_scores(
    const void* q_plane, const void* q_scale, const void* codes,
    const void* page_scale, const void* block_table, const void* cache_len,
    void* s0, void* s1, int bh, int g, int d, int bk, int mb, int lo, int hi,
    int msb_shift, int hi_shift, void* stream) {
  return filter_scores<true>(q_plane, q_scale, codes, page_scale,
                             block_table, cache_len, s0, s1, bh, g, d, bk, mb,
                             lo, hi, msb_shift, hi_shift, stream);
}

extern "C" int mpmrf_decode_filter_scores(
    const void* q_plane, const void* q_scale, const void* codes,
    const void* block_scale, const void* cache_len, void* s0, void* s1,
    int bh, int g, int d, int bk, int n_kb, int lo, int hi, int msb_shift,
    int hi_shift, void* stream) {
  return filter_scores<false>(q_plane, q_scale, codes, block_scale, nullptr,
                              cache_len, s0, s1, bh, g, d, bk, n_kb, lo, hi,
                              msb_shift, hi_shift, stream);
}

extern "C" int paged_decode_gather_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* idx,
    const void* val, const void* block_table, const void* cache_len,
    void* out, void* work, void* count, int bh, int g, int d, int bk,
    int budget, int mb, int split_slots, float sm_scale, void* stream) {
  return gather_attention<true>(q, k_pages, v_pages, idx, val, block_table,
                                cache_len, out, work, count, bh, g, d, bk,
                                budget, mb, split_slots, sm_scale, stream);
}

extern "C" int decode_gather_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* idx,
    const void* val, const void* cache_len, void* out, void* work,
    void* count, int bh, int g, int d, int bk, int budget, int n_kb,
    int split_slots, float sm_scale, void* stream) {
  return gather_attention<false>(q, k_cache, v_cache, idx, val, nullptr,
                                 cache_len, out, work, count, bh, g, d, bk,
                                 budget, n_kb, split_slots, sm_scale, stream);
}
