// MP-MRF prefill kernels for Hopper (sm_90a), paged and contiguous,
// with a plain C interface for ctypes.
//
// B3 mpmrf_paged_prefill_filter_scores — replaces the TPU kernel
//   repro/kernels/mpmrf_prefill.py::mpmrf_paged_prefill_filter_scores
//   (_paged_prefill_filter_kernel): both filter rounds of a query block
//   of chunk rows against page bt[b, j]'s int16 codes, pooled over the
//   bq × bk tile under the per-row mask kpos ≤ qpos ∧ qpos < n_k, for
//   every logical block j. Bound on the H100 by integer operations: each
//   (row, visible key) pair costs two d-long int8 dots, while the bytes
//   are one read of the codes a query block can see. The design runs on
//   the integer filter engine (filter_engine.cuh): a block owns a query
//   block (or a run of its visible key blocks), stages its plane once as
//   int8, streams the pages through a cp.async ring, derives the msb and
//   hi planes from the codes once per block and multiplies on the int8
//   tensor cores (s8, int32 accumulate: exact; wgmma m64n64k32 on the
//   serving path's d 128 and 64-row blocks, mma.sync otherwise); the
//   rescale is applied once per row to the row's largest valid acc
//   (monotone for positive scales), so the scores equal the reference
//   and the plain version bit for bit. Blocks above every row of the
//   query block write NEG_INF without reading a page.
//
// B7 mpmrf_prefill_filter_scores — replaces
//   repro/kernels/mpmrf_prefill.py::mpmrf_prefill_filter_scores
//   (_prefill_filter_kernel): B3 over the contiguous [bh, n_k, d] codes
//   (block j of row b is block b·n_kb + j, block_of<false>), the same
//   engine body and bound. Its key scale is per row ([bh, n_k], the
//   caller's expansion of the resident per-block scales), staged with
//   the codes: a tile of one scale group takes B3's per-row rescale, a
//   tile across several groups the per-pair one, both in the
//   reference's association, so B7 equals B3 on the same rows.
//
// B4 paged_prefill_gather_attention — replaces
//   repro/kernels/mpmrf_prefill.py::paged_prefill_gather_attention
//   (_paged_prefill_gather_kernel): flash attention of each query block
//   of folded chunk rows over its survivor pages bt[b, idx[b, qb, s]],
//   each row under its own causal mask kpos ≤ q_positions[row], rows at
//   sentinel positions (≥ n_k) 0.
//
//   The work is a block-sparse attention (64 bh × 640 rows × ≤ 1024
//   survivor keys × d 128 on the serving path: ≈ 32 GFLOP with P·V
//   counted twice, tens of µs on the tensor cores), so the design is
//   B10's, on the tile engine of flash_common.cuh: blocks of 64 query
//   rows on the wgmma path (d ∈ {64, 128}, query blocks of 64 or 128, a
//   query block of 128 being two blocks reading one table row), one
//   block per query block on mma.sync otherwise. A block reads its rows'
//   positions (sentinels become dead rows at −1) and keeps, in table
//   order, the survivor slots that are valid and not wholly above its
//   largest live position (skipping the others is bit-identical); each
//   kept page enters the cp.async ring as ⌈bk/64⌉ tiles from its own
//   page base, at its logical key positions, so the next survivors are
//   in flight while one computes. P·V runs as bf16 hi + lo into one f32
//   accumulator. A block whose rows are all sentinels writes zeros and
//   exits. Bound by bytes on the serving path: q, the output and the
//   kept survivor pages, read once per block.
//
// B8 prefill_gather_attention — replaces
//   repro/kernels/mpmrf_prefill.py::prefill_gather_attention
//   (_prefill_gather_kernel): B4 with block b·n_kb + idx of the
//   contiguous K/V cache as the tile source (block_of<false>) — the same
//   kernel body, outputs equal to B4's on the same rows.
#include "filter_engine.cuh"

// MT: the product path (filt::product_path)
template <int D, int MT, bool kPaged>
__global__ void __launch_bounds__(32 * filt::MAX_WARPS)
    prefill_filter_kernel(filt::Args a) {
  filt::filter_block<D, MT,
                     kPaged ? filt::Kind::kPagedPrefill : filt::Kind::kPrefill>(
      a);
}

// Block row r's position, from q_positions; a sentinel row (position
// ≥ n_k) is dead (−1).
struct ChunkRows {
  const int32_t* pos;  // the block's first row
  int n_k;
  __device__ __forceinline__ int operator()(int r) const {
    const int p = pos[r];
    return p < n_k ? p : -1;
  }
};

template <int D, bool kPaged>
__global__ void __launch_bounds__(256) prefill_gather_kernel(
    const __nv_bfloat16* __restrict__ q, const int32_t* __restrict__ q_pos,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ val,
    const int32_t* __restrict__ block_table, __nv_bfloat16* __restrict__ out,
    int n_q, int d, int bq, int rows, int bk, int budget, int mb,
    float sm_scale) {
  // rows: this block's query rows (flash::block_rows), a part of the
  // query block of bq rows whose survivor table it reads; d: the
  // operands' head dim (≤ D, the instantiation)
  const int n_qb = n_q / bq, n_k = mb * bk;
  const int x = blockIdx.x, b = blockIdx.y;
  const int qb = x * rows / bq;
  const size_t row0 = (size_t)b * n_q + (size_t)x * rows;
  const ChunkRows pos{q_pos + row0, n_k};
  __nv_bfloat16* smem = flash::smem_base();
  // after the stage and the ring: the kept slots' logical blocks and
  // source blocks, their count and the block's largest live position
  int* kept_kb = reinterpret_cast<int*>(
      smem + (size_t)(rows + 2 * flash::STAGES * flash::KT) * D);
  int* kept_src = kept_kb + budget;
  int* info = kept_src + budget;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    int hi = -1;
    for (int r = lane; r < rows; r += 32) hi = max(hi, pos(r));
    for (int off = 16; off > 0; off >>= 1)
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    const int* idx_row = idx + ((size_t)b * n_qb + qb) * budget;
    const int* val_row = val + ((size_t)b * n_qb + qb) * budget;
    int n = 0;
    for (int s0 = 0; s0 < budget; s0 += 32) {
      const int s = s0 + lane;
      int kb = 0;
      bool keep = false;
      if (s < budget) {
        kb = idx_row[s];
        keep = val_row[s] != 0 && kb * bk <= hi;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int at = n + __popc(mask & ((1u << lane) - 1));
        kept_kb[at] = kb;
        kept_src[at] = mpmrf::block_of<kPaged>(block_table, b, kb, mb);
      }
      n += __popc(mask);
    }
    if (lane == 0) {
      info[0] = n;
      info[1] = hi;
    }
  }
  __syncthreads();
  const int q_last = info[1];
  if (q_last < 0) {  // every row a sentinel
    int4* o = reinterpret_cast<int4*>(out + row0 * d);
    for (int i = threadIdx.x; i < rows * d / 8; i += blockDim.x)
      o[i] = make_int4(0, 0, 0, 0);
    return;
  }
  flash::issue_q<D>(smem, q + row0 * d, rows, d);
  const int per = (bk + flash::KT - 1) / flash::KT;  // ring tiles per page
  const auto tiles = [kept_kb, kept_src, bk, per](int t, int& src,
                                                  int& kpos0, int& nv) {
    const int s = t / per, c = t % per;
    src = kept_src[s] * bk + c * flash::KT;
    kpos0 = kept_kb[s] * bk + c * flash::KT;
    nv = min(flash::KT, bk - c * flash::KT);
  };
  flash::run<D>(k_pages, v_pages, out + row0 * d, smem, rows, pos, q_last,
                true, sm_scale, info[0] * per, tiles, d);
}

template <int D, bool kPaged>
static int launch_filter(const filt::Args& a, int bh, int n_qb,
                         cudaStream_t stream) {
  static size_t given[2][64];
  const filt::Kind kind =
      kPaged ? filt::Kind::kPagedPrefill : filt::Kind::kPrefill;
  const int mt = filt::product_path(D, a.bq, a.bk);
  if constexpr (D == 128) {
    if (mt == 0)
      return filt::launch(prefill_filter_kernel<D, 0, kPaged>, given[0],
                          kind, mt, D, bh, n_qb, a, stream);
  }
  return filt::launch(prefill_filter_kernel<D, 1, kPaged>, given[1], kind, mt,
                      D, bh, n_qb, a, stream);
}

template <int D, bool kPaged>
static void launch_gather(dim3 grid, int threads, size_t smem,
                          cudaStream_t stream, const void* q,
                          const void* q_pos, const void* k, const void* v,
                          const void* idx, const void* val,
                          const void* block_table, void* out, int n_q, int d,
                          int bq, int rows, int bk, int budget, int mb,
                          float sm_scale) {
  static size_t given[64];
  flash::allow_smem(prefill_gather_kernel<D, kPaged>, smem, given);
  prefill_gather_kernel<D, kPaged><<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const int32_t*)q_pos,
      (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const int32_t*)idx,
      (const int32_t*)val, (const int32_t*)block_table, (__nv_bfloat16*)out,
      n_q, d, bq, rows, bk, budget, mb, sm_scale);
}

// mb: blocks per bh row (table width, or n_kb of the contiguous cache)
template <bool kPaged>
static int filter_scores(const void* q_plane, const void* q_scale,
                         const void* q_pos, const void* codes,
                         const void* k_scale, const void* block_table,
                         void* s0, void* s1, int bh, int n_q, int d, int bq,
                         int bk, int mb, int lo, int hi, int msb_shift,
                         int hi_shift, void* stream) {
  cudaGetLastError();
  filt::Args a{};
  a.q_plane = q_plane;
  a.q_scale = (const float*)q_scale;
  a.q_pos = (const int32_t*)q_pos;
  a.k0 = codes;
  a.k_scale = (const float*)k_scale;
  a.table = (const int32_t*)block_table;
  a.s0 = (float*)s0;
  a.s1 = (float*)s1;
  a.n_q = n_q;
  a.bq = bq;
  a.bk = bk;
  a.n_kb = mb;
  a.lo = lo;
  a.hi = hi;
  a.msb_shift = msb_shift;
  a.hi_shift = hi_shift;
  a.d = d;
  const int n_qb = n_q / bq;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mpmrf::kernel_head_dim(d)) {
    case 16: return launch_filter<16, kPaged>(a, bh, n_qb, st);
    case 32: return launch_filter<32, kPaged>(a, bh, n_qb, st);
    case 64: return launch_filter<64, kPaged>(a, bh, n_qb, st);
    case 128: return launch_filter<128, kPaged>(a, bh, n_qb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kPaged>
static int gather_attention(const void* q, const void* q_pos, const void* k,
                            const void* v, const void* idx, const void* val,
                            const void* block_table, void* out, int bh,
                            int n_q, int d, int bq, int bk, int budget, int mb,
                            float sm_scale, void* stream) {
  cudaGetLastError();
  const int D = mpmrf::kernel_head_dim(d);
  const int rows = flash::block_rows(D, bq);
  const dim3 grid(n_q / rows, bh);
  const int threads = 2 * rows;  // one warp per 16 query rows
  // the engine's stage and ring, then the kept lists, their count and
  // the block's largest live position
  const size_t smem =
      flash::smem_bytes(D, rows) + sizeof(int) * (2 * (size_t)budget + 2);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16:
      launch_gather<16, kPaged>(grid, threads, smem, st, q, q_pos, k, v, idx,
                                val, block_table, out, n_q, d, bq, rows, bk,
                                budget, mb, sm_scale);
      break;
    case 32:
      launch_gather<32, kPaged>(grid, threads, smem, st, q, q_pos, k, v, idx,
                                val, block_table, out, n_q, d, bq, rows, bk,
                                budget, mb, sm_scale);
      break;
    case 64:
      launch_gather<64, kPaged>(grid, threads, smem, st, q, q_pos, k, v, idx,
                                val, block_table, out, n_q, d, bq, rows, bk,
                                budget, mb, sm_scale);
      break;
    case 128:
      launch_gather<128, kPaged>(grid, threads, smem, st, q, q_pos, k, v,
                                 idx, val, block_table, out, n_q, d, bq, rows,
                                 bk, budget, mb, sm_scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int mpmrf_paged_prefill_filter_scores(
    const void* q_plane, const void* q_scale, const void* q_pos,
    const void* codes, const void* page_scale, const void* block_table,
    void* s0, void* s1, int bh, int n_q, int d, int bq, int bk, int mb,
    int lo, int hi, int msb_shift, int hi_shift, void* stream) {
  return filter_scores<true>(q_plane, q_scale, q_pos, codes, page_scale,
                             block_table, s0, s1, bh, n_q, d, bq, bk, mb, lo,
                             hi, msb_shift, hi_shift, stream);
}

extern "C" int mpmrf_prefill_filter_scores(
    const void* q_plane, const void* q_scale, const void* q_pos,
    const void* codes, const void* row_scale, void* s0, void* s1, int bh,
    int n_q, int d, int bq, int bk, int n_kb, int lo, int hi, int msb_shift,
    int hi_shift, void* stream) {
  return filter_scores<false>(q_plane, q_scale, q_pos, codes, row_scale,
                              nullptr, s0, s1, bh, n_q, d, bq, bk, n_kb, lo,
                              hi, msb_shift, hi_shift, stream);
}

extern "C" int paged_prefill_gather_attention(
    const void* q, const void* q_pos, const void* k_pages,
    const void* v_pages, const void* idx, const void* val,
    const void* block_table, void* out, int bh, int n_q, int d, int bq,
    int bk, int budget, int mb, float sm_scale, void* stream) {
  return gather_attention<true>(q, q_pos, k_pages, v_pages, idx, val,
                                block_table, out, bh, n_q, d, bq, bk, budget,
                                mb, sm_scale, stream);
}

extern "C" int prefill_gather_attention(
    const void* q, const void* q_pos, const void* k_cache,
    const void* v_cache, const void* idx, const void* val, void* out, int bh,
    int n_q, int d, int bq, int bk, int budget, int n_kb, float sm_scale,
    void* stream) {
  return gather_attention<false>(q, q_pos, k_cache, v_cache, idx, val,
                                 nullptr, out, bh, n_q, d, bq, bk, budget,
                                 n_kb, sm_scale, stream);
}
