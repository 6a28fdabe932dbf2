// MP-MRF prefill kernels for Hopper (sm_90a), paged and contiguous,
// with a plain C interface for ctypes.
//
// B3 mpmrf_paged_prefill_filter_scores — replaces the TPU kernel
//   repro/kernels/mpmrf_prefill.py::mpmrf_paged_prefill_filter_scores
//   (_paged_prefill_filter_kernel). One block per (logical block j,
//   query block, bh row) stages the query block's 4-bit plane (bq × d,
//   packed int8) and page bt[b, j]'s two code planes in shared memory
//   and pools both rounds' scores over the bq × bk tile under the
//   per-row mask kpos ≤ qpos ∧ qpos < n_k (mpmrf_common.cuh). Bound on
//   the H100 by integer operations: every page is scored against every
//   query block, so the work is n_q·n_k·d multiply-adds per round while
//   the bytes are one read of the planes. The design answers with
//   __dp4a (four int8 products per instruction) on planes packed in
//   shared memory, the key row's planes held in registers across the
//   query rows, and an early exit for blocks that no row of the query
//   block can see (causal future, or only sentinel rows), which skip
//   both the page read and the arithmetic.
//
// B7 mpmrf_prefill_filter_scores — replaces
//   repro/kernels/mpmrf_prefill.py::mpmrf_prefill_filter_scores
//   (_prefill_filter_kernel): B3 over the contiguous [bh, n_k, d] codes
//   (block j of row b is block b·n_kb + j, block_of<false>), the same
//   kernel body and bound. Its key scale is per row ([bh, n_k], the
//   caller's expansion of the resident per-block scales), because a
//   prefill key tile may span several decode-block scale groups; each
//   thread rescales with its own key row's scale in the reference's
//   association, so the scores stay bit-exact, and equal B3's when the
//   tile is one scale group.
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
#include "flash_common.cuh"

// k_scale: one per block (kPaged, the page's scale) or one per key row
// (contiguous, [bh, n_k])
template <int DW, bool kPaged>
__global__ void __launch_bounds__(FILTER_THREADS) prefill_filter_kernel(
    const int32_t* __restrict__ q_plane, const float* __restrict__ q_scale,
    const int32_t* __restrict__ q_pos, const int16_t* __restrict__ codes,
    const float* __restrict__ k_scale,
    const int32_t* __restrict__ block_table, float* __restrict__ s0,
    float* __restrict__ s1, int n_q, int bq, int bk, int mb, int lo,
    int hi) {
  const int j = blockIdx.x, qb = blockIdx.y, b = blockIdx.z;
  const int n_qb = gridDim.y, n_k = mb * bk, kmin = j * bk;
  const int out = (b * n_qb + qb) * mb + j;
  const size_t row0 = (size_t)b * n_q + (size_t)qb * bq;
  int any = 0;
  for (int i = threadIdx.x; i < bq; i += blockDim.x) {
    const int p = q_pos[row0 + i];
    any |= (kmin <= p && p < n_k);
  }
  if (!__syncthreads_or(any)) {
    if (threadIdx.x == 0) {
      s0[out] = MPMRF_NEG_INF;
      s1[out] = MPMRF_NEG_INF;
    }
    return;
  }
  const int d = 4 * DW;
  const int blk = mpmrf::block_of<kPaged>(block_table, b, j, mb);
  mpmrf::filter_tile<DW>(
      q_plane + row0 * d, q_scale + row0, q_pos + row0,
      codes + (size_t)blk * bk * d,
      kPaged ? k_scale + blk : k_scale + (size_t)blk * bk, kPaged ? 0 : 1,
      bq, bk, kmin, 0, n_k, lo, hi, s0 + out, s1 + out);
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
    int n_q, int bq, int rows, int bk, int budget, int mb, float sm_scale) {
  // rows: this block's query rows (flash::block_rows), a part of the
  // query block of bq rows whose survivor table it reads
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
    int4* o = reinterpret_cast<int4*>(out + row0 * D);
    for (int i = threadIdx.x; i < rows * D / 8; i += blockDim.x)
      o[i] = make_int4(0, 0, 0, 0);
    return;
  }
  flash::issue_q<D>(smem, q + row0 * D, rows);
  const int per = (bk + flash::KT - 1) / flash::KT;  // ring tiles per page
  const auto tiles = [kept_kb, kept_src, bk, per](int t, int& src,
                                                  int& kpos0, int& nv) {
    const int s = t / per, c = t % per;
    src = kept_src[s] * bk + c * flash::KT;
    kpos0 = kept_kb[s] * bk + c * flash::KT;
    nv = min(flash::KT, bk - c * flash::KT);
  };
  flash::run<D>(k_pages, v_pages, out + row0 * D, smem, rows, pos, q_last,
                true, sm_scale, info[0] * per, tiles);
}

static size_t filter_smem_bytes(int rows, int bk, int dw) {
  return sizeof(int) * ((size_t)rows * dw + 2 * (size_t)bk * (dw + 1) +
                        2 * (size_t)rows + 64);
}

template <int DW, bool kPaged>
static void launch_filter(dim3 grid, size_t smem, cudaStream_t stream,
                          const void* q_plane, const void* q_scale,
                          const void* q_pos, const void* codes,
                          const void* k_scale, const void* block_table,
                          void* s0, void* s1, int n_q, int bq, int bk, int mb,
                          int lo, int hi) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(prefill_filter_kernel<DW, kPaged>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  prefill_filter_kernel<DW, kPaged><<<grid, FILTER_THREADS, smem, stream>>>(
      (const int32_t*)q_plane, (const float*)q_scale, (const int32_t*)q_pos,
      (const int16_t*)codes, (const float*)k_scale,
      (const int32_t*)block_table, (float*)s0, (float*)s1, n_q, bq, bk, mb,
      lo, hi);
}

template <int D, bool kPaged>
static void launch_gather(dim3 grid, int threads, size_t smem,
                          cudaStream_t stream, const void* q,
                          const void* q_pos, const void* k, const void* v,
                          const void* idx, const void* val,
                          const void* block_table, void* out, int n_q, int bq,
                          int rows, int bk, int budget, int mb,
                          float sm_scale) {
  static size_t given[64];
  flash::allow_smem(prefill_gather_kernel<D, kPaged>, smem, given);
  prefill_gather_kernel<D, kPaged><<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const int32_t*)q_pos,
      (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const int32_t*)idx,
      (const int32_t*)val, (const int32_t*)block_table, (__nv_bfloat16*)out,
      n_q, bq, rows, bk, budget, mb, sm_scale);
}

// mb: blocks per bh row (table width, or n_kb of the contiguous cache)
template <bool kPaged>
static int filter_scores(const void* q_plane, const void* q_scale,
                         const void* q_pos, const void* codes,
                         const void* k_scale, const void* block_table,
                         void* s0, void* s1, int bh, int n_q, int d, int bq,
                         int bk, int mb, int lo, int hi, void* stream) {
  cudaGetLastError();
  const dim3 grid(mb, n_q / bq, bh);
  const size_t smem = filter_smem_bytes(bq, bk, d / 4);
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16:
      launch_filter<4, kPaged>(grid, smem, st, q_plane, q_scale, q_pos, codes,
                               k_scale, block_table, s0, s1, n_q, bq, bk, mb,
                               lo, hi);
      break;
    case 32:
      launch_filter<8, kPaged>(grid, smem, st, q_plane, q_scale, q_pos, codes,
                               k_scale, block_table, s0, s1, n_q, bq, bk, mb,
                               lo, hi);
      break;
    case 64:
      launch_filter<16, kPaged>(grid, smem, st, q_plane, q_scale, q_pos,
                                codes, k_scale, block_table, s0, s1, n_q, bq,
                                bk, mb, lo, hi);
      break;
    case 128:
      launch_filter<32, kPaged>(grid, smem, st, q_plane, q_scale, q_pos,
                                codes, k_scale, block_table, s0, s1, n_q, bq,
                                bk, mb, lo, hi);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool kPaged>
static int gather_attention(const void* q, const void* q_pos, const void* k,
                            const void* v, const void* idx, const void* val,
                            const void* block_table, void* out, int bh,
                            int n_q, int d, int bq, int bk, int budget, int mb,
                            float sm_scale, void* stream) {
  cudaGetLastError();
  const int rows = flash::block_rows(d, bq);
  const dim3 grid(n_q / rows, bh);
  const int threads = 2 * rows;  // one warp per 16 query rows
  // the engine's stage and ring, then the kept lists, their count and
  // the block's largest live position
  const size_t smem =
      flash::smem_bytes(d, rows) + sizeof(int) * (2 * (size_t)budget + 2);
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16:
      launch_gather<16, kPaged>(grid, threads, smem, st, q, q_pos, k, v, idx,
                                val, block_table, out, n_q, bq, rows, bk,
                                budget, mb, sm_scale);
      break;
    case 32:
      launch_gather<32, kPaged>(grid, threads, smem, st, q, q_pos, k, v, idx,
                                val, block_table, out, n_q, bq, rows, bk,
                                budget, mb, sm_scale);
      break;
    case 64:
      launch_gather<64, kPaged>(grid, threads, smem, st, q, q_pos, k, v, idx,
                                val, block_table, out, n_q, bq, rows, bk,
                                budget, mb, sm_scale);
      break;
    case 128:
      launch_gather<128, kPaged>(grid, threads, smem, st, q, q_pos, k, v,
                                 idx, val, block_table, out, n_q, bq, rows,
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
    int lo, int hi, void* stream) {
  return filter_scores<true>(q_plane, q_scale, q_pos, codes, page_scale,
                             block_table, s0, s1, bh, n_q, d, bq, bk, mb, lo,
                             hi, stream);
}

extern "C" int mpmrf_prefill_filter_scores(
    const void* q_plane, const void* q_scale, const void* q_pos,
    const void* codes, const void* row_scale, void* s0, void* s1, int bh,
    int n_q, int d, int bq, int bk, int n_kb, int lo, int hi, void* stream) {
  return filter_scores<false>(q_plane, q_scale, q_pos, codes, row_scale,
                              nullptr, s0, s1, bh, n_q, d, bq, bk, n_kb, lo,
                              hi, stream);
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
