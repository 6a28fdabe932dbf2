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
//   (_paged_prefill_gather_kernel). One block per (query block, bh
//   row), two threads per query row, each holding half of the row's
//   query and accumulator in registers. The block walks the survivor
//   slots in order, streams page bt[b, idx[b, qb, s]] of K and V into
//   shared memory (read once for all bq rows), and folds 8-key
//   sub-tiles into an f32 online softmax with the reference's rules
//   (p = 0 for scores ≤ NEG_INF/2, output acc / max(l, 1e-30)). Bound
//   by bytes: the survivor pages, read once per query block; slots
//   whose valid bit is 0 are skipped without reading their pages.
//
// B8 prefill_gather_attention — replaces
//   repro/kernels/mpmrf_prefill.py::prefill_gather_attention
//   (_prefill_gather_kernel): B4 with row bases b·n_k + idx·bk of the
//   contiguous K/V cache — the same kernel body, outputs equal to B4's
//   on the same rows; sentinel rows (qpos ≥ n_k) come out 0.
#include "mpmrf_common.cuh"

using mpmrf::dyn_smem;

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

template <int D, bool kPaged>
__global__ void __launch_bounds__(256) prefill_gather_kernel(
    const __nv_bfloat16* __restrict__ q, const int32_t* __restrict__ q_pos,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ val,
    const int32_t* __restrict__ block_table, __nv_bfloat16* __restrict__ out,
    int n_q, int bq, int bk, int budget, int mb, float sm_scale) {
  constexpr int W = D / 4;  // bf16x2 words per thread: 2k + half
  const int qb = blockIdx.x, b = blockIdx.y, n_qb = gridDim.x;
  const int n_k = mb * bk;
  const int tid = threadIdx.x, half = tid & 1;
  const size_t grow = (size_t)b * n_q + (size_t)qb * bq + (tid >> 1);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(dyn_smem());
  __nv_bfloat16* vs = ks + bk * D;

  float2 qr[W], acc[W];
  const __nv_bfloat162* qrow =
      reinterpret_cast<const __nv_bfloat162*>(q + grow * D);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    qr[k] = __bfloat1622float2(qrow[2 * k + half]);
    acc[k] = make_float2(0.f, 0.f);
  }
  const int pos = q_pos[grow];
  const bool row_ok = pos < n_k;
  float m = MPMRF_NEG_INF, l = 0.f;
  const int* idx_row = idx + ((size_t)b * n_qb + qb) * budget;
  const int* val_row = val + ((size_t)b * n_qb + qb) * budget;

  for (int s = 0; s < budget; ++s) {
    if (!val_row[s]) continue;
    const int kb = idx_row[s];
    const size_t page = mpmrf::block_of<kPaged>(block_table, b, kb, mb);
    __syncthreads();  // the previous slot's readers are done
    mpmrf::load_tile(ks, k_pages + page * bk * D, bk * D);
    mpmrf::load_tile(vs, v_pages + page * bk * D, bk * D);
    __syncthreads();
    for (int r0 = 0; r0 < bk; r0 += 8) {
      float sv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const __nv_bfloat162* krow =
            reinterpret_cast<const __nv_bfloat162*>(ks + (r0 + u) * D);
        float part = 0.f;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const float2 kf = __bfloat1622float2(krow[2 * k + half]);
          part += qr[k].x * kf.x;
          part += qr[k].y * kf.y;
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        const int kpos = kb * bk + r0 + u;
        sv[u] = (row_ok && kpos <= pos) ? part * sm_scale : MPMRF_NEG_INF;
      }
      float mc = sv[0];
#pragma unroll
      for (int u = 1; u < 8; ++u) mc = fmaxf(mc, sv[u]);
      const float m_new = fmaxf(m, mc);
      const float corr = expf(m - m_new);
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        sv[u] = sv[u] <= MPMRF_NEG_INF / 2 ? 0.f : expf(sv[u] - m_new);
        ps += sv[u];
      }
      l = corr * l + ps;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        acc[k].x *= corr;
        acc[k].y *= corr;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const __nv_bfloat162* vrow =
            reinterpret_cast<const __nv_bfloat162*>(vs + (r0 + u) * D);
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const float2 vf = __bfloat1622float2(vrow[2 * k + half]);
          acc[k].x += sv[u] * vf.x;
          acc[k].y += sv[u] * vf.y;
        }
      }
      m = m_new;
    }
  }
  const float denom = fmaxf(l, 1e-30f);
  __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(out + grow * D);
#pragma unroll
  for (int k = 0; k < W; ++k)
    orow[2 * k + half] =
        __floats2bfloat162_rn(acc[k].x / denom, acc[k].y / denom);
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
                          int bk, int budget, int mb, float sm_scale) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(prefill_gather_kernel<D, kPaged>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  prefill_gather_kernel<D, kPaged><<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const int32_t*)q_pos,
      (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const int32_t*)idx,
      (const int32_t*)val, (const int32_t*)block_table, (__nv_bfloat16*)out,
      n_q, bq, bk, budget, mb, sm_scale);
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
  const dim3 grid(n_q / bq, bh);
  const int threads = 2 * bq;
  const size_t smem = 2 * sizeof(__nv_bfloat16) * (size_t)bk * d;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16:
      launch_gather<16, kPaged>(grid, threads, smem, st, q, q_pos, k, v, idx,
                                val, block_table, out, n_q, bq, bk, budget,
                                mb, sm_scale);
      break;
    case 32:
      launch_gather<32, kPaged>(grid, threads, smem, st, q, q_pos, k, v, idx,
                                val, block_table, out, n_q, bq, bk, budget,
                                mb, sm_scale);
      break;
    case 64:
      launch_gather<64, kPaged>(grid, threads, smem, st, q, q_pos, k, v, idx,
                                val, block_table, out, n_q, bq, bk, budget,
                                mb, sm_scale);
      break;
    case 128:
      launch_gather<128, kPaged>(grid, threads, smem, st, q, q_pos, k, v,
                                 idx, val, block_table, out, n_q, bq, bk,
                                 budget, mb, sm_scale);
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
