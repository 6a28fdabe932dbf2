// MP-MRF decode kernels for Hopper (sm_90a), paged and contiguous, with
// a plain C interface for ctypes.
//
// B1 mpmrf_paged_filter_scores — replaces the TPU kernel
//   repro/kernels/mpmrf_decode.py::mpmrf_paged_filter_scores
//   (_paged_filter_kernel). One block per (logical block j, bh row):
//   it reads physical page bt[b, j]'s int16 codes once, derives the
//   2-bit and 4-bit planes by shift in shared memory, scores the G
//   folded query rows with __dp4a (see mpmrf_common.cuh) and writes the
//   two block maxima. Bound on the H100 by bytes: the codes are read
//   once and nothing else of size moves, so a block that lies wholly
//   past the slot's cache length skips the page entirely (its scores
//   are all masked to NEG_INF) — the bytes read are the live pages'.
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
//   nothing; the grid covers the n_kb blocks only.
//
// B2 paged_decode_gather_attention — replaces
//   repro/kernels/mpmrf_decode.py::paged_decode_gather_attention
//   (_paged_gather_kernel). One block per bh row walks the survivor
//   slots in order: slot s streams page bt[b, idx[b, s]] of K and V
//   into shared memory and folds the G rows' scores into an f32 online
//   softmax (running max m, sum l, accumulator), with the reference's
//   rules: scores ≤ NEG_INF/2 contribute p = 0 and the output is
//   acc / max(l, 1e-30), so a fully masked row yields 0. Bound by
//   bytes (the survivor pages of K and V); slots whose valid bit is 0
//   are skipped without reading their pages, which leaves m, l and acc
//   exactly as the reference's masked step does (corr = 1, p = 0).
//
// B6 decode_gather_attention — replaces
//   repro/kernels/mpmrf_decode.py::decode_gather_attention
//   (_decode_gather_kernel): B2 with idx[b, s] naming block
//   b·n_kb + idx[b, s] of the contiguous K/V cache — the same kernel
//   body, the same bytes bound, outputs equal to B2's on the same rows.
#include "mpmrf_common.cuh"

using mpmrf::dyn_smem;

#define GATHER_THREADS 128
#define GATHER_MAX_G 16

template <int DW, bool kPaged>
__global__ void __launch_bounds__(FILTER_THREADS) decode_filter_kernel(
    const int32_t* __restrict__ q_plane, const float* __restrict__ q_scale,
    const int16_t* __restrict__ codes, const float* __restrict__ blk_scale,
    const int32_t* __restrict__ block_table,
    const int32_t* __restrict__ cache_len, float* __restrict__ s0,
    float* __restrict__ s1, int g, int bk, int mb, int lo, int hi) {
  const int j = blockIdx.x, b = blockIdx.y;
  const int len = cache_len[b];
  const int out = b * mb + j;
  if (j * bk >= len) {
    if (threadIdx.x == 0) {
      s0[out] = MPMRF_NEG_INF;
      s1[out] = MPMRF_NEG_INF;
    }
    return;
  }
  const int d = 4 * DW;
  const int blk = mpmrf::block_of<kPaged>(block_table, b, j, mb);
  mpmrf::filter_tile<DW>(
      q_plane + (size_t)b * g * d, q_scale + (size_t)b * g, nullptr,
      codes + (size_t)blk * bk * d, blk_scale + blk, 0, g, bk, j * bk, len,
      0, lo, hi, s0 + out, s1 + out);
}

template <bool kPaged>
__global__ void __launch_bounds__(GATHER_THREADS) decode_gather_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ val,
    const int32_t* __restrict__ block_table,
    const int32_t* __restrict__ cache_len, __nv_bfloat16* __restrict__ out,
    int g, int d, int bk, int budget, int mb, float sm_scale) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  float* qf = reinterpret_cast<float*>(dyn_smem());  // [g][d]
  float* sc = qf + g * d;                             // [g][bk]
  float* row_m = sc + g * bk;                         // [g]
  float* row_l = row_m + g;                           // [g]
  float* row_c = row_l + g;                           // [g]
  const int head_floats = ((g * d + g * bk + 3 * g) + 3) & ~3;
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(qf + head_floats);
  __nv_bfloat16* ks = vs + bk * d;   // [bk][d + 2]: odd word stride
  const int kstride = d + 2;
  const int len = cache_len[b];

  for (int i = tid; i < g * d; i += blockDim.x)
    qf[i] = __bfloat162float(q[(size_t)b * g * d + i]);
  for (int i = tid; i < g; i += blockDim.x) {
    row_m[i] = MPMRF_NEG_INF;
    row_l[i] = 0.f;
  }
  float acc[GATHER_MAX_G];
#pragma unroll
  for (int gi = 0; gi < GATHER_MAX_G; ++gi) acc[gi] = 0.f;
  __syncthreads();

  for (int s = 0; s < budget; ++s) {
    if (!val[b * budget + s]) continue;
    const int kb = idx[b * budget + s];
    const size_t page = mpmrf::block_of<kPaged>(block_table, b, kb, mb);
    __syncthreads();  // the previous slot's readers are done
    mpmrf::load_tile(vs, v_pages + page * bk * d, bk * d);
    const int4* ksrc = reinterpret_cast<const int4*>(k_pages + page * bk * d);
    for (int c = tid; c < bk * d / 8; c += blockDim.x) {
      const int r = c / (d / 8), col = (c % (d / 8)) * 8;
      const int4 raw = ksrc[c];
      uint32_t* dst = reinterpret_cast<uint32_t*>(ks + r * kstride + col);
      dst[0] = raw.x;
      dst[1] = raw.y;
      dst[2] = raw.z;
      dst[3] = raw.w;
    }
    __syncthreads();
    for (int p = tid; p < g * bk; p += blockDim.x) {
      const int gi = p / bk, r = p % bk;
      const float* qrow = qf + gi * d;
      const __nv_bfloat162* krow =
          reinterpret_cast<const __nv_bfloat162*>(ks + r * kstride);
      float dot = 0.f;
      for (int w = 0; w < d / 2; ++w) {
        const float2 kf = __bfloat1622float2(krow[w]);
        dot += qrow[2 * w] * kf.x;
        dot += qrow[2 * w + 1] * kf.y;
      }
      const int kpos = kb * bk + r;
      sc[p] = kpos < len ? dot * sm_scale : MPMRF_NEG_INF;
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += nwarps) {
      float mc = MPMRF_NEG_INF;
      for (int r = lane; r < bk; r += 32) mc = fmaxf(mc, sc[gi * bk + r]);
      for (int off = 16; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_prev = row_m[gi];
      const float m_new = fmaxf(m_prev, mc);
      float ps = 0.f;
      for (int r = lane; r < bk; r += 32) {
        const float sv = sc[gi * bk + r];
        const float pv = sv <= MPMRF_NEG_INF / 2 ? 0.f : expf(sv - m_new);
        sc[gi * bk + r] = pv;
        ps += pv;
      }
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        row_c[gi] = corr;
        row_l[gi] = corr * row_l[gi] + ps;
        row_m[gi] = m_new;
      }
    }
    __syncthreads();
    if (tid < d) {
#pragma unroll
      for (int gi = 0; gi < GATHER_MAX_G; ++gi) {
        if (gi < g) {
          float a = acc[gi] * row_c[gi];
          for (int r = 0; r < bk; ++r)
            a += sc[gi * bk + r] * __bfloat162float(vs[r * d + tid]);
          acc[gi] = a;
        }
      }
    }
  }
  __syncthreads();
  if (tid < d) {
#pragma unroll
    for (int gi = 0; gi < GATHER_MAX_G; ++gi) {
      if (gi < g)
        out[((size_t)b * g + gi) * d + tid] =
            __float2bfloat16(acc[gi] / fmaxf(row_l[gi], 1e-30f));
    }
  }
}

static size_t filter_smem_bytes(int rows, int bk, int dw) {
  return sizeof(int) * ((size_t)rows * dw + 2 * (size_t)bk * (dw + 1) +
                        2 * (size_t)rows + 64);
}

template <int DW, bool kPaged>
static void launch_filter(dim3 grid, size_t smem, cudaStream_t stream,
                          const void* q_plane, const void* q_scale,
                          const void* codes, const void* blk_scale,
                          const void* block_table, const void* cache_len,
                          void* s0, void* s1, int g, int bk, int mb, int lo,
                          int hi) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(decode_filter_kernel<DW, kPaged>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  decode_filter_kernel<DW, kPaged><<<grid, FILTER_THREADS, smem, stream>>>(
      (const int32_t*)q_plane, (const float*)q_scale, (const int16_t*)codes,
      (const float*)blk_scale, (const int32_t*)block_table,
      (const int32_t*)cache_len, (float*)s0, (float*)s1, g, bk, mb, lo, hi);
}

// mb: blocks per bh row (table width, or n_kb of the contiguous cache)
template <bool kPaged>
static int filter_scores(const void* q_plane, const void* q_scale,
                         const void* codes, const void* blk_scale,
                         const void* block_table, const void* cache_len,
                         void* s0, void* s1, int bh, int g, int d, int bk,
                         int mb, int lo, int hi, void* stream) {
  cudaGetLastError();
  const dim3 grid(mb, bh);
  const size_t smem = filter_smem_bytes(g, bk, d / 4);
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16:
      launch_filter<4, kPaged>(grid, smem, st, q_plane, q_scale, codes,
                               blk_scale, block_table, cache_len, s0, s1, g,
                               bk, mb, lo, hi);
      break;
    case 32:
      launch_filter<8, kPaged>(grid, smem, st, q_plane, q_scale, codes,
                               blk_scale, block_table, cache_len, s0, s1, g,
                               bk, mb, lo, hi);
      break;
    case 64:
      launch_filter<16, kPaged>(grid, smem, st, q_plane, q_scale, codes,
                                blk_scale, block_table, cache_len, s0, s1, g,
                                bk, mb, lo, hi);
      break;
    case 128:
      launch_filter<32, kPaged>(grid, smem, st, q_plane, q_scale, codes,
                                blk_scale, block_table, cache_len, s0, s1, g,
                                bk, mb, lo, hi);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool kPaged>
static int gather_attention(const void* q, const void* k, const void* v,
                            const void* idx, const void* val,
                            const void* block_table, const void* cache_len,
                            void* out, int bh, int g, int d, int bk,
                            int budget, int mb, float sm_scale, void* stream) {
  cudaGetLastError();
  if (g > GATHER_MAX_G || d > GATHER_THREADS) return (int)cudaErrorInvalidValue;
  const size_t head_floats = (((size_t)g * d + (size_t)g * bk + 3 * g) + 3) & ~(size_t)3;
  const size_t smem = head_floats * sizeof(float) +
                      sizeof(__nv_bfloat16) * ((size_t)bk * d + (size_t)bk * (d + 2));
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(decode_gather_kernel<kPaged>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  decode_gather_kernel<kPaged><<<bh, GATHER_THREADS, smem,
                                 (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int32_t*)idx, (const int32_t*)val,
      (const int32_t*)block_table, (const int32_t*)cache_len,
      (__nv_bfloat16*)out, g, d, bk, budget, mb, sm_scale);
  return (int)cudaGetLastError();
}

extern "C" int mpmrf_paged_filter_scores(
    const void* q_plane, const void* q_scale, const void* codes,
    const void* page_scale, const void* block_table, const void* cache_len,
    void* s0, void* s1, int bh, int g, int d, int bk, int mb, int lo, int hi,
    void* stream) {
  return filter_scores<true>(q_plane, q_scale, codes, page_scale,
                             block_table, cache_len, s0, s1, bh, g, d, bk, mb,
                             lo, hi, stream);
}

extern "C" int mpmrf_decode_filter_scores(
    const void* q_plane, const void* q_scale, const void* codes,
    const void* block_scale, const void* cache_len, void* s0, void* s1,
    int bh, int g, int d, int bk, int n_kb, int lo, int hi, void* stream) {
  return filter_scores<false>(q_plane, q_scale, codes, block_scale, nullptr,
                              cache_len, s0, s1, bh, g, d, bk, n_kb, lo, hi,
                              stream);
}

extern "C" int paged_decode_gather_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* idx,
    const void* val, const void* block_table, const void* cache_len,
    void* out, int bh, int g, int d, int bk, int budget, int mb,
    float sm_scale, void* stream) {
  return gather_attention<true>(q, k_pages, v_pages, idx, val, block_table,
                                cache_len, out, bh, g, d, bk, budget, mb,
                                sm_scale, stream);
}

extern "C" int decode_gather_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* idx,
    const void* val, const void* cache_len, void* out, int bh, int g, int d,
    int bk, int budget, int n_kb, float sm_scale, void* stream) {
  return gather_attention<false>(q, k_cache, v_cache, idx, val, nullptr,
                                 cache_len, out, bh, g, d, bk, budget, n_kb,
                                 sm_scale, stream);
}
