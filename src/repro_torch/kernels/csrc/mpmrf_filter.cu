// MP-MRF Filtering Unit kernel for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// B9 mpmrf_filter_scores — replaces the TPU kernel
//   repro/kernels/mpmrf_filter.py::mpmrf_filter_scores (_filter_kernel).
//   For each (bh row, query block, key block) tile it computes both
//   filter rounds with the Fig. 7 reuse,
//       acc0 = q·msbᵀ,  acc1 = (acc0 << shift) + q·remᵀ   (int32),
//   scales each row by its q scale (acc·qs, rounded once), masks pairs
//   that causality forbids (kpos > q_offset + qpos) to NEG_INF and
//   writes the max over the bq × bk tile for each round. The per-head k
//   scale and the planes' 2^(16-bits) factors are the caller's, as in
//   the reference.
//
//   Exactness: the planes are precomputed int8 (q in [-8, 7], MSB in
//   [-2, 1], remainder in [0, 3]), packed four lanes to a word as they
//   lie in memory, so every dot is __dp4a with int32 accumulation —
//   exact, like the reference's int32 dot. The only float steps are one
//   int→float conversion (exact: |acc| < 2^24) and one round-to-nearest
//   product, and the max is order-free, so the scores equal the plain
//   version's bit for bit.
//
//   Bound on the H100 by integer operations: every causal (query, key)
//   pair costs 2·d multiply-adds while the bytes are one read of the
//   planes. One block per tile stages the query block's plane (bq × d
//   bytes) in shared memory; each thread holds one key row's two planes
//   in registers and walks a quarter (bk = 64) of the query rows, so
//   the key planes are read once per tile and the query words are
//   broadcast from shared memory. Tiles wholly above the diagonal write
//   NEG_INF without reading anything (their max is NEG_INF either way).
//   The dots run on CUDA-core __dp4a, not the int8 tensor cores: a later
//   PR's work.
#include "mpmrf_common.cuh"

using mpmrf::dyn_smem;

template <int DW>
__global__ void __launch_bounds__(FILTER_THREADS) filter_scores_kernel(
    const int8_t* __restrict__ q_plane, const int8_t* __restrict__ k_msb,
    const int8_t* __restrict__ k_rem, const float* __restrict__ q_scale,
    float* __restrict__ s0, float* __restrict__ s1, int n_q, int n_k,
    int bq, int bk, int shift, int causal, int q_offset) {
  const int kb = blockIdx.x, qb = blockIdx.y, b = blockIdx.z;
  const int n_qb = gridDim.y, n_kb = gridDim.x;
  const size_t out = ((size_t)b * n_qb + qb) * n_kb + kb;
  const int q_first = q_offset + qb * bq;       // absolute position, row 0
  const int kmin = kb * bk;
  if (causal && kmin > q_first + bq - 1) {      // no pair of the tile is valid
    if (threadIdx.x == 0) {
      s0[out] = MPMRF_NEG_INF;
      s1[out] = MPMRF_NEG_INF;
    }
    return;
  }
  constexpr int D = 4 * DW;                     // head_dim in int8 lanes
  int* qw = dyn_smem();                         // [bq][DW] packed q plane
  int* kmsb = qw + bq * DW;                     // [bk][DW+1] (padded)
  int* krem = kmsb + bk * (DW + 1);             // [bk][DW+1]
  float* qs = reinterpret_cast<float*>(krem + bk * (DW + 1));  // [bq]
  float* red = qs + bq;                         // [2][32]
  const int tid = threadIdx.x;

  const int4* qsrc = reinterpret_cast<const int4*>(
      q_plane + ((size_t)b * n_q + (size_t)qb * bq) * D);
  for (int c = tid; c < bq * DW / 4; c += blockDim.x)
    reinterpret_cast<int4*>(qw)[c] = qsrc[c];
  for (int i = tid; i < bq; i += blockDim.x)
    qs[i] = q_scale[(size_t)b * n_q + (size_t)qb * bq + i];
  const size_t krow0 = ((size_t)b * n_k + kmin) * D;
  const int4* msrc = reinterpret_cast<const int4*>(k_msb + krow0);
  const int4* rsrc = reinterpret_cast<const int4*>(k_rem + krow0);
  for (int c = tid; c < bk * DW / 4; c += blockDim.x) {
    const int r = c / (DW / 4), w = (c % (DW / 4)) * 4;
    const int4 m = msrc[c], e = rsrc[c];
    int* md = kmsb + r * (DW + 1) + w;
    int* ed = krem + r * (DW + 1) + w;
    md[0] = m.x; md[1] = m.y; md[2] = m.z; md[3] = m.w;
    ed[0] = e.x; ed[1] = e.y; ed[2] = e.z; ed[3] = e.w;
  }
  __syncthreads();

  const int r = tid % bk;                       // this thread's key row
  const int groups = blockDim.x / bk;
  int km[DW], kr[DW];
#pragma unroll
  for (int w = 0; w < DW; ++w) {
    km[w] = kmsb[r * (DW + 1) + w];
    kr[w] = krem[r * (DW + 1) + w];
  }
  const int kpos = kmin + r;
  const int shift_mul = 1 << shift;
  float m0 = MPMRF_NEG_INF, m1 = MPMRF_NEG_INF;
  for (int i = tid / bk; i < bq; i += groups) {
    if (causal && kpos > q_first + i) continue;
    const int4* qrow = reinterpret_cast<const int4*>(qw + i * DW);
    int a0 = 0, ar = 0;
#pragma unroll
    for (int w4 = 0; w4 < DW / 4; ++w4) {
      const int4 qv = qrow[w4];
      a0 = __dp4a(qv.x, km[4 * w4 + 0], a0);
      a0 = __dp4a(qv.y, km[4 * w4 + 1], a0);
      a0 = __dp4a(qv.z, km[4 * w4 + 2], a0);
      a0 = __dp4a(qv.w, km[4 * w4 + 3], a0);
      ar = __dp4a(qv.x, kr[4 * w4 + 0], ar);
      ar = __dp4a(qv.y, kr[4 * w4 + 1], ar);
      ar = __dp4a(qv.z, kr[4 * w4 + 2], ar);
      ar = __dp4a(qv.w, kr[4 * w4 + 3], ar);
    }
    const int a1 = a0 * shift_mul + ar;
    const float qsi = qs[i];
    m0 = fmaxf(m0, __fmul_rn((float)a0, qsi));
    m1 = fmaxf(m1, __fmul_rn((float)a1, qsi));
  }
  m0 = mpmrf::block_max(m0, red);
  m1 = mpmrf::block_max(m1, red + 32);
  if (tid == 0) {
    s0[out] = m0;
    s1[out] = m1;
  }
}

static size_t filter_smem_bytes(int bq, int bk, int dw) {
  return sizeof(int) * ((size_t)bq * dw + 2 * (size_t)bk * (dw + 1) +
                        (size_t)bq + 64);
}

template <int DW>
static void launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const void* q_plane, const void* k_msb, const void* k_rem,
                   const void* q_scale, void* s0, void* s1, int n_q, int n_k,
                   int bq, int bk, int shift, int causal, int q_offset) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(filter_scores_kernel<DW>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  filter_scores_kernel<DW><<<grid, FILTER_THREADS, smem, stream>>>(
      (const int8_t*)q_plane, (const int8_t*)k_msb, (const int8_t*)k_rem,
      (const float*)q_scale, (float*)s0, (float*)s1, n_q, n_k, bq, bk, shift,
      causal, q_offset);
}

extern "C" int mpmrf_filter_scores(
    const void* q_plane, const void* k_msb, const void* k_rem,
    const void* q_scale, void* s0, void* s1, int bh, int n_q, int n_k,
    int d, int bq, int bk, int shift, int causal, int q_offset,
    void* stream) {
  cudaGetLastError();
  const dim3 grid(n_k / bk, n_q / bq, bh);
  const size_t smem = filter_smem_bytes(bq, bk, d / 4);
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16:
      launch<4>(grid, smem, st, q_plane, k_msb, k_rem, q_scale, s0, s1, n_q,
                n_k, bq, bk, shift, causal, q_offset);
      break;
    case 32:
      launch<8>(grid, smem, st, q_plane, k_msb, k_rem, q_scale, s0, s1, n_q,
                n_k, bq, bk, shift, causal, q_offset);
      break;
    case 64:
      launch<16>(grid, smem, st, q_plane, k_msb, k_rem, q_scale, s0, s1, n_q,
                 n_k, bq, bk, shift, causal, q_offset);
      break;
    case 128:
      launch<32>(grid, smem, st, q_plane, k_msb, k_rem, q_scale, s0, s1, n_q,
                 n_k, bq, bk, shift, causal, q_offset);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
