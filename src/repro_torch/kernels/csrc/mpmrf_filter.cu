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
//   Bound on the H100 by integer operations: every causal (query, key)
//   pair costs two d-long int8 dots, while the bytes are one read of
//   the planes. The design runs on the integer filter engine
//   (filter_engine.cuh), the one B3/B7 use: a block owns a query block
//   (bh · n_qb blocks, longest causal triangles first; a launch with
//   too few of them splits each query block's key range into runs),
//   stages its q plane once for its whole life, streams its key blocks'
//   k_msb / k_rem rows through a three-stage cp.async ring of swizzled
//   tiles and multiplies on the int8 tensor cores (s8, int32
//   accumulate; wgmma m64n64k32 on the scoring path's d 128 and 64-row
//   blocks, mma.sync otherwise). Key blocks above the diagonal are never
//   read: the block that owns them writes NEG_INF.
//
//   Exactness: the planes are int8 and the dots int32, so acc0 and acc1
//   equal the reference's; the rescale is monotone for a positive q
//   scale, so the row's largest valid acc gives its max score (one
//   int→float conversion, exact for |acc| < 2^24, and one
//   round-to-nearest product), and the max is order-free: the scores
//   equal the plain version's bit for bit.
#include "filter_engine.cuh"

// MT: the product path (filt::product_path)
template <int D, int MT>
__global__ void __launch_bounds__(32 * filt::MAX_WARPS)
    filter_scores_kernel(filt::Args a) {
  filt::filter_block<D, MT, filt::Kind::kFull>(a);
}

template <int D>
static int launch(const filt::Args& a, int bh, int n_qb,
                  cudaStream_t stream) {
  static size_t given[2][64];
  const filt::Kind kind = filt::Kind::kFull;
  const int mt = filt::product_path(D, a.bq, a.bk);
  if constexpr (D == 128) {
    if (mt == 0)
      return filt::launch(filter_scores_kernel<D, 0>, given[0], kind, mt, D,
                          bh, n_qb, a, stream);
  }
  return filt::launch(filter_scores_kernel<D, 1>, given[1], kind, mt, D, bh,
                      n_qb, a, stream);
}

extern "C" int mpmrf_filter_scores(
    const void* q_plane, const void* k_msb, const void* k_rem,
    const void* q_scale, void* s0, void* s1, int bh, int n_q, int n_k,
    int d, int bq, int bk, int shift, int causal, int q_offset,
    void* stream) {
  cudaGetLastError();
  filt::Args a{};
  a.q_plane = q_plane;
  a.q_scale = (const float*)q_scale;
  a.k0 = k_msb;
  a.k_rem = (const int8_t*)k_rem;
  a.s0 = (float*)s0;
  a.s1 = (float*)s1;
  a.n_q = n_q;
  a.bq = bq;
  a.bk = bk;
  a.n_kb = n_k / bk;
  a.shift = shift;
  a.causal = causal;
  a.q_offset = q_offset;
  a.d = d;
  const int n_qb = n_q / bq;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mpmrf::kernel_head_dim(d)) {
    case 16: return launch<16>(a, bh, n_qb, st);
    case 32: return launch<32>(a, bh, n_qb, st);
    case 64: return launch<64>(a, bh, n_qb, st);
    case 128: return launch<128>(a, bh, n_qb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
