// Device code shared by the MP-MRF serving kernels (decode and prefill),
// paged and contiguous alike.
//
// block_of: where logical key block j of bh row b lives. A paged cache
//   names a physical page in its block table; a contiguous [bh, n_k, d]
//   cache is the same pool with the implicit table b·mb + j, so both
//   layouts run one kernel body, templated on which of the two it reads.
//
// filter_tile: the decode filter's body (B1/B5 only; the prefill and
//   full-sequence filters B3/B7/B9 run on the int8 tensor-core engine of
//   filter_engine.cuh). The two-round shift-and-add block score of one
//   logical key block (one physical page) against a tile of query rows, read
//   straight off the block's resident int16 codes. Both rounds' bit
//   planes are derived in shared memory by arithmetic shift and packed
//   four int8 lanes to a word, so each dot product is __dp4a on packed
//   planes with int32 accumulation — exact, like the reference's int32
//   MXU dot. The rescale keeps the reference's association
//   ((acc · (qs·2^(16-hi))) · (ks·2^(16-bits))) with round-to-nearest
//   products only, and the block max is order-free, so scores equal the
//   reference (and the plain PyTorch version) bit for bit.
//
// The survivor-gather kernels (B2/B6, B4/B8) run on the attention tile
// engine of flash_common.cuh, and B3/B7 on the filter engine, with
// block_of naming their tile sources.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MPMRF_NEG_INF (-1e30f)
#define FILTER_THREADS 256

namespace mpmrf {

// The one dynamic shared-memory array every kernel carves up.
__device__ __forceinline__ int* dyn_smem() {
  extern __shared__ __align__(16) int mpmrf_smem[];
  return mpmrf_smem;
}

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) |
         ((unsigned)(d & 0xff) << 24);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : MPMRF_NEG_INF;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  __syncthreads();
  return v;  // valid in warp 0
}

template <bool kPaged>
__device__ __forceinline__ int block_of(const int32_t* __restrict__ table,
                                        int b, int j, int mb) {
  return kPaged ? table[b * mb + j] : b * mb + j;
}

// One block of FILTER_THREADS threads scores `rows` query rows against
// the bk keys of one key block.
//   q_plane  int32 [rows, 4*DW]   (row-major, this tile only)
//   q_scale  f32   [rows]
//   q_pos    int32 [rows] or null (decode: every row masks kpos < limit)
//   codes    int16 [bk, 4*DW]     (this block only)
//   k_scale  f32, key row r's scale at k_scale[r * scale_stride]: stride
//            0 for one scale per page or block, 1 for per-row scales (a
//            prefill key tile spanning several scale groups)
// Row validity: prefill `kpos <= q_pos[i] && q_pos[i] < n_k`; decode
// `kpos < limit`. Writes the two rounds' block maxima (NEG_INF when no
// pair is valid) to *out0, *out1.
template <int DW>
__device__ void filter_tile(
    const int32_t* __restrict__ q_plane, const float* __restrict__ q_scale,
    const int32_t* __restrict__ q_pos, const int16_t* __restrict__ codes,
    const float* __restrict__ k_scale, int scale_stride, int rows, int bk,
    int kbase, int limit, int n_k, int lo, int hi, float* out0,
    float* out1) {
  int* qw = dyn_smem();                                  // [rows][DW]
  int* kmsb = qw + rows * DW;                      // [bk][DW+1]
  int* krem = kmsb + bk * (DW + 1);                // [bk][DW+1]
  float* qs = reinterpret_cast<float*>(krem + bk * (DW + 1));   // [rows]
  int* qp = reinterpret_cast<int*>(qs + rows);     // [rows]
  float* red = reinterpret_cast<float*>(qp + rows);  // [2][32]
  const int tid = threadIdx.x;
  const int d = 4 * DW;

  // query plane → packed int8 words (values fit: hi <= 8)
  for (int w = tid; w < rows * DW; w += blockDim.x) {
    const int4 v = reinterpret_cast<const int4*>(q_plane)[w];
    qw[w] = pack4(v.x, v.y, v.z, v.w);
  }
  const float q_factor = (float)(1 << (16 - hi));
  for (int i = tid; i < rows; i += blockDim.x) {
    qs[i] = __fmul_rn(q_scale[i], q_factor);
    qp[i] = q_pos ? q_pos[i] : limit - 1;
  }
  // page codes → the two planes, by arithmetic shift
  const int chunks = bk * d / 8;
  for (int c = tid; c < chunks; c += blockDim.x) {
    const int r = c / (d / 8), col = (c % (d / 8)) * 8;
    const int4 raw = reinterpret_cast<const int4*>(codes)[c];
    const int16_t* h = reinterpret_cast<const int16_t*>(&raw);
    int m[8], e[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int code = h[t];
      m[t] = code >> (16 - lo);
      e[t] = (code >> (16 - hi)) - m[t] * (1 << (hi - lo));
    }
    const int w = col / 4;
    kmsb[r * (DW + 1) + w] = pack4(m[0], m[1], m[2], m[3]);
    kmsb[r * (DW + 1) + w + 1] = pack4(m[4], m[5], m[6], m[7]);
    krem[r * (DW + 1) + w] = pack4(e[0], e[1], e[2], e[3]);
    krem[r * (DW + 1) + w + 1] = pack4(e[4], e[5], e[6], e[7]);
  }
  __syncthreads();

  const int shift_mul = 1 << (hi - lo);
  const int r = tid % bk;          // this thread's key row
  const float ks = k_scale[r * scale_stride];
  const float ks0 = __fmul_rn(ks, (float)(1 << (16 - lo)));
  const float ks1 = __fmul_rn(ks, (float)(1 << (16 - hi)));
  const int groups = blockDim.x / bk;
  int km[DW], kr[DW];
#pragma unroll
  for (int w = 0; w < DW; ++w) {
    km[w] = kmsb[r * (DW + 1) + w];
    kr[w] = krem[r * (DW + 1) + w];
  }
  const int kpos = kbase + r;
  float m0 = MPMRF_NEG_INF, m1 = MPMRF_NEG_INF;
  for (int i = tid / bk; i < rows; i += groups) {
    const int pos = qp[i];
    const bool ok = q_pos ? (kpos <= pos && pos < n_k) : (kpos < limit);
    if (!ok) continue;
    int a0 = 0, ar = 0;
    const int* qrow = qw + i * DW;
#pragma unroll
    for (int w = 0; w < DW; ++w) {
      const int qv = qrow[w];
      a0 = __dp4a(qv, km[w], a0);
      ar = __dp4a(qv, kr[w], ar);
    }
    const int a1 = a0 * shift_mul + ar;
    const float qsi = qs[i];
    m0 = fmaxf(m0, __fmul_rn(__fmul_rn((float)a0, qsi), ks0));
    m1 = fmaxf(m1, __fmul_rn(__fmul_rn((float)a1, qsi), ks1));
  }
  m0 = block_max(m0, red);
  m1 = block_max(m1, red + 32);
  if (tid == 0) {
    *out0 = m0;
    *out1 = m1;
  }
}

}  // namespace mpmrf
