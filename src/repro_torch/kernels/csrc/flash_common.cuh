// Device code shared by the contiguous-cache attention kernels (B10
// block-sparse, B11 dense flash): the online softmax of one query row
// over one bk × D tile of K and V staged in shared memory.
//
// Layout: two threads per query row (`half` = 0 / 1), each holding the
// even / odd bf16x2 words of the row's query and f32 accumulator in
// registers — B4's design (mpmrf_prefill.cu) over contiguous rows. The
// tile is folded in 8-key sub-tiles with the reference's rules: scores
// the mask forbids are NEG_INF, p = 0 wherever s ≤ NEG_INF/2, and the
// caller divides by max(l, 1e-30). A tile whose every pair is masked
// leaves (m, l, acc) bit-identical (corr = 1, p = 0), which is why the
// kernels may skip such tiles without reading them.
#pragma once

#include "mpmrf_common.cuh"

namespace flash {

template <int D>
struct RowState {
  static constexpr int W = D / 4;  // bf16x2 words per thread
  float2 q[W];
  float2 acc[W];
  float m;
  float l;

  __device__ __forceinline__ void init(const __nv_bfloat16* row, int half) {
    const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(row);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      q[k] = __bfloat1622float2(r2[2 * k + half]);
      acc[k] = make_float2(0.f, 0.f);
    }
    m = MPMRF_NEG_INF;
    l = 0.f;
  }

  // Fold keys kbase .. kbase+rows-1 (rows a multiple of 8) of the tile
  // `ks` / `vs` ([rows][D] bf16 in shared memory). With `causal`, key
  // position kpos is visible iff kpos <= qpos.
  __device__ __forceinline__ void attend(const __nv_bfloat16* ks,
                                         const __nv_bfloat16* vs, int rows,
                                         int kbase, int qpos, bool causal,
                                         float sm_scale, int half) {
    for (int r0 = 0; r0 < rows; r0 += 8) {
      float sv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const __nv_bfloat162* krow =
            reinterpret_cast<const __nv_bfloat162*>(ks + (r0 + u) * D);
        float part = 0.f;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const float2 kf = __bfloat1622float2(krow[2 * k + half]);
          part += q[k].x * kf.x;
          part += q[k].y * kf.y;
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        const int kpos = kbase + r0 + u;
        sv[u] = (!causal || kpos <= qpos) ? part * sm_scale : MPMRF_NEG_INF;
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

  // acc / max(l, 1e-30), rounded once to bf16.
  __device__ __forceinline__ void store(__nv_bfloat16* row, int half) const {
    const float denom = fmaxf(l, 1e-30f);
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(row);
#pragma unroll
    for (int k = 0; k < W; ++k)
      o2[2 * k + half] =
          __floats2bfloat162_rn(acc[k].x / denom, acc[k].y / denom);
  }
};

}  // namespace flash
