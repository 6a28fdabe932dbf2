// Device code shared by the MP-MRF serving kernels (decode and prefill),
// paged and contiguous alike.
//
// block_of: where logical key block j of bh row b lives. A paged cache
//   names a physical page in its block table; a contiguous [bh, n_k, d]
//   cache is the same pool with the implicit table b·mb + j, so both
//   layouts run one kernel body, templated on which of the two it reads.
//
// The survivor-gather kernels (B2/B6, B4/B8) run on the attention tile
// engine of flash_common.cuh, and the filters (B1/B5, B3/B7) on the
// filter engine of filter_engine.cuh, with block_of naming their tile
// sources.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MPMRF_NEG_INF (-1e30f)

namespace mpmrf {

// The instantiation that runs head dim d: the least of 16, 32, 64 and
// 128 that is ≥ d, or 0 for a head dim no kernel takes (d % 16 ≠ 0, or
// past 128). The kernels read and write d columns (the operands' row
// stride) and zero-fill columns d .. D − 1 in shared memory, which adds
// exact zeros to every product, so one instantiation serves every d it
// covers. Every launch dispatches on it; its Python mirror is
// kernels/mpmrf_decode.py::kernel_head_dim. (16-byte cp.async rows of
// int8 planes need d % 16 == 0.)
__host__ __device__ inline int kernel_head_dim(int d) {
  if (d < 16 || d > 128 || d % 16 != 0) return 0;
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

template <bool kPaged>
__device__ __forceinline__ int block_of(const int32_t* __restrict__ table,
                                        int b, int j, int mb) {
  return kPaged ? table[b * mb + j] : b * mb + j;
}

}  // namespace mpmrf
