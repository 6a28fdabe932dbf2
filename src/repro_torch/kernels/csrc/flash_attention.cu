// Dense flash attention kernel (the unpruned Attention Unit baseline)
// for Hopper (sm_90a), with a plain C interface for ctypes.
//
// B11 flash_attention — replaces the TPU kernel
//   repro/kernels/flash_attention.py::flash_attention (_flash_kernel):
//   attention of every query row over all keys (with `causal`, keys at
//   kpos <= q_offset + qpos), f32 online softmax, output
//   acc / max(l, 1e-30) rounded once to v's dtype (bf16).
//
//   Bound by operations at the scoring shapes (n = 2048, d = 128: each
//   K/V tile feeds 2·64·64·d multiply-adds per product and 64 rows).
//   The design takes the products to the tensor cores through the tile
//   engine of flash_common.cuh: blocks of 64 query rows (one warpgroup,
//   two blocks to an SM) issue wgmma on Q and K/V tiles of 64 keys
//   streamed through a three-stage cp.async ring while earlier tiles
//   compute, the softmax is folded once per tile, and P is split into
//   two bf16 halves so that P·V keeps f32 accuracy — 1.5× the tensor
//   work of a kernel that rounds P once. The key tile is the engine's
//   (64), not `block_k`, which the wrapper checks only for divisibility
//   as the reference does. Tiles wholly above the diagonal are never
//   read; the query blocks of a bh row are launched longest first
//   (reverse order), so the causal tail does not leave SMs idle, and
//   together, so they share the row's K/V in L2. What still holds it
//   back: one warpgroup waits on each product before its softmax (no
//   ping-pong between warpgroups, no producer warp, no TMA).
#include "flash_common.cuh"

template <int D>
__global__ void __launch_bounds__(256) flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int n_q, int n_k, int bq, int causal, int q_offset, float sm_scale) {
  // bq: this block's query rows (flash::block_rows)
  const int qb = gridDim.x - 1 - blockIdx.x, b = blockIdx.y;
  const size_t row0 = (size_t)b * n_q + (size_t)qb * bq;
  const int q_first = q_offset + qb * bq;
  int last = n_k - 1;
  if (causal) last = min(last, q_first + bq - 1);
  const int n_tiles = last < 0 ? 0 : last / flash::KT + 1;
  __nv_bfloat16* smem = flash::smem_base();
  flash::issue_q<D>(smem, q + row0 * D, bq);
  const auto tiles = [n_k](int t, int& src, int& kpos0, int& nv) {
    kpos0 = src = t * flash::KT;
    nv = min(flash::KT, n_k - kpos0);
  };
  const size_t krow0 = (size_t)b * n_k * D;
  flash::run<D>(k + krow0, v + krow0, out + row0 * D, smem, bq,
                flash::Contiguous{q_first}, q_first + bq - 1, causal != 0,
                sm_scale, n_tiles, tiles);
}

template <int D>
static void launch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const void* q, const void* k, const void* v, void* out,
                   int n_q, int n_k, int bq, int causal, int q_offset,
                   float sm_scale) {
  static size_t given[64];
  flash::allow_smem(flash_attention_kernel<D>, smem, given);
  flash_attention_kernel<D><<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, n_q, n_k, bq, causal,
      q_offset, sm_scale);
}

// `bk` is accepted for the interface's sake: the wrapper has checked
// that it divides n_k, and the engine tiles keys by its own KT.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* out, int bh, int n_q,
    int n_k, int d, int bq, int bk, int causal, int q_offset, float sm_scale,
    void* stream) {
  (void)bk;
  cudaGetLastError();
  bq = flash::block_rows(d, bq);
  const dim3 grid(n_q / bq, bh);
  const int threads = 2 * bq;  // one warp per 16 query rows
  const size_t smem = flash::smem_bytes(d, bq);
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16:
      launch<16>(grid, threads, smem, st, q, k, v, out, n_q, n_k, bq, causal,
                 q_offset, sm_scale);
      break;
    case 32:
      launch<32>(grid, threads, smem, st, q, k, v, out, n_q, n_k, bq, causal,
                 q_offset, sm_scale);
      break;
    case 64:
      launch<64>(grid, threads, smem, st, q, k, v, out, n_q, n_k, bq, causal,
                 q_offset, sm_scale);
      break;
    case 128:
      launch<128>(grid, threads, smem, st, q, k, v, out, n_q, n_k, bq, causal,
                  q_offset, sm_scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
