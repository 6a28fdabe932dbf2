// Dense flash attention kernel (the unpruned Attention Unit baseline)
// for Hopper (sm_90a), with a plain C interface for ctypes.
//
// B11 flash_attention — replaces the TPU kernel
//   repro/kernels/flash_attention.py::flash_attention (_flash_kernel):
//   attention of every query row over all keys (with `causal`, keys at
//   kpos <= q_offset + qpos), f32 online softmax, output
//   acc / max(l, 1e-30) rounded once to v's dtype (bf16).
//
//   B10's design with every key block a survivor: one block per (query
//   block, bh row), two threads per query row (flash_common.cuh), and
//   the block walks the key blocks 0 .. the last one any of its rows can
//   see, streaming each K and V tile (bk × d; 128 × 128 bf16 = 32 KB
//   each) into shared memory once for all bq rows. Blocks wholly above
//   the diagonal are never read. Bound by bf16 operations at these
//   shapes (n = 2048: each K/V tile feeds 2·bq·bk·d multiply-adds); the
//   products run in f32 on CUDA cores, far from the tensor-core bound,
//   and the tile loads do not overlap the arithmetic: a later PR's work.
#include "flash_common.cuh"

using mpmrf::dyn_smem;

template <int D>
__global__ void __launch_bounds__(256) flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int n_q, int n_k, int bq, int bk, int causal, int q_offset,
    float sm_scale) {
  const int qb = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, half = tid & 1, row = tid >> 1;
  const size_t grow = (size_t)b * n_q + (size_t)qb * bq + row;
  const int q_first = q_offset + qb * bq;
  const int n_kb = n_k / bk;
  int last = n_kb - 1;
  if (causal) {
    const int q_last = q_first + bq - 1;
    last = q_last < 0 ? -1 : min(last, q_last / bk);
  }
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(dyn_smem());
  __nv_bfloat16* vs = ks + bk * D;

  flash::RowState<D> st;
  st.init(q + grow * D, half);
  for (int kb = 0; kb <= last; ++kb) {
    const size_t base = ((size_t)b * n_k + (size_t)kb * bk) * D;
    __syncthreads();  // the previous block's readers are done
    mpmrf::load_tile(ks, k + base, bk * D);
    mpmrf::load_tile(vs, v + base, bk * D);
    __syncthreads();
    st.attend(ks, vs, bk, kb * bk, q_first + row, causal != 0, sm_scale,
              half);
  }
  st.store(out + grow * D, half);
}

template <int D>
static void launch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const void* q, const void* k, const void* v, void* out,
                   int n_q, int n_k, int bq, int bk, int causal, int q_offset,
                   float sm_scale) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(flash_attention_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  flash_attention_kernel<D><<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, n_q, n_k, bq, bk, causal,
      q_offset, sm_scale);
}

extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* out, int bh, int n_q,
    int n_k, int d, int bq, int bk, int causal, int q_offset, float sm_scale,
    void* stream) {
  cudaGetLastError();
  const dim3 grid(n_q / bq, bh);
  const int threads = 2 * bq;
  const size_t smem = 2 * sizeof(__nv_bfloat16) * (size_t)bk * d;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16:
      launch<16>(grid, threads, smem, st, q, k, v, out, n_q, n_k, bq, bk,
                 causal, q_offset, sm_scale);
      break;
    case 32:
      launch<32>(grid, threads, smem, st, q, k, v, out, n_q, n_k, bq, bk,
                 causal, q_offset, sm_scale);
      break;
    case 64:
      launch<64>(grid, threads, smem, st, q, k, v, out, n_q, n_k, bq, bk,
                 causal, q_offset, sm_scale);
      break;
    case 128:
      launch<128>(grid, threads, smem, st, q, k, v, out, n_q, n_k, bq, bk,
                  causal, q_offset, sm_scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
