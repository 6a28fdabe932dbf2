// Block-sparse attention kernel (the Energon Attention Unit) for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// B10 block_sparse_attention — replaces the TPU kernel
//   repro/kernels/block_sparse_attention.py::block_sparse_attention
//   (_bsa_kernel). Each query block attends only to its top-B key blocks
//   (`idx` / `valid`, int32 [bh, n_qb, B]) under the validity mask and,
//   with `causal`, kpos <= q_offset + qpos, in an f32 online softmax;
//   the output is acc / max(l, 1e-30) rounded once to v's dtype (bf16).
//
//   B4's design over contiguous [bh, n, d] rows: one block per (query
//   block, bh row), two threads per query row holding half of the row's
//   query and accumulator in registers (flash_common.cuh). The block
//   walks the survivor slots in order and streams each survivor's K and
//   V tile (bk × d) into shared memory once for all bq rows. Bound by
//   bytes: q, the survivor tiles (read once per query block) and the
//   output. Slots whose valid bit is 0, and survivors wholly above the
//   diagonal, are skipped without reading their tiles; either leaves
//   the result bit-identical (corr = 1, p = 0). The products run in f32
//   on CUDA cores, not bf16 tensor cores: a later PR's work.
#include "flash_common.cuh"

using mpmrf::dyn_smem;

template <int D>
__global__ void __launch_bounds__(256) block_sparse_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ val, __nv_bfloat16* __restrict__ out,
    int n_q, int n_k, int bq, int bk, int budget, int causal, int q_offset,
    float sm_scale) {
  const int qb = blockIdx.x, b = blockIdx.y, n_qb = gridDim.x;
  const int tid = threadIdx.x, half = tid & 1, row = tid >> 1;
  const size_t grow = (size_t)b * n_q + (size_t)qb * bq + row;
  const int q_first = q_offset + qb * bq;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(dyn_smem());
  __nv_bfloat16* vs = ks + bk * D;

  flash::RowState<D> st;
  st.init(q + grow * D, half);
  const int* idx_row = idx + ((size_t)b * n_qb + qb) * budget;
  const int* val_row = val + ((size_t)b * n_qb + qb) * budget;
  for (int s = 0; s < budget; ++s) {
    if (!val_row[s]) continue;
    const int kb = idx_row[s];
    if (causal && kb * bk > q_first + bq - 1) continue;  // wholly masked
    const size_t base = ((size_t)b * n_k + (size_t)kb * bk) * D;
    __syncthreads();  // the previous slot's readers are done
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
                   const void* q, const void* k, const void* v,
                   const void* idx, const void* val, void* out, int n_q,
                   int n_k, int bq, int bk, int budget, int causal,
                   int q_offset, float sm_scale) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(block_sparse_attention_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  block_sparse_attention_kernel<D><<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int32_t*)idx, (const int32_t*)val,
      (__nv_bfloat16*)out, n_q, n_k, bq, bk, budget, causal, q_offset,
      sm_scale);
}

extern "C" int block_sparse_attention(
    const void* q, const void* k, const void* v, const void* idx,
    const void* val, void* out, int bh, int n_q, int n_k, int d, int bq,
    int bk, int budget, int causal, int q_offset, float sm_scale,
    void* stream) {
  cudaGetLastError();
  const dim3 grid(n_q / bq, bh);
  const int threads = 2 * bq;
  const size_t smem = 2 * sizeof(__nv_bfloat16) * (size_t)bk * d;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16:
      launch<16>(grid, threads, smem, st, q, k, v, idx, val, out, n_q, n_k,
                 bq, bk, budget, causal, q_offset, sm_scale);
      break;
    case 32:
      launch<32>(grid, threads, smem, st, q, k, v, idx, val, out, n_q, n_k,
                 bq, bk, budget, causal, q_offset, sm_scale);
      break;
    case 64:
      launch<64>(grid, threads, smem, st, q, k, v, idx, val, out, n_q, n_k,
                 bq, bk, budget, causal, q_offset, sm_scale);
      break;
    case 128:
      launch<128>(grid, threads, smem, st, q, k, v, idx, val, out, n_q, n_k,
                  bq, bk, budget, causal, q_offset, sm_scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
