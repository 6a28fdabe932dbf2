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
//   Bound by bytes: q, the survivor tiles (read once per query block)
//   and the output. The design keeps those bytes streaming and the
//   arithmetic off the critical path, on the tile engine of
//   flash_common.cuh (B11's): blocks of 64 query rows on the wgmma path
//   (two to an SM; a query block of 128 is two blocks reading one table
//   row), else one block per query block. A block first reads its B
//   survivor ids and valid bits and keeps, in table order, the slots
//   that are valid and not wholly above its rows' diagonal (skipping
//   either leaves the result bit-identical: corr = 1, p = 0); each kept
//   key block enters the ring as ⌈bk/64⌉ tiles of at most 64 keys, so
//   survivors s + 1 and s + 2 are in flight while survivor s computes on
//   the tensor cores, with P split into two bf16 halves for f32 accuracy.
//   Query blocks are launched in reverse order, and the blocks of one bh
//   row run together, sharing its K/V in L2.
#include "flash_common.cuh"

template <int D>
__global__ void __launch_bounds__(256) block_sparse_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ val, __nv_bfloat16* __restrict__ out,
    int n_q, int n_k, int bq, int rows, int bk, int budget, int causal,
    int q_offset, float sm_scale) {
  // rows: this block's query rows (flash::block_rows), a part of the
  // query block of bq rows whose survivor table it reads
  const int n_qb = n_q / bq;
  const int x = gridDim.x - 1 - blockIdx.x, b = blockIdx.y;
  const int qb = x * rows / bq;
  const size_t row0 = (size_t)b * n_q + (size_t)x * rows;
  const int q_first = q_offset + x * rows, q_last = q_first + rows - 1;
  __nv_bfloat16* smem = flash::smem_base();
  int* kept = reinterpret_cast<int*>(
      smem + (size_t)(rows + 2 * flash::STAGES * flash::KT) * D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  flash::issue_q<D>(smem, q + row0 * D, rows);

  // the kept survivor blocks, in table order, and their count
  if (warp == 0) {
    const int* idx_row = idx + ((size_t)b * n_qb + qb) * budget;
    const int* val_row = val + ((size_t)b * n_qb + qb) * budget;
    int n = 0;
    for (int s0 = 0; s0 < budget; s0 += 32) {
      const int s = s0 + lane;
      int kb = 0;
      bool keep = false;
      if (s < budget) {
        kb = idx_row[s];
        keep = val_row[s] != 0 && !(causal && kb * bk > q_last);
      }
      const unsigned mask = __ballot_sync(0xffffffffu, keep);
      if (keep) kept[n + __popc(mask & ((1u << lane) - 1))] = kb;
      n += __popc(mask);
    }
    if (lane == 0) kept[budget] = n;
  }
  __syncthreads();

  const int per = (bk + flash::KT - 1) / flash::KT;  // ring tiles per block
  const auto tiles = [kept, bk, per](int t, int& src, int& kpos0, int& nv) {
    const int c = t % per;
    kpos0 = kept[t / per] * bk + c * flash::KT;
    src = kpos0;
    nv = min(flash::KT, bk - c * flash::KT);
  };
  const size_t krow0 = (size_t)b * n_k * D;
  flash::run<D>(k + krow0, v + krow0, out + row0 * D, smem, rows,
                flash::Contiguous{q_first}, q_last, causal != 0, sm_scale,
                kept[budget] * per, tiles);
}

template <int D>
static void launch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const void* q, const void* k, const void* v,
                   const void* idx, const void* val, void* out, int n_q,
                   int n_k, int bq, int rows, int bk, int budget, int causal,
                   int q_offset, float sm_scale) {
  static size_t given[64];
  flash::allow_smem(block_sparse_attention_kernel<D>, smem, given);
  block_sparse_attention_kernel<D><<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int32_t*)idx, (const int32_t*)val,
      (__nv_bfloat16*)out, n_q, n_k, bq, rows, bk, budget, causal, q_offset,
      sm_scale);
}

extern "C" int block_sparse_attention(
    const void* q, const void* k, const void* v, const void* idx,
    const void* val, void* out, int bh, int n_q, int n_k, int d, int bq,
    int bk, int budget, int causal, int q_offset, float sm_scale,
    void* stream) {
  cudaGetLastError();
  const int rows = flash::block_rows(d, bq);
  const dim3 grid(n_q / rows, bh);
  const int threads = 2 * rows;  // one warp per 16 query rows
  // the engine's stage and ring, then the kept list and its count
  const size_t smem =
      flash::smem_bytes(d, rows) + sizeof(int) * (budget + 1);
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16:
      launch<16>(grid, threads, smem, st, q, k, v, idx, val, out, n_q, n_k,
                 bq, rows, bk, budget, causal, q_offset, sm_scale);
      break;
    case 32:
      launch<32>(grid, threads, smem, st, q, k, v, idx, val, out, n_q, n_k,
                 bq, rows, bk, budget, causal, q_offset, sm_scale);
      break;
    case 64:
      launch<64>(grid, threads, smem, st, q, k, v, idx, val, out, n_q, n_k,
                 bq, rows, bk, budget, causal, q_offset, sm_scale);
      break;
    case 128:
      launch<128>(grid, threads, smem, st, q, k, v, idx, val, out, n_q, n_k,
                  bq, rows, bk, budget, causal, q_offset, sm_scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
