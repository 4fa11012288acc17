// Fused TransH score + rank count for link-prediction evaluation (sm_90a),
// kernel B6.
//
// Replaces the TPU kernel
// openkeonspark_tpu/ops/pallas_rank.py::_count_kernel_transh (reached
// through count_better_transh): for each query c, with w_c the unit normal
// of its relation,
//
//   counts[c] = #{ e < n_ent, e != gold_ids[c] :
//                  ||q_c + sign * (E[e] - (w_c . E[e]) w_c)||_p < gold[c] }
//
// and an id scorer for the gold and known-true ids of each query (the
// counterpart of pallas_rank.py::transh_candidate_scores).
//
// The dot w_c . E[e] depends on the (query, candidate) pair and is needed,
// whole, before the first residual lane. Each block therefore sweeps its
// candidates' d-chunks twice: pass 1 sums the 16 pairwise dots of a thread
// (w_c[d] * e[d], d = 0 .. D-1 in sequence), pass 2 the residual norm with
// pe = e[d] - dot * w_c[d], r = q_c[d] + sign * pe. The second read of a
// candidate chunk comes from L2: the 32.8 MB WN18RR table (40,944 x 200
// fp32) fits in the H100's 50 MB. The id scorer runs the same two sums for
// one (query, id) pair, so counts and scores are tie-exact and equal the
// plain version in ops/rank.py bit for bit (rank_common.cuh). The TPU kernel
// took the dot as one HIGHEST-precision MXU contraction; the two packages
// differ only in the float-tie class of pallas_rank.py:39-46.
//
// What bounds it on an H100: fp32 ALU work, about 1.7x B1's (a dot step and
// four residual operations per lane and query). Tensor cores for pass 1
// are later work.

#include "rank_common.cuh"

namespace {

using namespace okst;

__device__ __forceinline__ float dot_step(float dot, float w, float e) {
  return __fadd_rn(dot, __fmul_rn(w, e));
}

template <int P>
__device__ __forceinline__ float transh_step(float acc, float q, float w,
                                             float e, float dot, float sign) {
  const float pe = __fsub_rn(e, __fmul_rn(dot, w));
  return norm_step<P>(acc, __fadd_rn(q, __fmul_rn(sign, pe)));
}

template <int P>
__global__ void __launch_bounds__(kCandTile)
count_better_transh_kernel(const float* __restrict__ q,
                           const float* __restrict__ w,
                           const float* __restrict__ table,
                           const float* __restrict__ gold,
                           const int* __restrict__ gold_ids,
                           int* __restrict__ counts, int C, int D, int n_ent,
                           float sign) {
  __shared__ float qs[kDChunk][kQueryTile];
  __shared__ float ws[kDChunk][kQueryTile];
  __shared__ float es[kDChunk][kCandTile + 1];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCandTile;
  const int q0 = blockIdx.y * kQueryTile;

  float dot[kQueryTile], acc[kQueryTile];
#pragma unroll
  for (int j = 0; j < kQueryTile; ++j) dot[j] = acc[j] = 0.0f;

  // pass 1: the pairwise dots
  for (int d0 = 0; d0 < D; d0 += kDChunk) {
    const int dn = min(kDChunk, D - d0);
    stage<kQueryTile>(ws, w, q0, C, D, d0, dn);
    stage<kCandTile>(es, table, c0, n_ent, D, d0, dn);
    __syncthreads();
    for (int dd = 0; dd < dn; ++dd) {
      const float e = es[dd][tid];
#pragma unroll
      for (int j = 0; j < kQueryTile; ++j) dot[j] = dot_step(dot[j], ws[dd][j], e);
    }
    __syncthreads();
  }
  // pass 2: the residual norm
  for (int d0 = 0; d0 < D; d0 += kDChunk) {
    const int dn = min(kDChunk, D - d0);
    stage<kQueryTile>(qs, q, q0, C, D, d0, dn);
    stage<kQueryTile>(ws, w, q0, C, D, d0, dn);
    stage<kCandTile>(es, table, c0, n_ent, D, d0, dn);
    __syncthreads();
    for (int dd = 0; dd < dn; ++dd) {
      const float e = es[dd][tid];
#pragma unroll
      for (int j = 0; j < kQueryTile; ++j) {
        acc[j] = transh_step<P>(acc[j], qs[dd][j], ws[dd][j], e, dot[j], sign);
      }
    }
    __syncthreads();
  }
  count_tile(acc, c0 + tid, q0, C, n_ent, gold, gold_ids, counts);
}

// out[c, k] = the TransH score of id ids[c, k] for query c, through the
// count kernel's two sums; an id outside [0, rows) gives NaN.
template <int P>
__global__ void transh_score_ids_kernel(const float* __restrict__ q,
                                        const float* __restrict__ w,
                                        const float* __restrict__ table,
                                        const int* __restrict__ ids,
                                        float* __restrict__ out, int C, int K,
                                        int D, int rows, float sign) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(C) * K) return;
  const int c = static_cast<int>(i / K);
  const int id = ids[i];
  if (id < 0 || id >= rows) {
    out[i] = quiet_nan();
    return;
  }
  const float* q_row = q + static_cast<size_t>(c) * D;
  const float* w_row = w + static_cast<size_t>(c) * D;
  const float* e_row = table + static_cast<size_t>(id) * D;
  float dot = 0.0f;
  for (int d = 0; d < D; ++d) dot = dot_step(dot, w_row[d], e_row[d]);
  float acc = 0.0f;
  for (int d = 0; d < D; ++d) {
    acc = transh_step<P>(acc, q_row[d], w_row[d], e_row[d], dot, sign);
  }
  out[i] = acc;
}

}  // namespace

extern "C" int okst_count_better_transh(const float* q, const float* w,
                                        const float* table, const float* gold,
                                        const int* gold_ids, int* counts,
                                        int C, int D, int n_ent, float sign,
                                        int p, void* stream) {
  if (p != 1 && p != 2) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = count_grid(n_ent, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 1) {
    count_better_transh_kernel<1><<<grid, kCandTile, 0, s>>>(
        q, w, table, gold, gold_ids, counts, C, D, n_ent, sign);
  } else {
    count_better_transh_kernel<2><<<grid, kCandTile, 0, s>>>(
        q, w, table, gold, gold_ids, counts, C, D, n_ent, sign);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int okst_transh_score_ids(const float* q, const float* w,
                                     const float* table, const int* ids,
                                     float* out, int C, int K, int D,
                                     int rows, float sign, int p,
                                     void* stream) {
  if (p != 1 && p != 2) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = id_blocks(C, K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 1) {
    transh_score_ids_kernel<1><<<blocks, kIdThreads, 0, s>>>(
        q, w, table, ids, out, C, K, D, rows, sign);
  } else {
    transh_score_ids_kernel<2><<<blocks, kIdThreads, 0, s>>>(
        q, w, table, ids, out, C, K, D, rows, sign);
  }
  return static_cast<int>(cudaGetLastError());
}
