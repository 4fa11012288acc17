// Fused TransD score + rank count for link-prediction evaluation (sm_90a),
// kernel B2.
//
// Replaces the TPU kernel
// openkeonspark_tpu/ops/pallas_rank.py::_count_kernel_transd (reached
// through count_better_transd): for each query c, with rp_c the transfer
// vector of its relation and cdot[e] = E[e] . E_p[e] the per-entity transfer
// dot,
//
//   counts[c] = #{ e < n_ent, e != gold_ids[c] :
//                  ||q_c + sign * (E[e] + cdot[e] rp_c)||_p < gold[c] }
//
// and an id scorer for the gold and known-true ids of each query (the
// counterpart of pallas_rank.py::transd_candidate_scores).
//
// cdot is a property of the table, computed once per evaluation by the
// caller (ops/rank.py::transd_cdot) and read here, by the id scorer and by
// the plain versions from the same tensor, so its rounding is shared. Per
// lane: pe = e[d] + cdot * rp_c[d], r = q_c[d] + sign * pe, summed over
// d = 0 .. D-1 in sequence (rank_common.cuh: FMA-free, bit for bit with
// ops/rank.py). Each thread reads its candidate's cdot once.
//
// What bounds it on an H100: fp32 ALU work, about 1.7x B1's (two more
// operations per lane and query); the FB15K-237 table (11.6 MB) and cdot
// stay in L2.

#include "rank_common.cuh"

namespace {

using namespace okst;

template <int P>
__device__ __forceinline__ float transd_step(float acc, float q, float rp,
                                             float e, float cdot, float sign) {
  const float pe = __fadd_rn(e, __fmul_rn(cdot, rp));
  return norm_step<P>(acc, __fadd_rn(q, __fmul_rn(sign, pe)));
}

template <int P>
__global__ void __launch_bounds__(kCandTile)
count_better_transd_kernel(const float* __restrict__ q,
                           const float* __restrict__ rp,
                           const float* __restrict__ table,
                           const float* __restrict__ cdot,
                           const float* __restrict__ gold,
                           const int* __restrict__ gold_ids,
                           int* __restrict__ counts, int C, int D, int n_ent,
                           float sign) {
  __shared__ float qs[kDChunk][kQueryTile];
  __shared__ float rps[kDChunk][kQueryTile];
  __shared__ float es[kDChunk][kCandTile + 1];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCandTile;
  const int q0 = blockIdx.y * kQueryTile;
  const int e = c0 + tid;
  const float cd = e < n_ent ? cdot[e] : 0.0f;

  float acc[kQueryTile];
#pragma unroll
  for (int j = 0; j < kQueryTile; ++j) acc[j] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += kDChunk) {
    const int dn = min(kDChunk, D - d0);
    stage<kQueryTile>(qs, q, q0, C, D, d0, dn);
    stage<kQueryTile>(rps, rp, q0, C, D, d0, dn);
    stage<kCandTile>(es, table, c0, n_ent, D, d0, dn);
    __syncthreads();
    for (int dd = 0; dd < dn; ++dd) {
      const float ev = es[dd][tid];
#pragma unroll
      for (int j = 0; j < kQueryTile; ++j) {
        acc[j] = transd_step<P>(acc[j], qs[dd][j], rps[dd][j], ev, cd, sign);
      }
    }
    __syncthreads();
  }
  count_tile(acc, e, q0, C, n_ent, gold, gold_ids, counts);
}

// out[c, k] = the TransD score of id ids[c, k] for query c, through the
// count kernel's steps; an id outside [0, rows) gives NaN.
template <int P>
__global__ void transd_score_ids_kernel(const float* __restrict__ q,
                                        const float* __restrict__ rp,
                                        const float* __restrict__ table,
                                        const float* __restrict__ cdot,
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
  const float* rp_row = rp + static_cast<size_t>(c) * D;
  const float* e_row = table + static_cast<size_t>(id) * D;
  const float cd = cdot[id];
  float acc = 0.0f;
  for (int d = 0; d < D; ++d) {
    acc = transd_step<P>(acc, q_row[d], rp_row[d], e_row[d], cd, sign);
  }
  out[i] = acc;
}

}  // namespace

extern "C" int okst_count_better_transd(const float* q, const float* rp,
                                        const float* table, const float* cdot,
                                        const float* gold,
                                        const int* gold_ids, int* counts,
                                        int C, int D, int n_ent, float sign,
                                        int p, void* stream) {
  if (p != 1 && p != 2) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = count_grid(n_ent, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 1) {
    count_better_transd_kernel<1><<<grid, kCandTile, 0, s>>>(
        q, rp, table, cdot, gold, gold_ids, counts, C, D, n_ent, sign);
  } else {
    count_better_transd_kernel<2><<<grid, kCandTile, 0, s>>>(
        q, rp, table, cdot, gold, gold_ids, counts, C, D, n_ent, sign);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int okst_transd_score_ids(const float* q, const float* rp,
                                     const float* table, const float* cdot,
                                     const int* ids, float* out, int C, int K,
                                     int D, int rows, float sign, int p,
                                     void* stream) {
  if (p != 1 && p != 2) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = id_blocks(C, K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 1) {
    transd_score_ids_kernel<1><<<blocks, kIdThreads, 0, s>>>(
        q, rp, table, cdot, ids, out, C, K, D, rows, sign);
  } else {
    transd_score_ids_kernel<2><<<blocks, kIdThreads, 0, s>>>(
        q, rp, table, cdot, ids, out, C, K, D, rows, sign);
  }
  return static_cast<int>(cudaGetLastError());
}
