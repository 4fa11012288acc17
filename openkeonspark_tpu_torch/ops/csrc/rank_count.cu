// Fused TransE score + rank count for link-prediction evaluation (sm_90a).
//
// Replaces the TPU kernel openkeonspark_tpu/ops/pallas_rank.py::_count_kernel
// (reached through count_better_transe): for each query c,
//
//   counts[c] = #{ e < n_ent, e != gold_ids[c] : ||q_c + sign * E[e]||_p < gold[c] }
//
// with p=1 the sum of |.|, p=2 the sum of squares, and queries whose
// gold_ids[c] == -1 (padding) counting 0. A second launcher scores explicit
// ids (the gold entity and the known-true entities of each query), the
// counterpart of pallas_rank.py::transe_candidate_scores.
//
// Order of operations is part of the contract. Both launchers go through the
// same residual-norm routine, dist / norm_step: the sum runs over
// d = 0 .. D-1 in sequence, in fp32, with __fadd_rn / __fmul_rn so that no
// step is contracted into an FMA. sign is +-1, so sign * e is exact. Gold,
// known and candidate scores are therefore bit-identical for the same
// (query, entity) pair, ranks are tie-exact, and the plain PyTorch version
// in ops/rank.py, which takes the same steps, agrees bit for bit.
//
// What bounds it on an H100: fp32 ALU work, 2 directions x 20466 test
// triples x 14541 entities x 200 lanes x ~3 operations at the FB15K-237
// shape; the 11.6 MB entity table stays resident in the 50 MB L2, so device
// memory bytes do not bound it. The design is the simple one of
// rank_common.cuh (128-candidate x 16-query tiles, d-chunks of 32 staged in
// shared memory, a ballot count per warp). Making it fast is later work;
// tensor cores may serve p=2 only with a gold path through the same
// arithmetic and no TF32.
//
// Plain C interface, loaded with ctypes (ops/build.py); each launcher
// returns the cudaError_t of its launch.

#include "rank_common.cuh"

namespace {

using namespace okst;

template <int P>
__device__ __forceinline__ float dist_step(float acc, float qv, float sev) {
  return norm_step<P>(acc, __fadd_rn(qv, sev));
}

// ||q_row + sign * e_row||_p over d = 0 .. D-1 in sequence.
template <int P>
__device__ float dist(const float* __restrict__ q_row,
                      const float* __restrict__ e_row, float sign, int D) {
  float acc = 0.0f;
  for (int d = 0; d < D; ++d) {
    acc = dist_step<P>(acc, q_row[d], __fmul_rn(sign, e_row[d]));
  }
  return acc;
}

// The 16 dist accumulations of a thread advance together, one dist_step per
// lane d in the same order as dist, so each equals dist(q_c, E[e]) exactly.
template <int P>
__global__ void __launch_bounds__(kCandTile)
count_better_kernel(const float* __restrict__ q,
                    const float* __restrict__ table,
                    const float* __restrict__ gold,
                    const int* __restrict__ gold_ids, int* __restrict__ counts,
                    int C, int D, int n_ent, float sign) {
  __shared__ __align__(16) float qs[kDChunk][kQueryTile];
  __shared__ float es[kDChunk][kCandTile + 1];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCandTile;
  const int q0 = blockIdx.y * kQueryTile;

  float acc[kQueryTile];
#pragma unroll
  for (int j = 0; j < kQueryTile; ++j) acc[j] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += kDChunk) {
    const int dn = min(kDChunk, D - d0);
    stage<kQueryTile>(qs, q, q0, C, D, d0, dn);
    stage<kCandTile>(es, table, c0, n_ent, D, d0, dn);
    __syncthreads();
    for (int dd = 0; dd < dn; ++dd) {
      const float sev = __fmul_rn(sign, es[dd][tid]);
      const float4* qv = reinterpret_cast<const float4*>(qs[dd]);
#pragma unroll
      for (int j4 = 0; j4 < kQueryTile / 4; ++j4) {
        const float4 v = qv[j4];
        acc[4 * j4 + 0] = dist_step<P>(acc[4 * j4 + 0], v.x, sev);
        acc[4 * j4 + 1] = dist_step<P>(acc[4 * j4 + 1], v.y, sev);
        acc[4 * j4 + 2] = dist_step<P>(acc[4 * j4 + 2], v.z, sev);
        acc[4 * j4 + 3] = dist_step<P>(acc[4 * j4 + 3], v.w, sev);
      }
    }
    __syncthreads();
  }
  count_tile(acc, c0 + tid, q0, C, n_ent, gold, gold_ids, counts);
}

// out[c, k] = dist(q_c, E[ids[c, k]]); an id outside [0, rows) gives NaN.
template <int P>
__global__ void score_ids_kernel(const float* __restrict__ q,
                                 const float* __restrict__ table,
                                 const int* __restrict__ ids,
                                 float* __restrict__ out, int C, int K, int D,
                                 int rows, float sign) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(C) * K) return;
  const int c = static_cast<int>(i / K);
  const int id = ids[i];
  out[i] = (id >= 0 && id < rows)
               ? dist<P>(q + static_cast<size_t>(c) * D,
                         table + static_cast<size_t>(id) * D, sign, D)
               : quiet_nan();
}

}  // namespace

extern "C" int okst_count_better_transe(const float* q, const float* table,
                                        const float* gold,
                                        const int* gold_ids, int* counts,
                                        int C, int D, int n_ent, float sign,
                                        int p, void* stream) {
  if (p != 1 && p != 2) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = count_grid(n_ent, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 1) {
    count_better_kernel<1><<<grid, kCandTile, 0, s>>>(
        q, table, gold, gold_ids, counts, C, D, n_ent, sign);
  } else {
    count_better_kernel<2><<<grid, kCandTile, 0, s>>>(
        q, table, gold, gold_ids, counts, C, D, n_ent, sign);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int okst_transe_score_ids(const float* q, const float* table,
                                     const int* ids, float* out, int C,
                                     int K, int D, int rows, float sign,
                                     int p, void* stream) {
  if (p != 1 && p != 2) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = id_blocks(C, K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 1) {
    score_ids_kernel<1><<<blocks, kIdThreads, 0, s>>>(q, table, ids, out, C,
                                                      K, D, rows, sign);
  } else {
    score_ids_kernel<2><<<blocks, kIdThreads, 0, s>>>(q, table, ids, out, C,
                                                      K, D, rows, sign);
  }
  return static_cast<int>(cudaGetLastError());
}
