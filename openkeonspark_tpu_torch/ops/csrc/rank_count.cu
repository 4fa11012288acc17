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
// Order of operations is part of the contract. The count and the id scorer
// take the same rounded steps: the sum runs over d = 0 .. D-1 in sequence,
// in fp32, with __fadd_rn / __fsub_rn / __fmul_rn so that no step is
// contracted into an FMA. sign is +-1, so sign * e is an exact negation:
// the count and the id scorer, templated on the sign, take q + e or q - e,
// the plain version q + sign * e, the same value. Gold, known and candidate
// scores are therefore bit-identical for the same (query, entity) pair,
// ranks are tie-exact, and the plain PyTorch version in ops/rank.py, which
// takes the same steps, agrees bit for bit.
//
// What bounds it on an H100: fp32 issue. Per (query, candidate, lane) the
// count takes 2 rounded operations at p = 1 (q +- e, then acc + |r|) and 3
// at p = 2; at the serving slice (C = 256, 14,541 entities, D = 200) that is
// 744 M lane terms, 44.4 us at 2 instructions per term and 33.5 T fp32
// instructions/s. The 11.6 MB entity table stays in the 50 MB L2, so device
// memory does not bound it. The count is rank_tiled.cuh's register-tiled
// design (4 x 4 tiles, float4 lane reads, a cp.async double buffer, sign
// templates) with TransETerm as its lane term; at 2 instructions per term
// its 8 LDS.128 per 64 terms and the staging copies weigh more than in
// B2 or B3. The id scorer is rank_ids.cuh's warp-slice scorer with
// TransEIds as its lane term (latency-bound; see there).
//
// Plain C interface, loaded with ctypes (ops/build.py); each launcher
// returns the cudaError_t of its launch.

#include "rank_ids.cuh"
#include "rank_tiled.cuh"

namespace {

using namespace okst;

// The count's lane term: r = q + SIGN * e, then acc + |r| (P = 1) or
// acc + r * r (P = 2).
template <int SIGN, int P>
struct TransETerm {
  static constexpr int kOperands = 1;  // q
  static constexpr bool kScalar = false;
  __device__ static __forceinline__ float step(float acc,
                                               const float (&qv)[1], float e,
                                               float) {
    return norm_step<P>(acc, tiled::signed_add<SIGN>(qv[0], e));
  }
};

// The id scorer's lane term: the same steps, from the query's and the
// row's value at the lane.
template <int SIGN, int P>
struct TransEIds : id_scorer::TermDefaults {
  static constexpr int kQ = 1, kE = 1;
  __device__ static __forceinline__ float step(float acc,
                                               const float (&q)[1],
                                               const float (&e)[1], float) {
    return norm_step<P>(acc, tiled::signed_add<SIGN>(q[0], e[0]));
  }
};

template <int SIGN, int P>
int score_ids(const float* q, const float* table, const int* ids, float* out,
              int C, int K, int D, int rows, void* stream) {
  return id_scorer::score_ids<TransEIds<SIGN, P>>(
      {{q}, D, table, {0}, D}, ids, out, C, K, D, rows, stream);
}

}  // namespace

extern "C" int okst_count_better_transe(const float* q, const float* table,
                                        const float* gold,
                                        const int* gold_ids, int* counts,
                                        int C, int D, int n_ent, float sign,
                                        int p, void* stream) {
  return tiled::count<TransETerm>({{q}}, table, nullptr, gold, gold_ids,
                                  counts, C, D, n_ent, sign, p, stream);
}

extern "C" int okst_transe_score_ids(const float* q, const float* table,
                                     const int* ids, float* out, int C,
                                     int K, int D, int rows, float sign,
                                     int p, void* stream) {
  if (p != 1 && p != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (sign > 0) {
    return p == 1
               ? score_ids<1, 1>(q, table, ids, out, C, K, D, rows, stream)
               : score_ids<1, 2>(q, table, ids, out, C, K, D, rows, stream);
  }
  return p == 1
             ? score_ids<-1, 1>(q, table, ids, out, C, K, D, rows, stream)
             : score_ids<-1, 2>(q, table, ids, out, C, K, D, rows, stream);
}
