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
// d = 0 .. D-1 in sequence, every step rounded on its own (no FMA), as the
// plain versions in ops/rank.py take them: kernel == plain bit for bit.
// sign * pe is an exact negation, so the count (templated on the sign) takes
// q + pe or q - pe directly.
//
// What bounds it on an H100: fp32 issue. Per (query, candidate, lane) the
// count takes 4 rounded operations at p = 1 (cdot * rp, e + ., q +- pe,
// acc + |r|) and 5 at p = 2; at the serving slice (C = 256, 14,541
// entities, D = 200) that is 744 M lane terms, 88.9 us at 4 instructions
// per term and 33.5 T fp32 instructions/s. The table (11.6 MB) and cdot stay
// in L2. The count is rank_tiled.cuh's register-tiled design with TransDTerm
// as its lane term: 4 x 4 tiles, each thread's 4 candidates' cdot in
// registers, q, rp and the candidates read as float4s (12 LDS.128 per 64
// lane terms instead of 2 loads per term), a cp.async double buffer of the
// three tiles, sign templates. The id scorer is rank_ids.cuh's warp-slice
// scorer with TransDIds as its lane term and cdot[id] as its per-id scalar
// (latency-bound; see there).

#include "rank_ids.cuh"
#include "rank_tiled.cuh"

namespace {

using namespace okst;

// pe = e + cdot * rp, r = q + SIGN * pe, then acc + |r| (P = 1) or
// acc + r * r (P = 2)
template <int SIGN, int P>
__device__ __forceinline__ float transd_step(float acc, float q, float rp,
                                             float e, float cdot) {
  const float pe = __fadd_rn(e, __fmul_rn(cdot, rp));
  return norm_step<P>(acc, tiled::signed_add<SIGN>(q, pe));
}

// The count's lane term.
template <int SIGN, int P>
struct TransDTerm {
  static constexpr int kOperands = 2;   // q, rp
  static constexpr bool kScalar = true;  // cdot
  __device__ static __forceinline__ float step(float acc,
                                               const float (&qv)[2], float e,
                                               float cdot) {
    return transd_step<SIGN, P>(acc, qv[0], qv[1], e, cdot);
  }
};

// The id scorer's lane term: the same steps, from the query's q and rp and
// the row's value at the lane, with the id's cdot as the pair's scalar. No
// kRecompute: the scorer takes the plain version's rounded operations in
// its order, with no square root or other function whose fast path differs
// from the plain version's outside the finite range, so an overflowing or
// NaN pair already gives the plain version's inf or NaN (card test).
template <int SIGN, int P>
struct TransDIds : id_scorer::TermDefaults {
  static constexpr int kQ = 2, kE = 1;   // q, rp; E[id]
  static constexpr bool kIdScalar = true;  // cdot[id]
  __device__ static __forceinline__ float step(float acc,
                                               const float (&q)[2],
                                               const float (&e)[1],
                                               float cdot) {
    return transd_step<SIGN, P>(acc, q[0], q[1], e[0], cdot);
  }
};

template <int SIGN, int P>
int score_ids(const id_scorer::Operands<2, 1>& ops, const int* ids,
              float* out, int C, int K, int D, int rows, void* stream) {
  return id_scorer::score_ids<TransDIds<SIGN, P>>(ops, ids, out, C, K, D,
                                                  rows, stream);
}

}  // namespace

extern "C" int okst_count_better_transd(const float* q, const float* rp,
                                        const float* table, const float* cdot,
                                        const float* gold,
                                        const int* gold_ids, int* counts,
                                        int C, int D, int n_ent, float sign,
                                        int p, void* stream) {
  return tiled::count<TransDTerm>({{q, rp}}, table, cdot, gold, gold_ids,
                                  counts, C, D, n_ent, sign, p, stream);
}

extern "C" int okst_transd_score_ids(const float* q, const float* rp,
                                     const float* table, const float* cdot,
                                     const int* ids, float* out, int C, int K,
                                     int D, int rows, float sign, int p,
                                     void* stream) {
  if (p != 1 && p != 2) return static_cast<int>(cudaErrorInvalidValue);
  const id_scorer::Operands<2, 1> ops{{q, rp}, D, table, {0}, D, cdot};
  if (sign > 0) {
    return p == 1 ? score_ids<1, 1>(ops, ids, out, C, K, D, rows, stream)
                  : score_ids<1, 2>(ops, ids, out, C, K, D, rows, stream);
  }
  return p == 1 ? score_ids<-1, 1>(ops, ids, out, C, K, D, rows, stream)
                : score_ids<-1, 2>(ops, ids, out, C, K, D, rows, stream);
}
