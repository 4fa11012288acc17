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
// whole, before the first residual lane. So the count sweeps its candidate
// tile twice in one kernel, with rank_tiled.cuh's sweep() (4 candidates x 4
// queries a thread, float4 lane reads, a cp.async double buffer, the sign a
// template parameter): sweep 1 sums the thread's 16 pairwise dots in
// registers (dot + w_c[d] * e[d], d = 0 .. D-1 in sequence: DotTerm over
// the operand row w), sweep 2 the residual norm with pe = e[d] - dot *
// w_c[d], r = q_c[d] +- pe (ResidualTerm over q and w, the pair's dot as
// its scalar). The id scorer, rank_ids.cuh's warp-slice scorer with
// TransHIds as its lane term, runs the same two sums for each (query, id)
// pair, the dot a first pass over the staged row, so counts and scores are
// tie-exact and equal the plain version in ops/rank.py bit for bit. The
// TPU kernel took the dot as one HIGHEST-precision MXU contraction; the two
// packages differ only in the float-tie class of pallas_rank.py:39-46.
//
// What bounds it on an H100: fp32 issue, 6 rounded operations per (query,
// candidate, lane) at p = 1 (mul, add for the dot; mul, sub, add, add for
// the residual) and 7 at p = 2: at the TransH slice (C = 256, D = 200,
// 40,943 entities) 2.10 G lane terms, 375.5 us at 33.5 T fp32
// instructions/s. Both sweeps stream the candidate tile from L2: the 32.8 MB
// WN18RR table (40,944 x 200 fp32) fits in the H100's 50 MB, and the 320 x
// 16 blocks re-read each tile 32 times, the L2 rate B1 sustains. What sets
// its time is the number of resident warps: asked for 4 blocks an SM, ptxas
// takes 104 to 127 registers (0.62 ms at the slice); held to 80 (6 blocks,
// 24 warps, 8 bytes of spill) the count takes 0.57 ms; at 72 (7 blocks) it
// spills more and takes 0.61 ms. A block is kWarps warps of 4 queries. With
// 8 warps (32 queries a block, half the re-reads of the table, 3 resident
// blocks: the same 24 warps) it takes 0.57 ms too, so the L2 re-reads are
// not what bounds it. chip_smoke.py builds these three variants and times
// them beside the port's (NVIDIA H100 80GB HBM3, 700 W). No tensor cores:
// the dot's rounding order is part of the contract.

#include "rank_ids.cuh"
#include "rank_tiled.cuh"

namespace {

using namespace okst;

constexpr int kWarps = 4;        // query groups of 4 per block
constexpr int kBlocksPerSM = 6;  // resident blocks asked of ptxas: 80 registers

// dot + w * e
__device__ __forceinline__ float dot_step(float dot, float w, float e) {
  return __fadd_rn(dot, __fmul_rn(w, e));
}

// pe = e - dot * w, r = q + SIGN * pe, then acc + |r| (P = 1) or
// acc + r * r (P = 2)
template <int SIGN, int P>
__device__ __forceinline__ float residual_step(float acc, float q, float w,
                                               float e, float dot) {
  const float pe = __fsub_rn(e, __fmul_rn(dot, w));
  return norm_step<P>(acc, tiled::signed_add<SIGN>(q, pe));
}

// Sweep 1's lane term.
struct DotTerm {
  static constexpr int kOperands = 1;  // w
  __device__ static __forceinline__ float step(float dot,
                                               const float (&qv)[1], float e,
                                               float) {
    return dot_step(dot, qv[0], e);
  }
};

// Sweep 2's lane term, with the pair's dot as its scalar.
template <int SIGN, int P>
struct ResidualTerm {
  static constexpr int kOperands = 2;  // q, w
  __device__ static __forceinline__ float step(float acc,
                                               const float (&qv)[2], float e,
                                               float dot) {
    return residual_step<SIGN, P>(acc, qv[0], qv[1], e, dot);
  }
};

// The id scorer's lane terms: a first pass of dot_step over w and the row
// (kDot = 1: the query's column w), then residual_step over q, w and the
// row with the pair's dot, the count's two sweeps for one pair. No
// kRecompute: both passes take the plain version's rounded operations in
// its order, with no square root or other function whose fast path differs
// from the plain version's outside the finite range, so a dot or a sum that
// overflows, or a NaN, already gives the plain version's inf or NaN (card
// test).
template <int SIGN, int P>
struct TransHIds : id_scorer::TermDefaults {
  static constexpr int kQ = 2, kE = 1;  // q, w; E[id]
  static constexpr int kDot = 1;        // the dot's query column: w
  __device__ static __forceinline__ float dot_step(float dot, float w,
                                                   float e) {
    return ::dot_step(dot, w, e);
  }
  __device__ static __forceinline__ float step(float acc,
                                               const float (&q)[2],
                                               const float (&e)[1],
                                               float dot) {
    return residual_step<SIGN, P>(acc, q[0], q[1], e[0], dot);
  }
};

struct NoScalar {
  __device__ __forceinline__ float get(int, int) const { return 0.0f; }
};

template <int SIGN, int P, bool VEC>
__global__ void __launch_bounds__(32 * kWarps, kBlocksPerSM)
count_better_transh_kernel(const float* __restrict__ q,
                           const float* __restrict__ w,
                           const float* __restrict__ table,
                           const float* __restrict__ gold,
                           const int* __restrict__ gold_ids,
                           int* __restrict__ counts, int C, int D,
                           int n_ent) {
  using tiled::kCands;
  using tiled::kQueries;
  // sweep 2's stages (candidates, q, w); sweep 1 uses the front of the same
  // memory as its own (candidates, w)
  __shared__ __align__(16) tiled::Stage<2, kWarps> stages[2];
  const int c0 = blockIdx.x * tiled::kBlockCands;
  const int q0 = blockIdx.y * kWarps * kQueries;

  float dot[kQueries][kCands], acc[kQueries][kCands];
#pragma unroll
  for (int j = 0; j < kQueries; ++j) {
#pragma unroll
    for (int k = 0; k < kCands; ++k) dot[j][k] = acc[j][k] = 0.0f;
  }
  tiled::sweep<DotTerm, VEC, kWarps>(
      dot, NoScalar{}, reinterpret_cast<tiled::Stage<1, kWarps>*>(stages),
      {{w}}, table, q0, C, c0, n_ent, D);
  tiled::sweep<ResidualTerm<SIGN, P>, VEC, kWarps>(
      acc, tiled::PerPair{dot}, stages, {{q, w}}, table, q0, C, c0, n_ent, D);
  tiled::finish_counts(acc, gold, gold_ids, counts, q0, C, c0, n_ent);
}

template <int SIGN, int P>
void launch_count(const float* q, const float* w, const float* table,
                  const float* gold, const int* gold_ids, int* counts, int C,
                  int D, int n_ent, cudaStream_t s) {
  const dim3 grid = tiled::count_grid<kWarps>(n_ent, C);
  if (tiled::vector_copies<2>({{q, w}}, table, D)) {
    count_better_transh_kernel<SIGN, P, true><<<grid, 32 * kWarps, 0, s>>>(
        q, w, table, gold, gold_ids, counts, C, D, n_ent);
  } else {
    count_better_transh_kernel<SIGN, P, false><<<grid, 32 * kWarps, 0, s>>>(
        q, w, table, gold, gold_ids, counts, C, D, n_ent);
  }
}

template <int SIGN, int P>
int score_ids(const id_scorer::Operands<2, 1>& ops, const int* ids,
              float* out, int C, int K, int D, int rows, void* stream) {
  return id_scorer::score_ids<TransHIds<SIGN, P>>(ops, ids, out, C, K, D,
                                                  rows, stream);
}

}  // namespace

extern "C" int okst_count_better_transh(const float* q, const float* w,
                                        const float* table, const float* gold,
                                        const int* gold_ids, int* counts,
                                        int C, int D, int n_ent, float sign,
                                        int p, void* stream) {
  if ((p != 1 && p != 2) || C < 1 || D < 1 || n_ent < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sign > 0 && p == 1) {
    launch_count<1, 1>(q, w, table, gold, gold_ids, counts, C, D, n_ent, s);
  } else if (sign > 0) {
    launch_count<1, 2>(q, w, table, gold, gold_ids, counts, C, D, n_ent, s);
  } else if (p == 1) {
    launch_count<-1, 1>(q, w, table, gold, gold_ids, counts, C, D, n_ent, s);
  } else {
    launch_count<-1, 2>(q, w, table, gold, gold_ids, counts, C, D, n_ent, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int okst_transh_score_ids(const float* q, const float* w,
                                     const float* table, const int* ids,
                                     float* out, int C, int K, int D,
                                     int rows, float sign, int p,
                                     void* stream) {
  if (p != 1 && p != 2) return static_cast<int>(cudaErrorInvalidValue);
  const id_scorer::Operands<2, 1> ops{{q, w}, D, table, {0}, D, nullptr};
  if (sign > 0) {
    return p == 1 ? score_ids<1, 1>(ops, ids, out, C, K, D, rows, stream)
                  : score_ids<1, 2>(ops, ids, out, C, K, D, rows, stream);
  }
  return p == 1 ? score_ids<-1, 1>(ops, ids, out, C, K, D, rows, stream)
                : score_ids<-1, 2>(ops, ids, out, C, K, D, rows, stream);
}
