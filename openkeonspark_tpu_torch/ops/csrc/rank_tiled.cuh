// The register-tiled rank count shared by kernels B1 (rank_count.cu,
// TransE), B2 (rank_count_transd.cu, TransD) and B6 (rank_count_transh.cu,
// TransH), sm_90a.
//
// For each query c,
//
//   counts[c] = #{ e < n_ent, e != gold_ids[c] : score(c, e) < gold[c] },
//
// 0 where gold_ids[c] == -1, with score(c, e) the sum over lanes
// d = 0 .. D-1, in that order, of one lane term. A Term policy gives the
// term: Term::step(acc, qv, e, s) adds the term of lane d to acc, from the
// query's operands at that lane (qv: Term::kOperands rows of [C, D], q and
// for TransD also r_p), the candidate's value E[e][d] and one scalar s that
// does not depend on the lane: a per-entity scalar read once per candidate
// (PerCandidate: TransD's cdot[e], where Term::kScalar) or a scalar of the
// (query, candidate) pair (PerPair: TransH's dot w_c . E[e]). Every
// operation is rounded on its own (__fadd_rn, __fsub_rn, __fmul_rn, no FMA),
// in the order of the plain versions in ops/rank.py, so the count equals
// them bit for bit.
//
// The sum over the lanes is one function, sweep(): count_kernel (B1, B2)
// calls it once; B6's kernel calls it twice over the same candidate tile,
// first for the pairwise dots, then for the residual that needs them whole.
//
// The design is that of B3 (rank_count_rotate.cu) with the lane term as a
// policy:
//   - register tiles: a block is 4 warps; each thread owns 4 candidates
//     (strided by 32) x 4 queries (its warp's), so 16 accumulators, and
//     keeps its candidates' scalars in registers;
//   - a 4-lane step reads the 4 queries' operands and the candidates' values
//     as float4s (LDS.128): the query reads are the same address across the
//     warp (broadcasts); candidate rows are padded to an odd number of
//     float4s, so 8 consecutive rows fall in 8 different bank groups;
//   - the next 16-lane chunk of the candidate and query tiles is copied
//     global -> shared with cp.async while this chunk is computed (double
//     buffer); VEC: 16-byte copies (D % 4 == 0 and 16-byte aligned rows),
//     otherwise 4-byte copies;
//   - the sign is a template parameter of the term: q + x or q - x directly
//     (the plain version's sign * x is an exact negation), no multiply by
//     +-1 and no branch per term;
//   - the count ends with one warp reduction (__reduce_add_sync) and one
//     integer atomicAdd per query and warp (order-free: deterministic).
// The lane sum of a (query, candidate) pair stays in one thread: its order
// is part of the contract, so it is never split across blocks. W, the warps
// (query groups of 4) of a block, is a template parameter: 4 for B1 and B2.
//
// One tile serves every C. At the serving chunk (C = 256) the 128-candidate
// x 16-query blocks make a grid of 114 x 16 = 1,824 blocks over 14,541
// entities. The kernel asks ptxas for 7 resident blocks an SM (at most 72
// registers a thread; left free, ptxas spends more on both counts and fits
// fewer blocks): 924 blocks on the 132 SMs, so the grid runs in 1.97 waves
// and its last wave is nearly full. The relation-by-relation link
// prediction of TransR and TransH launches C = 64 chunks: 468 blocks over
// TransR's 14,951 entities, 1,280 over TransH's 40,943. A 64-candidate tile
// (2 candidates a thread) launches twice the blocks there, but it measured
// slower on both shapes and at C = 256 (PERF.md, section 6): it spends more
// staging copies and shared loads on each lane term.

#pragma once

#include "async_copy.cuh"
#include "rank_common.cuh"

namespace okst {
namespace tiled {

constexpr int kCands = 4;                         // candidates per thread
constexpr int kQueries = 4;                       // queries per thread
constexpr int kWarps = 4;                         // query groups per block
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockCands = 32 * kCands;          // 128
constexpr int kLanes = 16;                        // lanes staged per chunk
// floats per staged row: 5 float4s, an odd count
constexpr int kPitch = kLanes + 4;
constexpr int kBlocksPerSM = 7;  // resident blocks asked of ptxas

// q + x (SIGN > 0) or q - x, rounded once
template <int SIGN>
__device__ __forceinline__ float signed_add(float q, float x) {
  return SIGN > 0 ? __fadd_rn(q, x) : __fsub_rn(q, x);
}

// component u of v (u a constant once the loop over it is unrolled)
__device__ __forceinline__ float part(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// the per-query operand rows of a count, each [C, D] row-major
template <int N>
struct QueryRows {
  const float* row[N];
};

// one staged chunk: the block's candidate rows and, per operand, the query
// rows of its W warps
template <int N, int W = kWarps>
struct Stage {
  float e[kBlockCands][kPitch];
  float q[N][W * kQueries][kPitch];
};

// The scalar of a lane term that does not depend on the lane, by (query j,
// candidate k) of the thread's tile: one per candidate, or one per pair.
struct PerCandidate {
  float v[kCands];
  __device__ __forceinline__ float get(int, int k) const { return v[k]; }
};

struct PerPair {
  const float (&v)[kQueries][kCands];
  __device__ __forceinline__ float get(int j, int k) const { return v[j][k]; }
};

// One copy of W floats (16 or 4 bytes) global -> shared; ok false: zeros.
template <bool VEC>
__device__ __forceinline__ void copy(float* dst, const float* src,
                                     bool ok) {
  if (VEC) {
    cp_async16(dst, src, ok ? 16 : 0);
  } else {
    cp_async4(dst, src, ok ? 4 : 0);
  }
}

// Copy lanes [l0, l0 + ln) of the block's candidate rows and query operand
// rows into s; rows past their count and lanes past ln are zero-filled.
// Each thread copies one column of the chunk (kPerRow divides kThreads),
// so its column and its rows' offsets are the same in every chunk.
template <int N, bool VEC, int W>
__device__ __forceinline__ void stage_chunk(Stage<N, W>& s,
                                            const QueryRows<N>& qrows,
                                            const float* __restrict__ table,
                                            int q0, int C, int c0, int n_ent,
                                            int D, int l0, int ln) {
  constexpr int kW = VEC ? 4 : 1;            // floats per copy
  constexpr int kPerRow = kLanes / kW;       // copies per row
  constexpr int kRowStep = 32 * W / kPerRow;  // rows per pass of a block
  constexpr int kBlockQueries = W * kQueries;
  const int col = (threadIdx.x % kPerRow) * kW;
  const int r0 = threadIdx.x / kPerRow;
  const bool in_chunk = col < ln;
#pragma unroll
  for (int it = 0; it < kBlockCands / kRowStep; ++it) {
    const int r = r0 + it * kRowStep;
    const bool ok = in_chunk && c0 + r < n_ent;
    copy<VEC>(s.e[r] + col,
              ok ? table + static_cast<long long>(c0 + r) * D + l0 + col
                 : table, ok);
  }
#pragma unroll
  for (int o = 0; o < N; ++o) {
    // o is a constant once unrolled: no dynamic index into the parameters
    const float* rows = qrows.row[o];
#pragma unroll
    for (int it = 0; it < (kBlockQueries + kRowStep - 1) / kRowStep; ++it) {
      const int r = r0 + it * kRowStep;
      if (r >= kBlockQueries) break;
      const bool ok = in_chunk && q0 + r < C;
      copy<VEC>(s.q[o][r] + col,
                ok ? rows + static_cast<long long>(q0 + r) * D + l0 + col
                   : rows, ok);
    }
  }
}

template <class Term, class Scal>
__device__ __forceinline__ void lane_terms(
    float (&acc)[kQueries][kCands], float (&qv)[kQueries][Term::kOperands],
    float e, const Scal& scal, int k) {
#pragma unroll
  for (int j = 0; j < kQueries; ++j) {
    acc[j][k] = Term::step(acc[j][k], qv[j], e, scal.get(j, k));
  }
}

// acc[j][k] += the lane terms d = 0 .. D-1, in that order, of the thread's
// 4 x 4 (query, candidate) pairs: the block's candidate tile (from c0) and
// query tile (from q0) stream through the two stages chunk by chunk. Every
// thread of the block calls it; it ends behind a barrier, so the stages are
// free for a second sweep.
template <class Term, bool VEC, int W, class Scal>
__device__ __forceinline__ void sweep(
    float (&acc)[kQueries][kCands], const Scal& scal,
    Stage<Term::kOperands, W>* stages,
    const QueryRows<Term::kOperands>& qrows,
    const float* __restrict__ table, int q0, int C, int c0, int n_ent,
    int D) {
  constexpr int N = Term::kOperands;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qa = warp * kQueries;  // this thread's first query row in a tile
  const int chunks = (D + kLanes - 1) / kLanes;
  stage_chunk<N, VEC, W>(stages[0], qrows, table, q0, C, c0, n_ent, D, 0,
                         min(kLanes, D));
  cp_async_commit();
  for (int ch = 0; ch < chunks; ++ch) {
    const int l0 = ch * kLanes, ln = min(kLanes, D - l0);
    if (ch + 1 < chunks) {
      stage_chunk<N, VEC, W>(stages[(ch + 1) & 1], qrows, table, q0, C, c0,
                             n_ent, D, l0 + kLanes,
                             min(kLanes, D - l0 - kLanes));
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const Stage<N, W>& s = stages[ch & 1];
    int l = 0;
    for (; l + 4 <= ln; l += 4) {
      float4 q4[N][kQueries];
#pragma unroll
      for (int o = 0; o < N; ++o) {
#pragma unroll
        for (int j = 0; j < kQueries; ++j) {
          q4[o][j] = *reinterpret_cast<const float4*>(&s.q[o][qa + j][l]);
        }
      }
#pragma unroll
      for (int k = 0; k < kCands; ++k) {
        const float4 e4 =
            *reinterpret_cast<const float4*>(&s.e[lane + 32 * k][l]);
        // lanes l, l+1, l+2, l+3 in order: the plain version's sum order
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float qv[kQueries][N];
#pragma unroll
          for (int j = 0; j < kQueries; ++j) {
#pragma unroll
            for (int o = 0; o < N; ++o) qv[j][o] = part(q4[o][j], u);
          }
          lane_terms<Term>(acc, qv, part(e4, u), scal, k);
        }
      }
    }
    for (; l < ln; ++l) {  // the lanes past the last multiple of 4
      float qv[kQueries][N];
#pragma unroll
      for (int j = 0; j < kQueries; ++j) {
#pragma unroll
        for (int o = 0; o < N; ++o) qv[j][o] = s.q[o][qa + j][l];
      }
#pragma unroll
      for (int k = 0; k < kCands; ++k) {
        lane_terms<Term>(acc, qv, s.e[lane + 32 * k][l], scal, k);
      }
    }
    __syncthreads();
  }
}

// counts[c] += #{better candidates of this warp}; padding queries (gold id
// -1) count 0
__device__ __forceinline__ void finish_counts(
    const float (&acc)[kQueries][kCands], const float* __restrict__ gold,
    const int* __restrict__ gold_ids, int* __restrict__ counts, int q0, int C,
    int c0, int n_ent) {
  const int lane = threadIdx.x & 31, qa = (threadIdx.x >> 5) * kQueries;
#pragma unroll
  for (int j = 0; j < kQueries; ++j) {
    const int c = q0 + qa + j;  // uniform across the warp
    if (c >= C) break;
    const int gid = gold_ids[c];
    const float g = gold[c];
    int n = 0;
#pragma unroll
    for (int k = 0; k < kCands; ++k) {
      const int e = c0 + lane + 32 * k;
      n += (e < n_ent && gid != -1 && e != gid && acc[j][k] < g) ? 1 : 0;
    }
    n = __reduce_add_sync(0xffffffffu, n);
    if (lane == 0 && n != 0) atomicAdd(&counts[c], n);
  }
}

template <class Term, bool VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
count_kernel(QueryRows<Term::kOperands> qrows,
             const float* __restrict__ table,
             const float* __restrict__ scalar,
             const float* __restrict__ gold,
             const int* __restrict__ gold_ids, int* __restrict__ counts,
             int C, int D, int n_ent) {
  __shared__ __align__(16) Stage<Term::kOperands> stages[2];
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kBlockCands;
  const int q0 = blockIdx.y * kWarps * kQueries;

  PerCandidate cs;  // the candidates' scalars (0 without one or past n_ent)
  float acc[kQueries][kCands];
#pragma unroll
  for (int k = 0; k < kCands; ++k) {
    const int e = c0 + lane + 32 * k;
    cs.v[k] = Term::kScalar && e < n_ent ? scalar[e] : 0.0f;
#pragma unroll
    for (int j = 0; j < kQueries; ++j) acc[j][k] = 0.0f;
  }
  sweep<Term, VEC, kWarps>(acc, cs, stages, qrows, table, q0, C, c0, n_ent,
                           D);
  finish_counts(acc, gold, gold_ids, counts, q0, C, c0, n_ent);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

// blocks of 128 candidates x W * 4 queries
template <int W>
inline dim3 count_grid(int n_ent, int C) {
  return dim3((n_ent + kBlockCands - 1) / kBlockCands,
              (C + W * kQueries - 1) / (W * kQueries));
}

// 16-byte copies need every staged 4-lane group 16-byte aligned
template <int N>
inline bool vector_copies(const QueryRows<N>& qrows, const float* table,
                          int D) {
  bool vec = D % 4 == 0 && aligned16(table);
  for (int o = 0; o < N; ++o) vec = vec && aligned16(qrows.row[o]);
  return vec;
}

template <class Term>
void launch(const QueryRows<Term::kOperands>& qrows, const float* table,
            const float* scalar, const float* gold, const int* gold_ids,
            int* counts, int C, int D, int n_ent, cudaStream_t s) {
  const dim3 grid = count_grid<kWarps>(n_ent, C);
  if (vector_copies(qrows, table, D)) {
    count_kernel<Term, true><<<grid, kThreads, 0, s>>>(
        qrows, table, scalar, gold, gold_ids, counts, C, D, n_ent);
  } else {
    count_kernel<Term, false><<<grid, kThreads, 0, s>>>(
        qrows, table, scalar, gold, gold_ids, counts, C, D, n_ent);
  }
}

// The count of the family Term<SIGN, P> for sign = +-1 and p in {1, 2};
// returns the cudaError_t of the launch.
template <template <int, int> class Term>
int count(const QueryRows<Term<1, 1>::kOperands>& qrows, const float* table,
          const float* scalar, const float* gold, const int* gold_ids,
          int* counts, int C, int D, int n_ent, float sign, int p,
          void* stream) {
  if ((p != 1 && p != 2) || C < 1 || D < 1 || n_ent < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sign > 0 && p == 1) {
    launch<Term<1, 1>>(qrows, table, scalar, gold, gold_ids, counts, C, D,
                       n_ent, s);
  } else if (sign > 0) {
    launch<Term<1, 2>>(qrows, table, scalar, gold, gold_ids, counts, C, D,
                       n_ent, s);
  } else if (p == 1) {
    launch<Term<-1, 1>>(qrows, table, scalar, gold, gold_ids, counts, C, D,
                        n_ent, s);
  } else {
    launch<Term<-1, 2>>(qrows, table, scalar, gold, gold_ids, counts, C, D,
                        n_ent, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tiled
}  // namespace okst
