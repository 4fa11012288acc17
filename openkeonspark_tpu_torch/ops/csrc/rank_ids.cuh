// The id scorer of the rank kernels (sm_90a): the scores of explicit ids,
// out[c, k] = score(query c, row ids[c, k]), the gold entity and the
// known-true entities of each query, through the count's arithmetic. The
// id scorer of all four rank kernels, the counterpart of
// openkeonspark_tpu/ops/pallas_rank.py's transe_, transh_, transd_ and
// rotate_candidate_scores (B1 rank_count.cu, B6 rank_count_transh.cu, B2
// rank_count_transd.cu, B3 rank_count_rotate.cu).
//
// The contract:
//   - a pair's score is the sum over lanes l = 0 .. D-1, in that order, of
//     one lane term, in one thread, every operation rounded on its own
//     (__fadd_rn, __fsub_rn, __fmul_rn, no FMA): never split across threads
//     or tree-reduced, so gold, known and swept scores are tie-exact against
//     the count and equal the plain versions in ops/rank.py bit for bit;
//   - an id outside [0, rows) scores NaN, and its row is not read. Link
//     prediction pads its [C, K] known-id windows with rows, so most of a
//     window (85% at the serving slice) costs no row at all.
// A Term policy (derived from TermDefaults, whose defaults it overrides)
// gives the lane term: Term::step(acc, q, e, s) adds lane l's term to acc
// from the values at lane l of the query's kQ operand columns and of the
// row's kE table columns (TransE: q, E[id]; RotatE: the re and im halves of
// both; TransD: q, r_p, E[id]; TransH: q, w, E[id]) and one scalar s of the
// pair that does not depend on the lane:
//   - kIdScalar: s = id_scalar[id], read once per real pair (TransD's
//     cdot[id]);
//   - kDot >= 0: s = the sum over the lanes, in order, of Term::dot_step
//     over the query's column kDot and the row's first column (TransH's
//     w . E[id]), a first pass over the row that ends before the second
//     pass's first lane;
//   - otherwise s = 0 and the Term ignores it.
// A Term with kRecompute takes a pair whose sum is not finite again, lane
// by lane from device memory, with Term::exact_step (RotatE's square root,
// sqrt_rn_normal, differs from __fsqrt_rn only on infinite and NaN
// arguments).
//
// What bounds it on an H100: latency. At the serving window ([256, 192]
// ids, 13-15% of them real, D = 200) the real pairs' distinct rows are
// ~2 MB and their lane terms ~2.6 M fp32 operations, a bound of ~0.7 us,
// spread over a few hundred of 3,072 warp slices; the gold call ([256]
// ids) is 16 slices.
// The one-thread-per-pair design read each 800-byte row 4 bytes at a time
// (a warp's load touched 32 rows) and summed behind that latency. Here:
//   - pairs go in warp slices of kPairs consecutive (query, id) pairs, one
//     per thread (lanes past kPairs only copy); a __ballot_sync over the
//     slice's ids finds the real ones, and a slice with none writes NaN and
//     returns before any copy;
//   - the slice's real rows and its queries' rows (1 or 2 distinct
//     queries for K >= kPairs, up to kPairs for K = 1) are copied global ->
//     shared with cp.async, row by row (consecutive threads on consecutive
//     16 bytes of one row), in chunks of kLanes lanes through a ring of
//     kStages buffers, so kStages - 1 chunks are in flight while one is
//     summed; 4-byte copies where the widths are no multiple of 4 or a view
//     is not 16-byte aligned;
//   - a Term with a first pass (kDot) keeps the slice's rows staged across
//     both passes where they take at most kKeepChunks chunks: every chunk
//     of every column copied at once, then both passes read shared memory;
//     a wider row streams the ring twice, the first pass staging only the
//     row and the query's column kDot;
//   - rows are kLanes + 4 floats apart, an odd number of float4s, so the
//     LDS.128s of 8 consecutive threads' rows fall in 8 bank groups; a
//     thread reads its row and its query four lanes a load, the query as a
//     broadcast wherever the slice's pairs share it;
//   - warps stage and sum on their own (__syncwarp, no block barrier), so a
//     warp with real rows never waits for one without.

#pragma once

#include "async_copy.cuh"
#include "rank_common.cuh"

namespace okst {
namespace id_scorer {

// Measured at the serving and relation-chunk shapes (PERF.md section 6;
// chip_smoke.py times the first design, 32 pairs a warp, 4 warps a block,
// 32-lane chunks, beside this one): a warp's slice runs one dependent chain
// of copies and sums, so the few slices with real ids finish sooner when
// they are more and shorter (16 pairs: the gold call's 256 ids make 16
// slices, not 8) and take fewer rounds (64-lane chunks: 4 at D = 200, not
// 7); one warp a block keeps the blocks of padding-only slices from holding
// shared memory beside a busy one.
constexpr int kPairs = 16;   // (query, id) pairs per warp slice
constexpr int kWarps = 1;    // warp slices per block
constexpr int kLanes = 64;   // lanes per staged chunk
constexpr int kStages = 2;   // chunk buffers per warp: a double buffer
constexpr int kPitch = kLanes + 4;  // floats per staged row
// A two-pass Term keeps its rows staged up to this many chunks (D <= 256):
// one round of copies a slice instead of two rings of D / kLanes rounds
// (PERF.md section 6; chip_smoke.py times the two rings beside it).
constexpr int kKeepChunks = 4;
static_assert(kPairs <= 32 && 32 % kPairs == 0, "pairs fill a warp's lanes");
static_assert(kLanes % 4 == 0 && (kPitch / 4) % 2 == 1,
              "a staged row is an odd number of float4s");
static_assert(kStages >= 2, "one chunk in flight while one is summed");

// The defaults of a Term policy: no scalar, no first pass, no second sum.
struct TermDefaults {
  static constexpr bool kIdScalar = false;
  static constexpr int kDot = -1;
  static constexpr bool kRecompute = false;
};

// The operand columns of a Term: column o of query c starts at
// q[o] + c * q_ld, column o of row id at table + id * e_ld + e_off[o]; each
// is D lanes long. id_scalar [rows]: the per-id scalar of a Term with
// kIdScalar (else unused).
template <int NQ, int NE>
struct Operands {
  const float* q[NQ];
  long long q_ld;
  const float* table;
  long long e_off[NE];
  long long e_ld;
  const float* id_scalar;
};

// One copy of 16 or 4 bytes global -> shared.
template <bool VEC>
__device__ __forceinline__ void copy(float* dst, const float* src) {
  if (VEC) {
    cp_async16(dst, src, 16);
  } else {
    cp_async4(dst, src, 4);
  }
}

// The query rows a slice can span: ceil((kPairs - 1) / K) + 1, at most
// kPairs.
inline int slice_queries(int K) {
  const int n = (kPairs - 2 + K) / K + 1;
  return n < kPairs ? n : kPairs;
}

// Chunk buffers a warp of Term needs at width D: the ring's, or every chunk
// where a two-pass Term keeps its rows.
template <class T>
__host__ __device__ inline int buffers(int D) {
  const int chunks = (D + kLanes - 1) / kLanes;
  return T::kDot >= 0 && chunks <= kKeepChunks && chunks > kStages ? chunks
                                                                   : kStages;
}

// Shared memory of one warp: kPairs + q_rows row offsets, then nbuf chunk
// buffers of NE table columns x kPairs rows and NQ query columns x q_rows
// rows.
template <int NQ, int NE>
__host__ __device__ inline long long stage_floats(int q_rows) {
  return static_cast<long long>(NE * kPairs + NQ * q_rows) * kPitch;
}

__host__ __device__ inline long long offs_bytes(int q_rows) {
  return ((kPairs + q_rows) * 8 + 15) / 16 * 16;
}

template <int NQ, int NE>
__host__ __device__ inline long long warp_bytes(int q_rows, int nbuf) {
  return offs_bytes(q_rows) + nbuf * stage_floats<NQ, NE>(q_rows) * 4;
}

// Copy lanes [l0, l0 + ln) of the slice's real rows and of its nq query
// rows into st. off[r] is row r's element offset (-1: not a real id), off[
// kPairs + j] query row j's. A row's chunk takes kPerRow copies, spread over
// kRowThreads consecutive threads (kColSteps each), so a pass of the warp
// copies kRowStep rows; a thread's columns and rows are the same in every
// chunk.
template <int NQ, int NE, bool VEC>
__device__ __forceinline__ void stage_chunk(float* st,
                                            const long long* off,
                                            const Operands<NQ, NE>& ops,
                                            int q_rows, int nq, int l0,
                                            int ln, int lane) {
  constexpr int kW = VEC ? 4 : 1;                     // floats per copy
  constexpr int kPerRow = kLanes / kW;                // copies per row
  constexpr int kRowThreads = kPerRow < 32 ? kPerRow : 32;
  constexpr int kRowStep = 32 / kRowThreads;          // rows per pass
  constexpr int kColSteps = kPerRow / kRowThreads;    // copies per thread
  static_assert(32 % kRowThreads == 0 && kPerRow % kRowThreads == 0,
                "a chunk's copies tile the warp");
  const int c0 = (lane % kRowThreads) * kW;
  const int r0 = lane / kRowThreads;
#pragma unroll
  for (int j = 0; j < kColSteps; ++j) {
    const int col = c0 + j * kRowThreads * kW;
    if (col >= ln) break;
#pragma unroll
    for (int o = 0; o < NE; ++o) {
#pragma unroll
      for (int it = 0; it < (kPairs + kRowStep - 1) / kRowStep; ++it) {
        const int r = r0 + it * kRowStep;
        if (r >= kPairs) break;
        const long long at = off[r];
        if (at >= 0) {
          copy<VEC>(st + (o * kPairs + r) * kPitch + col,
                    ops.table + at + ops.e_off[o] + l0 + col);
        }
      }
    }
    float* qst = st + NE * kPairs * kPitch;
#pragma unroll
    for (int o = 0; o < NQ; ++o) {
      for (int r = r0; r < nq; r += kRowStep) {
        copy<VEC>(qst + (o * q_rows + r) * kPitch + col,
                  ops.q[o] + off[kPairs + r] + l0 + col);
      }
    }
  }
}

// The thread's staged rows in one chunk buffer: its row's NE columns, its
// query's NQ columns.
template <int NQ, int NE>
struct Rows {
  const float* e[NE];
  const float* q[NQ];
};

template <int NQ, int NE>
__device__ __forceinline__ Rows<NQ, NE> rows_in(const float* st, int row,
                                                int cq, int q_rows) {
  Rows<NQ, NE> r;
#pragma unroll
  for (int o = 0; o < NE; ++o) r.e[o] = st + (o * kPairs + row) * kPitch;
#pragma unroll
  for (int o = 0; o < NQ; ++o) {
    r.q[o] = st + NE * kPairs * kPitch + (o * q_rows + cq) * kPitch;
  }
  return r;
}

// component u of v (u a constant once the loop over it is unrolled)
__device__ __forceinline__ float part4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// acc after step(acc, q, e) over lanes 0 .. ln-1 of one staged chunk, in
// order.
template <int NQ, int NE, class Step>
__device__ __forceinline__ float sum_chunk(float acc, const Rows<NQ, NE>& r,
                                           int ln, Step step) {
  int l = 0;
  for (; l + 4 <= ln; l += 4) {
    float4 e4[NE], q4[NQ];
#pragma unroll
    for (int o = 0; o < NE; ++o) {
      e4[o] = *reinterpret_cast<const float4*>(r.e[o] + l);
    }
#pragma unroll
    for (int o = 0; o < NQ; ++o) {
      q4[o] = *reinterpret_cast<const float4*>(r.q[o] + l);
    }
    // lanes l, l+1, l+2, l+3 in order: the plain version's sum order
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float ev[NE], qv[NQ];
#pragma unroll
      for (int o = 0; o < NE; ++o) ev[o] = part4(e4[o], u);
#pragma unroll
      for (int o = 0; o < NQ; ++o) qv[o] = part4(q4[o], u);
      acc = step(acc, qv, ev);
    }
  }
  for (; l < ln; ++l) {  // the lanes past the last multiple of 4
    float ev[NE], qv[NQ];
#pragma unroll
    for (int o = 0; o < NE; ++o) ev[o] = r.e[o][l];
#pragma unroll
    for (int o = 0; o < NQ; ++o) qv[o] = r.q[o][l];
    acc = step(acc, qv, ev);
  }
  return acc;
}

// The lane sum of the thread's pair over the D lanes of ops' columns,
// streamed through the ring of kStages chunk buffers at stages; returns with
// no copy of this thread in flight.
template <bool VEC, int NQ, int NE, class Step>
__device__ __forceinline__ float sweep(float* stages, const long long* off,
                                       const Operands<NQ, NE>& ops,
                                       int q_rows, int nq, int row, int cq,
                                       int D, int lane, Step step) {
  const long long sf = stage_floats<NQ, NE>(q_rows);
  const int chunks = (D + kLanes - 1) / kLanes;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) {
      stage_chunk<NQ, NE, VEC>(stages + s * sf, off, ops, q_rows, nq,
                               s * kLanes, min(kLanes, D - s * kLanes),
                               lane);
    }
    cp_async_commit();
  }
  float acc = 0.0f;
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<kStages - 2>();  // chunk ch has landed (this thread's)
    __syncwarp();                  // ... and every thread's; chunk ch - 1
                                   // is summed, so its buffer is free
    const int nxt = ch + kStages - 1;
    if (nxt < chunks) {
      stage_chunk<NQ, NE, VEC>(stages + (nxt % kStages) * sf, off, ops,
                               q_rows, nq, nxt * kLanes,
                               min(kLanes, D - nxt * kLanes), lane);
    }
    cp_async_commit();
    acc = sum_chunk(acc,
                    rows_in<NQ, NE>(stages + (ch % kStages) * sf, row, cq,
                                    q_rows),
                    min(kLanes, D - ch * kLanes), step);
  }
  cp_async_wait<0>();  // no copy outlives the sweep
  return acc;
}

// The two passes of a Term with kDot: the pair's dot, then the lane sum
// with the dot as its scalar.
template <class Term, bool VEC>
__device__ __forceinline__ float two_passes(
    float* stages, const long long* off,
    const Operands<Term::kQ, Term::kE>& ops, int q_rows, int nq, int row,
    int cq, int D, int lane) {
  constexpr int NQ = Term::kQ, NE = Term::kE;
  const auto dot_step = [](float dot, const float (&q)[1],
                           const float (&e)[1]) {
    return Term::dot_step(dot, q[0], e[0]);
  };
  const int chunks = (D + kLanes - 1) / kLanes;
  if (chunks > kKeepChunks) {
    // the ring twice: the first pass stages the row and column kDot only
    const Operands<1, 1> first{{ops.q[Term::kDot]}, ops.q_ld, ops.table,
                               {ops.e_off[0]}, ops.e_ld, nullptr};
    const float dot = sweep<VEC>(stages, off, first, q_rows, nq, row, cq, D,
                                 lane, dot_step);
    __syncwarp();  // every thread has summed the last chunk: the buffers
                   // may be refilled
    return sweep<VEC>(stages, off, ops, q_rows, nq, row, cq, D, lane,
                      [dot](float acc, const float (&q)[NQ],
                            const float (&e)[NE]) {
                        return Term::step(acc, q, e, dot);
                      });
  }
  // every chunk of every column staged once, read by both passes
  const long long sf = stage_floats<NQ, NE>(q_rows);
  for (int ch = 0; ch < chunks; ++ch) {
    stage_chunk<NQ, NE, VEC>(stages + ch * sf, off, ops, q_rows, nq,
                             ch * kLanes, min(kLanes, D - ch * kLanes), lane);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  float dot = 0.0f;
  for (int ch = 0; ch < chunks; ++ch) {
    const Rows<NQ, NE> r = rows_in<NQ, NE>(stages + ch * sf, row, cq, q_rows);
    dot = sum_chunk(dot, Rows<1, 1>{{r.e[0]}, {r.q[Term::kDot]}},
                    min(kLanes, D - ch * kLanes), dot_step);
  }
  float acc = 0.0f;
  for (int ch = 0; ch < chunks; ++ch) {
    acc = sum_chunk(acc, rows_in<NQ, NE>(stages + ch * sf, row, cq, q_rows),
                    min(kLanes, D - ch * kLanes),
                    [dot](float a, const float (&q)[NQ],
                          const float (&e)[NE]) {
                      return Term::step(a, q, e, dot);
                    });
  }
  return acc;
}

template <class Term, bool VEC>
__global__ void __launch_bounds__(32 * kWarps)
score_ids_kernel(Operands<Term::kQ, Term::kE> ops, const int* __restrict__ ids,
                 float* __restrict__ out, long long n, int K, int D,
                 int rows, int q_rows) {
  constexpr int NQ = Term::kQ, NE = Term::kE;
  static_assert(!Term::kRecompute || (!Term::kIdScalar && Term::kDot < 0),
                "exact_step takes no scalar");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kPairs;
  if (i0 >= n) return;                       // uniform across the warp
  const long long i = i0 + lane;
  const bool mine = lane < kPairs && i < n;  // the thread owns pair i
  const int id = mine ? ids[i] : -1;
  const bool real = mine && id >= 0 && id < rows;
  if (__ballot_sync(0xffffffffu, real) == 0) {
    if (mine) out[i] = quiet_nan();
    return;
  }

  unsigned char* base =
      smem + warp * warp_bytes<NQ, NE>(q_rows, buffers<Term>(D));
  long long* off = reinterpret_cast<long long*>(base);
  float* stages = reinterpret_cast<float*>(base + offs_bytes(q_rows));
  const long long c_first = i0 / K;
  const long long last = (i0 + kPairs < n ? i0 + kPairs : n) - 1;
  const int nq = static_cast<int>(last / K - c_first + 1);  // <= q_rows
  float s = 0.0f;  // the pair's per-id scalar, read for a real id only
  if constexpr (Term::kIdScalar) {
    if (real) s = ops.id_scalar[id];
  }
  if (lane < kPairs) off[lane] = real ? id * ops.e_ld : -1;
  if (lane < nq) off[kPairs + lane] = (c_first + lane) * ops.q_ld;
  __syncwarp();

  const int row = lane < kPairs ? lane : 0;  // the thread's staged row
  const int cq = mine ? static_cast<int>(i / K - c_first) : 0;
  float acc;
  if constexpr (Term::kDot >= 0) {
    acc = two_passes<Term, VEC>(stages, off, ops, q_rows, nq, row, cq, D,
                                lane);
  } else {
    acc = sweep<VEC>(stages, off, ops, q_rows, nq, row, cq, D, lane,
                     [s](float a, const float (&q)[NQ],
                         const float (&e)[NE]) {
                       return Term::step(a, q, e, s);
                     });
  }

  if constexpr (Term::kRecompute) {
    if (real && !isfinite(acc)) {
      const long long qo = (i / K) * ops.q_ld;
      const long long eo = id * ops.e_ld;
      acc = 0.0f;
      for (int l = 0; l < D; ++l) {
        float ev[NE], qv[NQ];
#pragma unroll
        for (int o = 0; o < NE; ++o) ev[o] = ops.table[eo + ops.e_off[o] + l];
#pragma unroll
        for (int o = 0; o < NQ; ++o) qv[o] = ops.q[o][qo + l];
        acc = Term::exact_step(acc, qv, ev);
      }
    }
  }
  if (mine) out[i] = real ? acc : quiet_nan();
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

// 16-byte copies need every staged 4-lane group of every column 16-byte
// aligned
template <int NQ, int NE>
bool vector_copies(const Operands<NQ, NE>& ops, int D) {
  bool vec = D % 4 == 0 && ops.q_ld % 4 == 0 && ops.e_ld % 4 == 0 &&
             aligned16(ops.table);
  for (int o = 0; o < NQ; ++o) vec = vec && aligned16(ops.q[o]);
  for (int o = 0; o < NE; ++o) vec = vec && ops.e_off[o] % 4 == 0;
  return vec;
}

template <class Term, bool VEC>
cudaError_t launch_as(const Operands<Term::kQ, Term::kE>& ops,
                      const int* ids, float* out, long long n, int K, int D,
                      int rows, cudaStream_t s) {
  constexpr int NQ = Term::kQ, NE = Term::kE;
  const int q_rows = slice_queries(K);
  const long long bytes =
      kWarps * warp_bytes<NQ, NE>(q_rows, buffers<Term>(D));
  // above 48 KB only after the opt-in, once per instantiation at the most
  // any launch can ask for (q_rows = kPairs, the most buffers)
  constexpr int kMostBuffers =
      Term::kDot >= 0 && kKeepChunks > kStages ? kKeepChunks : kStages;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      score_ids_kernel<Term, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWarps * warp_bytes<NQ, NE>(kPairs, kMostBuffers)));
  if (opt_in != cudaSuccess) return opt_in;
  const long long slices = (n + kPairs - 1) / kPairs;
  const unsigned blocks =
      static_cast<unsigned>((slices + kWarps - 1) / kWarps);
  score_ids_kernel<Term, VEC><<<blocks, 32 * kWarps, bytes, s>>>(
      ops, ids, out, n, K, D, rows, q_rows);
  return cudaGetLastError();
}

// Score the C x K ids (row-major, K ids a query) into out; returns the
// cudaError_t of the launch.
template <class Term>
int score_ids(const Operands<Term::kQ, Term::kE>& ops, const int* ids,
              float* out, int C, int K, int D, int rows, void* stream) {
  if (C < 1 || K < 1 || D < 1 || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(C) * K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vector_copies(ops, D)
          ? launch_as<Term, true>(ops, ids, out, n, K, D, rows, s)
          : launch_as<Term, false>(ops, ids, out, n, K, D, rows, s));
}

}  // namespace id_scorer
}  // namespace okst
