// Merge of an entity table's slot gradients (sm_90a): one pass that turns the
// h- and t-anchored gradient streams of a training step into the table's
// update rows.
//
// Replaces no TPU kernel. The JAX package builds this merge in plain jnp
// (openkeonspark_tpu/train/step.py: merged_row_updates), which XLA fuses; in
// eager PyTorch the same code is about seven small kernels a negative
// (ops/merge.py: merge_entity_rows_ref, the plain version). With
//   B      positives, nE entity negatives and nR relation negatives each,
//   gh, gt [(1 + nE + nR) * B, d] the h and t slot gradients (segment i at
//          rows [B * i, B * (i + 1)): the positives, then the entity
//          negatives, then the relation negatives), row strides gh_st, gt_st
//   ch_k   = neg_h[b, k] != h[b]   (negative k of column b corrupts its head)
// it writes, in the plain version's order,
//   ids [(nE + 2) * B]    segment k < nE: ch_k ? neg_h[:, k] : neg_t[:, k];
//                         then h; then t
//   out [(nE + 2) * B, d] segment k < nE: ch_k ? gh seg k : gt seg k;
//                         then base_h = ((gh[b] + (ch_0 ? 0 : gh seg 0))
//                           + (ch_1 ? 0 : gh seg 1)) + ... + gh seg nE ...;
//                         then base_t alike, with (ch_k ? gt seg k : 0)
// Each base row is summed k ascending, then the relation negatives' segments,
// one add each, as the plain version adds (__fadd_rn; a literal +0.0 where
// it adds torch.where(ch, 0.0, ...), so -0.0 turns to +0.0 as there; bf16
// rounded after every add, row_types.cuh). Kernel and plain version agree bit
// for bit.
//
// What bounds it on an H100: bytes. It reads each gradient row once and
// writes each output row once: at B = 2,721, nE = 25, d = 200 in fp32, 113
// MB read and 59 MB written, 51 us at 3.35 TB/s; the ids add 1%. Design: a
// thread owns one column vector (16 bytes: 4 fp32 or 8 bf16 columns) of one
// positive column b, keeps base_h and base_t in registers, and walks the
// negatives in pairs (kInFlight): a pair's four row loads are issued before
// their adds, so each thread keeps several loads in flight while the adds
// stay in order, and 64 registers a thread keep 1,024 threads on each SM.
// Neighbouring threads own neighbouring vectors of a row, so every load and
// store is coalesced. Rows that are not 16-byte aligned (a width or a row
// stride that is not a multiple of the vector, an unaligned view) take one
// column a thread. The grid is balanced to the card: each thread takes the
// same number of items, and every thread is resident at once, so no second
// wave runs a few blocks alone. Measured on an H100 against other choices
// (PERF.md): four negatives in flight, or no register cap, or one item a
// thread, were as fast or slower in fp32 and up to 13% slower in bf16.
//
// Plain C interface, loaded with ctypes (ops/build.py); each launcher returns
// the cudaError_t of its launch.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "row_types.cuh"

namespace {

using okst::Bf16;
using okst::Fp32;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;     // 64 registers: 1,024 threads an SM
constexpr int kInFlight = 2;        // negatives whose rows load before adds

template <typename E, bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
merge_rows_kernel(const int64_t* __restrict__ h, int64_t h_st,
                  const int64_t* __restrict__ t, int64_t t_st,
                  const int64_t* __restrict__ neg_h, int64_t nh_row,
                  int64_t nh_col, const int64_t* __restrict__ neg_t,
                  int64_t nt_row, int64_t nt_col,
                  const typename E::Elem* __restrict__ gh, int64_t gh_st,
                  const typename E::Elem* __restrict__ gt, int64_t gt_st,
                  int64_t* __restrict__ ids,
                  typename E::Elem* __restrict__ out, int B, int nE, int nR,
                  int d, int64_t items, int per_thread) {
  using Elem = typename E::Elem;
  using Val = typename std::conditional<kVec, typename E::Vec, Elem>::type;
  constexpr int kCols = kVec ? E::kVec : 1;
  const int nv = d / kCols;                    // column vectors a row
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t item = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (int n = 0; n < per_thread && item < items; ++n, item += stride) {
    const int b = static_cast<int>(item / nv);
    const int col = static_cast<int>(item - static_cast<int64_t>(b) * nv) *
                    kCols;
    auto row_at = [&](const Elem* g, int64_t st, int seg) {
      return __ldg(reinterpret_cast<const Val*>(
          g + (static_cast<int64_t>(seg) * B + b) * st + col));
    };
    auto store = [&](int seg, Val v) {
      *reinterpret_cast<Val*>(
          out + (static_cast<int64_t>(seg) * B + b) * d + col) = v;
    };
    const int64_t hb = h[b * h_st];
    Val acc_h = row_at(gh, gh_st, 0), acc_t = row_at(gt, gt_st, 0);
    for (int k0 = 0; k0 < nE; k0 += kInFlight) {
      int64_t nh[kInFlight];
      Val sh[kInFlight], st[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        if (k0 + j < nE) {
          nh[j] = neg_h[b * nh_row + (k0 + j) * nh_col];
          sh[j] = row_at(gh, gh_st, 1 + k0 + j);
          st[j] = row_at(gt, gt_st, 1 + k0 + j);
        }
      }
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        if (k0 + j < nE) {
          const int k = k0 + j;
          const bool ch = nh[j] != hb;
          store(k, ch ? sh[j] : st[j]);
          acc_h = E::add(acc_h, ch ? Val{} : sh[j]);   // Val{}: +0.0
          acc_t = E::add(acc_t, ch ? st[j] : Val{});
          if (col == 0) {
            ids[static_cast<int64_t>(k) * B + b] =
                ch ? nh[j] : neg_t[b * nt_row + k * nt_col];
          }
        }
      }
    }
    for (int k = nE; k < nE + nR; ++k) {       // relation negatives: h, t
      acc_h = E::add(acc_h, row_at(gh, gh_st, 1 + k));
      acc_t = E::add(acc_t, row_at(gt, gt_st, 1 + k));
    }
    store(nE, acc_h);
    store(nE + 1, acc_t);
    if (col == 0) {
      ids[static_cast<int64_t>(nE) * B + b] = hb;
      ids[static_cast<int64_t>(nE + 1) * B + b] = t[b * t_st];
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename E, bool kVec>
int launch_as(const int64_t* h, int64_t h_st, const int64_t* t, int64_t t_st,
              const int64_t* neg_h, int64_t nh_row, int64_t nh_col,
              const int64_t* neg_t, int64_t nt_row, int64_t nt_col,
              const typename E::Elem* gh, int64_t gh_st,
              const typename E::Elem* gt, int64_t gt_st, int64_t* ids,
              typename E::Elem* out, int B, int nE, int nR, int d,
              cudaStream_t s) {
  constexpr int kCols = kVec ? E::kVec : 1;
  const int64_t items = static_cast<int64_t>(B) * (d / kCols);
  // the card's resident threads for this kernel, found once a process
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, blocks = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, merge_rows_kernel<E, kVec>, kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * blocks * kThreads;
  }
  const int64_t per_thread = (items + resident - 1) / resident;
  const int64_t threads = (items + per_thread - 1) / per_thread;
  const int64_t grid = (threads + kThreads - 1) / kThreads;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  merge_rows_kernel<E, kVec><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      h, h_st, t, t_st, neg_h, nh_row, nh_col, neg_t, nt_row, nt_col, gh,
      gh_st, gt, gt_st, ids, out, B, nE, nR, d, items,
      static_cast<int>(per_thread));
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch(const int64_t* h, int64_t h_st, const int64_t* t, int64_t t_st,
           const int64_t* neg_h, int64_t nh_row, int64_t nh_col,
           const int64_t* neg_t, int64_t nt_row, int64_t nt_col,
           const typename E::Elem* gh, int64_t gh_st,
           const typename E::Elem* gt, int64_t gt_st, int64_t* ids,
           typename E::Elem* out, int B, int nE, int nR, int d,
           void* stream) {
  if (B < 0 || nE < 0 || nR < 0 || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % E::kVec == 0 && gh_st % E::kVec == 0 &&
                   gt_st % E::kVec == 0 && aligned16(gh) && aligned16(gt) &&
                   aligned16(out);
  if (vec) {
    return launch_as<E, true>(h, h_st, t, t_st, neg_h, nh_row, nh_col, neg_t,
                              nt_row, nt_col, gh, gh_st, gt, gt_st, ids, out,
                              B, nE, nR, d, s);
  }
  return launch_as<E, false>(h, h_st, t, t_st, neg_h, nh_row, nh_col, neg_t,
                             nt_row, nt_col, gh, gh_st, gt, gt_st, ids, out,
                             B, nE, nR, d, s);
}

}  // namespace

// id streams: int64 with element strides (a column of the sampler's records
// is a strided view); gradient streams: rows with unit column stride and row
// strides gh_st, gt_st; ids and out: new contiguous buffers
extern "C" int okst_merge_entity_rows(
    const int64_t* h, int64_t h_st, const int64_t* t, int64_t t_st,
    const int64_t* neg_h, int64_t nh_row, int64_t nh_col,
    const int64_t* neg_t, int64_t nt_row, int64_t nt_col, const float* gh,
    int64_t gh_st, const float* gt, int64_t gt_st, int64_t* ids, float* out,
    int B, int nE, int nR, int d, void* stream) {
  return launch<Fp32>(h, h_st, t, t_st, neg_h, nh_row, nh_col, neg_t, nt_row,
                      nt_col, gh, gh_st, gt, gt_st, ids, out, B, nE, nR, d,
                      stream);
}

// gh, gt and out: bf16 rows (their 16-bit patterns)
extern "C" int okst_merge_entity_rows_bf16(
    const int64_t* h, int64_t h_st, const int64_t* t, int64_t t_st,
    const int64_t* neg_h, int64_t nh_row, int64_t nh_col,
    const int64_t* neg_t, int64_t nt_row, int64_t nt_col,
    const unsigned short* gh, int64_t gh_st, const unsigned short* gt,
    int64_t gt_st, int64_t* ids, unsigned short* out, int B, int nE, int nR,
    int d, void* stream) {
  return launch<Bf16>(h, h_st, t, t_st, neg_h, nh_row, nh_col, neg_t, nt_row,
                      nt_col, gh, gh_st, gt, gt_st, ids, out, B, nE, nR, d,
                      stream);
}
