// Sorted-run scatter-add into wide table rows (sm_90a): table[ids] += delta.
//
// Replaces the TPU kernel of openkeonspark_tpu/ops/pallas_scatter.py: _kernel
// (reached through scatter_add_rows_sorted). The wrapper (ops/scatter.py)
// sorts the ids stably and hands over
//   order  [N]         int64: delta row of the j-th sorted id
//   off    [rows + 1]  int32: destination row rho owns sorted positions
//                      [off[rho], off[rho + 1]) (a run, possibly empty);
//                      ids outside [0, rows) lie in no run and are dropped
// so every destination row's duplicates are consecutive and in their
// original order. Each row is read once, its run's deltas are added one at a
// time starting from the table's value,
//
//   row <- ((row + d_0) + d_1) + ...   in stable-sorted order,
//
// and the row is written once. That order is the whole contract: the JAX
// kernel adds in the same order (tbuf + dbuf per step), so kernel and plain
// version agree bit for bit. Additions only, each an explicit __fadd_rn: no
// contraction, no fast math, no atomics.
//
// Design. The TPU kernel walked the sorted stream on one core with a ring of
// row-sized DMAs. Here the grid is (destination row x 512-column tile): a
// block whose run is empty exits at once; otherwise each of its 128 threads
// owns 4 columns of the tile, loads them once, walks the run in order and
// stores them once. Blocks touch disjoint (row, tile) pairs, so nothing
// depends on the order in which blocks run. kInFlight delta loads are issued
// before their additions, so a long (hub) run keeps several loads in flight
// per thread while the additions stay in order. A row stride that is a
// multiple of 4 floats (and 16-byte aligned pointers) takes float4 loads;
// any other width takes scalar loads, 4 columns per thread strided by the
// block, so no load is misaligned.
//
// What bounds it on an H100: bytes. At TransR's generic step (9,626 ids into
// 1,346 rows of 20,000 floats) it reads 770 MB of deltas and reads and writes
// at most 108 MB of rows each: >= 0.3 ms at 3.35 TB/s. A hub run is walked
// serially by its row's 40 tiles, which bounds the kernel when one relation
// holds a large share of the batch.
//
// bf16 tables (the reference's scatter on a table.dtype == bfloat16 table,
// whose tbuf + dbuf adds in bf16): the same kernels over rows of bf16 bits,
// eight columns to a 16-byte load, each add rounded once to bf16 in run
// order (row_types.cuh), as the plain version (index_add_ on a bf16 tensor)
// and the JAX kernel round. Half the fp32 bytes: the bound is half of the
// fp32 kernel's.
//
// Plain C interface, loaded with ctypes (ops/build.py); each launcher returns
// the cudaError_t of its launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "row_types.cuh"

namespace {

using okst::Bf16;
using okst::Fp32;

constexpr int kThreads = 128;
constexpr int kInFlight = 8;                   // delta loads before their adds

// width % kVec == 0, 16-byte aligned bases: thread owns kVec consecutive
// columns
template <typename E>
__global__ void __launch_bounds__(kThreads)
scatter_rows_vec_kernel(typename E::Elem* __restrict__ table,
                        const typename E::Elem* __restrict__ delta,
                        const int64_t* __restrict__ order,
                        const int* __restrict__ off, int width) {
  using Vec = typename E::Vec;
  const int row = blockIdx.x;
  const int start = off[row], end = off[row + 1];
  if (start >= end) return;
  const int col = blockIdx.y * kThreads * E::kVec + threadIdx.x * E::kVec;
  if (col >= width) return;
  Vec* dst = reinterpret_cast<Vec*>(
      table + static_cast<size_t>(row) * width + col);
  Vec acc = *dst;
  for (int j = start; j < end; j += kInFlight) {
    const int n = min(kInFlight, end - j);
    Vec d[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (k < n) {
        d[k] = __ldg(reinterpret_cast<const Vec*>(
            delta + static_cast<size_t>(order[j + k]) * width + col));
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (k < n) acc = E::add(acc, d[k]);  // in run order
    }
  }
  *dst = acc;
}

// any width: thread owns columns c0 + threadIdx.x + kThreads * c
template <typename E>
__global__ void __launch_bounds__(kThreads)
scatter_rows_scalar_kernel(typename E::Elem* __restrict__ table,
                           const typename E::Elem* __restrict__ delta,
                           const int64_t* __restrict__ order,
                           const int* __restrict__ off, int width) {
  using Elem = typename E::Elem;
  constexpr int kCols = E::kVec;
  const int row = blockIdx.x;
  const int start = off[row], end = off[row + 1];
  if (start >= end) return;
  const int c0 = blockIdx.y * kThreads * kCols + threadIdx.x;
  Elem* dst = table + static_cast<size_t>(row) * width;
  Elem acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = c0 + kThreads * c;
    acc[c] = col < width ? dst[col] : E::zero();
  }
  for (int j = start; j < end; j += kInFlight) {
    const int n = min(kInFlight, end - j);
    Elem d[kInFlight][kCols];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (k < n) {
        const Elem* src = delta + static_cast<size_t>(order[j + k]) * width;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int col = c0 + kThreads * c;
          d[k][c] = col < width ? E::load(src + col) : E::zero();
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (k < n) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = E::add(acc[c], d[k][c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = c0 + kThreads * c;
    if (col < width) dst[col] = acc[c];
  }
}

template <typename E>
int launch(typename E::Elem* table, const typename E::Elem* delta,
           const int64_t* order, const int* off, int rows, int width,
           void* stream) {
  if (rows < 0 || width < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int tile = kThreads * E::kVec;
  const int tiles = (width + tile - 1) / tile;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(rows, tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = width % E::kVec == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(delta) % 16 == 0;
  if (vec) {
    scatter_rows_vec_kernel<E><<<grid, kThreads, 0, s>>>(table, delta, order,
                                                         off, width);
  } else {
    scatter_rows_scalar_kernel<E><<<grid, kThreads, 0, s>>>(
        table, delta, order, off, width);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int okst_scatter_add_rows_sorted(float* table, const float* delta,
                                            const int64_t* order,
                                            const int* off, int rows,
                                            int width, void* stream) {
  return launch<Fp32>(table, delta, order, off, rows, width, stream);
}

// table and delta: bf16 rows (their 16-bit patterns)
extern "C" int okst_scatter_add_rows_sorted_bf16(unsigned short* table,
                                                 const unsigned short* delta,
                                                 const int64_t* order,
                                                 const int* off, int rows,
                                                 int width, void* stream) {
  return launch<Bf16>(table, delta, order, off, rows, width, stream);
}
