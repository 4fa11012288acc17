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
// Plain C interface, loaded with ctypes (ops/build.py); the launcher returns
// the cudaError_t of its launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;                       // columns per thread
constexpr int kTileCols = kThreads * kCols;    // columns per block
constexpr int kInFlight = 8;                   // delta loads before their adds

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// width % 4 == 0, 16-byte aligned bases: thread owns 4 consecutive columns
__global__ void __launch_bounds__(kThreads)
scatter_rows_vec_kernel(float* __restrict__ table,
                        const float* __restrict__ delta,
                        const int64_t* __restrict__ order,
                        const int* __restrict__ off, int width) {
  const int row = blockIdx.x;
  const int start = off[row], end = off[row + 1];
  if (start >= end) return;
  const int col = blockIdx.y * kTileCols + threadIdx.x * kCols;
  if (col >= width) return;
  float4* dst = reinterpret_cast<float4*>(
      table + static_cast<size_t>(row) * width + col);
  float4 acc = *dst;
  for (int j = start; j < end; j += kInFlight) {
    const int n = min(kInFlight, end - j);
    float4 d[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (k < n) {
        d[k] = __ldg(reinterpret_cast<const float4*>(
            delta + static_cast<size_t>(order[j + k]) * width + col));
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (k < n) acc = add4(acc, d[k]);  // in run order
    }
  }
  *dst = acc;
}

// any width: thread owns columns c0 + threadIdx.x + kThreads * c
__global__ void __launch_bounds__(kThreads)
scatter_rows_scalar_kernel(float* __restrict__ table,
                           const float* __restrict__ delta,
                           const int64_t* __restrict__ order,
                           const int* __restrict__ off, int width) {
  const int row = blockIdx.x;
  const int start = off[row], end = off[row + 1];
  if (start >= end) return;
  const int c0 = blockIdx.y * kTileCols + threadIdx.x;
  float* dst = table + static_cast<size_t>(row) * width;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = c0 + kThreads * c;
    acc[c] = col < width ? dst[col] : 0.0f;
  }
  for (int j = start; j < end; j += kInFlight) {
    const int n = min(kInFlight, end - j);
    float d[kInFlight][kCols];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (k < n) {
        const float* src = delta + static_cast<size_t>(order[j + k]) * width;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int col = c0 + kThreads * c;
          d[k][c] = col < width ? __ldg(src + col) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (k < n) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = __fadd_rn(acc[c], d[k][c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = c0 + kThreads * c;
    if (col < width) dst[col] = acc[c];
  }
}

}  // namespace

extern "C" int okst_scatter_add_rows_sorted(float* table, const float* delta,
                                            const int64_t* order,
                                            const int* off, int rows,
                                            int width, void* stream) {
  if (rows < 0 || width < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int tiles = (width + kTileCols - 1) / kTileCols;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(rows, tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = width % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(delta) % 16 == 0;
  if (vec) {
    scatter_rows_vec_kernel<<<grid, kThreads, 0, s>>>(table, delta, order,
                                                      off, width);
  } else {
    scatter_rows_scalar_kernel<<<grid, kThreads, 0, s>>>(table, delta, order,
                                                         off, width);
  }
  return static_cast<int>(cudaGetLastError());
}
