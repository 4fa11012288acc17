// Relation-grouped projection for TransR training (sm_90a), forward and
// backward.
//
// Replaces the TPU kernels of openkeonspark_tpu/ops/pallas_grouped.py:
// _fwd_kernel (reached through _grouped_project_fwd_impl) and _bwd_kernel
// (through _grouped_project_bwd_impl). The rows of x are sorted by relation;
// relation rho owns rows [rel_off[rho], rel_off[rho + 1]) (a run, possibly
// empty). With m3 = transfer_matrix viewed as [rows, de, dr]:
//
//   forward   y[n]      = x[n] @ M[rel[n]]                       [N, dr]
//   backward  dx[n]     = g[n] @ M[rel[n]]^T                     [N, de]
//             dM[rho]   = sum over the run of rho of x[n]^T g[n] [rows, de, dr]
//
// dM is dense: every (rho, e, r) is written exactly once, zero for a
// relation with an empty run, so no memset and no atomics, and the result
// does not depend on the order in which blocks run.
//
// Design. The TPU kernel walked 128-row blocks on a sequential grid and
// carried a run's partial dM in VMEM across blocks. Here the grid covers the
// relations instead (blockIdx.x = rho), and each block loops over its own
// run:
//   - fwd: grid (rows, ceil(dr / 32)); the block stages M_rho[:, 32 columns]
//     in shared memory (de x 32 floats, 25.6 KB at de = 200), then each warp
//     takes rows of the run: lane c owns output column r0 + c, and x[n] is
//     broadcast 32 lanes at a time with __shfl_sync.
//   - dx: grid (rows, ceil(de / 32)); the same with M_rho[32 rows, :]
//     staged transposed and padded (dr x 33 floats) and g[n] broadcast.
//   - dM: grid (rows, ceil(de / 32) * ceil(dr / 32)); each block owns a
//     32 x 32 tile of dM[rho], stages 32 rows of x and g at a time, and
//     sums x[n, e] * g[n, r] over the run in ascending n, 4 outputs per
//     thread. A block whose run is empty writes its tile of zeros.
// Precision: fp32 FMA (fmaf) throughout, no tensor cores and so no TF32
// rounding: the dM contraction is the gradient sum itself.
//
// What bounds it on an H100: at the TransR config (19,252 rows, de = 200,
// dr = 100, 1,346 relation rows, nearly every relation present) each pass
// reads all of m3 (107.7 MB) and the backward writes all of dM (107.7 MB);
// the row streams (15.4 MB of x, 7.7 MB of g) are re-read per column tile
// mostly from the 50 MB L2. So device-memory bytes bound it: tens of
// microseconds per kernel at 3.35 TB/s. wgmma and TMA are later work.
//
// Plain C interface, loaded with ctypes (ops/build.py); each launcher
// returns the cudaError_t of its launches.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;              // columns (fwd), rows (dx), tile side (dM)
constexpr int kThreads = 256;          // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kRowChunk = 32;          // run rows staged per pass in dM
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;    // opt-in limit of one block on sm_90

__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ m3, const float* __restrict__ x,
           const int* __restrict__ rel_off, float* __restrict__ y, int de,
           int dr) {
  extern __shared__ float ms[];  // [de][kTile]: M_rho[:, r0 : r0 + kTile]
  const int rho = blockIdx.x;
  const int start = rel_off[rho], end = rel_off[rho + 1];
  if (start >= end) return;
  const int r0 = blockIdx.y * kTile;
  const float* m = m3 + static_cast<size_t>(rho) * de * dr;
  for (int i = threadIdx.x; i < de * kTile; i += kThreads) {
    const int e = i / kTile, c = i % kTile;
    ms[i] = (r0 + c < dr) ? m[static_cast<size_t>(e) * dr + r0 + c] : 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n = start + warp; n < end; n += kWarps) {
    const float* xr = x + static_cast<size_t>(n) * de;
    float acc = 0.0f;
    for (int e0 = 0; e0 < de; e0 += 32) {
      const float xv = (e0 + lane < de) ? xr[e0 + lane] : 0.0f;
      const int ne = min(32, de - e0);  // uniform across the warp
      for (int j = 0; j < ne; ++j) {
        acc = fmaf(__shfl_sync(kFull, xv, j), ms[(e0 + j) * kTile + lane],
                   acc);
      }
    }
    if (r0 + lane < dr) y[static_cast<size_t>(n) * dr + r0 + lane] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
dx_kernel(const float* __restrict__ m3, const float* __restrict__ g,
          const int* __restrict__ rel_off, float* __restrict__ dx, int de,
          int dr) {
  // [dr][kTile + 1]: M_rho[e0 : e0 + kTile, :] transposed; the pad column
  // keeps the transposing stores free of bank conflicts
  extern __shared__ float ms[];
  const int rho = blockIdx.x;
  const int start = rel_off[rho], end = rel_off[rho + 1];
  if (start >= end) return;
  const int e0 = blockIdx.y * kTile;
  const float* m = m3 + static_cast<size_t>(rho) * de * dr;
  for (int i = threadIdx.x; i < kTile * dr; i += kThreads) {
    const int el = i / dr, r = i % dr;  // consecutive threads: consecutive r
    ms[r * (kTile + 1) + el] =
        (e0 + el < de) ? m[static_cast<size_t>(e0 + el) * dr + r] : 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n = start + warp; n < end; n += kWarps) {
    const float* gr = g + static_cast<size_t>(n) * dr;
    float acc = 0.0f;
    for (int r0 = 0; r0 < dr; r0 += 32) {
      const float gv = (r0 + lane < dr) ? gr[r0 + lane] : 0.0f;
      const int nr = min(32, dr - r0);
      for (int j = 0; j < nr; ++j) {
        acc = fmaf(__shfl_sync(kFull, gv, j), ms[(r0 + j) * (kTile + 1) + lane],
                   acc);
      }
    }
    if (e0 + lane < de) dx[static_cast<size_t>(n) * de + e0 + lane] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
dm_kernel(const float* __restrict__ x, const float* __restrict__ g,
          const int* __restrict__ rel_off, float* __restrict__ dm, int de,
          int dr, int r_tiles) {
  __shared__ float xs[kRowChunk][kTile];  // x[n, e0 : e0 + kTile]
  __shared__ float gs[kRowChunk][kTile];  // g[n, r0 : r0 + kTile]
  constexpr int kPerThread = kTile / kWarps;
  const int rho = blockIdx.x;
  const int start = rel_off[rho], end = rel_off[rho + 1];
  const int e0 = (blockIdx.y / r_tiles) * kTile;
  const int r0 = (blockIdx.y % r_tiles) * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // thread (warp, lane) owns dM[rho, e0 + warp + kWarps * k, r0 + lane]
  float acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0.0f;

  for (int c0 = start; c0 < end; c0 += kRowChunk) {
    const int rows = min(kRowChunk, end - c0);
    for (int i = threadIdx.x; i < kRowChunk * kTile; i += kThreads) {
      const int rr = i / kTile, cc = i % kTile;
      const size_t n = static_cast<size_t>(c0 + rr);
      xs[rr][cc] = (rr < rows && e0 + cc < de) ? x[n * de + e0 + cc] : 0.0f;
      gs[rr][cc] = (rr < rows && r0 + cc < dr) ? g[n * dr + r0 + cc] : 0.0f;
    }
    __syncthreads();
    for (int rr = 0; rr < rows; ++rr) {  // ascending n: a fixed order
      const float gv = gs[rr][lane];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        acc[k] = fmaf(xs[rr][warp + kWarps * k], gv, acc[k]);
      }
    }
    __syncthreads();
  }

  if (r0 + lane >= dr) return;
  float* out = dm + static_cast<size_t>(rho) * de * dr + r0 + lane;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = e0 + warp + kWarps * k;
    if (e < de) out[static_cast<size_t>(e) * dr] = acc[k];
  }
}

// Raise the dynamic shared-memory limit of `kernel` where `bytes` needs it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int okst_grouped_project_fwd(const float* m3, const float* x,
                                        const int* rel_off, float* y,
                                        int rows, int de, int dr,
                                        void* stream) {
  if (rows < 0 || de < 1 || dr < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(de) * kTile * sizeof(float);
  cudaError_t err = allow_smem(fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(rows, (dr + kTile - 1) / kTile);
  fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      m3, x, rel_off, y, de, dr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int okst_grouped_project_bwd(const float* m3, const float* x,
                                        const float* g, const int* rel_off,
                                        float* dx, float* dm, int rows,
                                        int de, int dr, void* stream) {
  if (rows < 0 || de < 1 || dr < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(dr) * (kTile + 1) * sizeof(float);
  cudaError_t err = allow_smem(dx_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int e_tiles = (de + kTile - 1) / kTile;
  const int r_tiles = (dr + kTile - 1) / kTile;
  dx_kernel<<<dim3(rows, e_tiles), kThreads, smem, s>>>(m3, g, rel_off, dx,
                                                        de, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dm_kernel<<<dim3(rows, e_tiles * r_tiles), kThreads, 0, s>>>(
      x, g, rel_off, dm, de, dr, r_tiles);
  return static_cast<int>(cudaGetLastError());
}
