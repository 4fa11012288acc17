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
// The TPU kernel walked 128-row blocks on a sequential grid and carried a
// run's partial dM in VMEM across blocks. Here the grid covers the
// relations instead, and each block loops over its own run.
//
// Forward: grid (rows, ceil(dr / 32)); the block stages M_rho[:, 32 columns]
// in shared memory (de x 32 floats, 25.6 KB at de = 200), then each warp
// takes rows of the run: lane c owns output column r0 + c, and x[n] is
// broadcast 32 lanes at a time with __shfl_sync.
//
// Backward: one kernel for dx and dM. What bounds it on an H100 is device
// memory: at the TransR config (N = 19,252 rows, de = 200, dr = 100, 1,346
// relation rows, runs of 14 rows on average, 48 at most) it must read M
// (107.7 MB), x (15.4 MB) and g (7.7 MB) and write dM (107.7 MB) and dx
// (15.4 MB): 253.9 MB, 75.8 us at 3.35 TB/s; its 770 M FMAs take 23 us at
// the fp32 peak. So the design streams M and dM once, in 16-byte units,
// with enough bytes in flight:
//   - grid (rho, e-tile of te rows of M_rho at full dr width): the block's
//     M tile and dM tile are each one contiguous span of te * dr floats
//     (te = 40 at the config: 16 KB each, 6,730 blocks);
//   - the block issues its whole M tile and its first chunk of g[run, :]
//     and x[run, e-tile] as cp.async copies before it computes anything,
//     and skips M of a relation whose run is empty;
//   - both products read the staged g and x: dM_rho[e-tile, :] +=
//     x[chunk, e-tile]^T g[chunk, :] with 4 x 4 register tiles per thread
//     (two LDS.128 per 16 FMAs), and dx[chunk, e-tile] = g[chunk, :]
//     M[e-tile, :]^T with 2 x 2 tiles over float4 column groups (four
//     LDS.128 per 16 FMAs); shared rows are padded to an odd number of
//     float4s, so those loads are free of bank conflicts;
//   - dM is written once with 16-byte stores, dx with coalesced stores,
//     each dx element by one block (the e-tiles are disjoint).
// dM is summed over the run in ascending n with fmaf, 16 rows per partial
// sum and the partials added in order: a fixed order, so two launches give
// the same bits. No tensor cores and no TF32: dM is the gradient sum
// itself. Odd widths (de or dr not a multiple of 4, or unaligned rows) take
// 4-byte copies and scalar stores; the shared layout is the same.
//
// Plain C interface, loaded with ctypes (ops/build.py); each launcher
// returns the cudaError_t of its launches.

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

using namespace okst;

constexpr int kTile = 32;              // fwd: output columns per block
constexpr int kThreads = 256;          // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;    // opt-in limit of one block on sm_90

// backward
constexpr int kRowChunk = 16;   // run rows staged per pass
constexpr int kMaxEGroups = 10; // e-tile rows / 4: te = 40 at most

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

// Backward geometry, fixed per launch.
struct BwdShape {
  int de, dr;
  int te;     // rows of M per e-tile (a multiple of 4)
  int pitch;  // floats per staged row of M and g: dr rounded up to 4, plus
              // 4 where that is an even number of float4s
  int rg_n;   // float4 column groups of dr
};

// Stage rows [0, nrows) of a row-major source (row stride ld floats, ncols
// valid columns) into shared rows of `pitch` floats, columns [0, ncols4)
// with ncols4 = ncols rounded up to 4; columns past ncols are zero-filled.
// VEC: 16-byte copies (ncols and ld multiples of 4, 16-byte aligned
// source); otherwise 4-byte copies.
template <bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const float* __restrict__ src,
                                           long long ld, int nrows,
                                           int ncols, int ncols4) {
  constexpr int kW = VEC ? 4 : 1;
  const int per_row = ncols4 / kW;
  for (int i = threadIdx.x; i < nrows * per_row; i += kThreads) {
    const int row = i / per_row, col = (i % per_row) * kW;
    const bool ok = col < ncols;
    const float* s = ok ? src + row * ld + col : src;
    if (VEC) {
      cp_async16(dst + row * pitch + col, s, ok ? 16 : 0);
    } else {
      cp_async4(dst + row * pitch + col, s, ok ? 4 : 0);
    }
  }
}

// acc + a . b, the four products added in order
__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const float* __restrict__ m3, const float* __restrict__ x,
           const float* __restrict__ g, const int* __restrict__ rel_off,
           float* __restrict__ dx, float* __restrict__ dm, BwdShape sh) {
  extern __shared__ __align__(16) float smem[];
  const int de = sh.de, dr = sh.dr, te = sh.te, pitch = sh.pitch;
  const int rg_n = sh.rg_n, eg_n = te / 4, dr4 = rg_n * 4;
  float* ms = smem;                       // [te][pitch]: M_rho[e-tile, :]
  float* gs = ms + te * pitch;            // [kRowChunk][pitch]: g[chunk, :]
  float* xs = gs + kRowChunk * pitch;     // [kRowChunk][te]: x[chunk, e-tile]
  const int rho = blockIdx.x;
  const int e0 = blockIdx.y * te;
  const int te_valid = min(te, de - e0);
  const int start = rel_off[rho], end = rel_off[rho + 1];
  float* dm_tile = dm + (static_cast<size_t>(rho) * de + e0) * dr;

  if (start >= end) {  // absent relation: its dM tile is zero, M unread
    const int n = te_valid * dr;  // one contiguous span
    if (VEC) {
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int i = threadIdx.x; i < n / 4; i += kThreads) {
        reinterpret_cast<float4*>(dm_tile)[i] = z;
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) dm_tile[i] = 0.0f;
    }
    return;
  }

  // M_rho[e-tile, :], then the first chunk; all copies in flight at once
  stage_rows<VEC>(ms, pitch, m3 + (static_cast<size_t>(rho) * de + e0) * dr,
                  dr, te_valid, dr, dr4);

  // this thread's dM tile (eg_n * rg_n <= kThreads): rows 4 eg .. 4 eg + 3
  // of the e-tile, columns 4 rg .. 4 rg + 3
  const bool has_tile = threadIdx.x < eg_n * rg_n;
  const int eg = threadIdx.x / rg_n, rg = threadIdx.x % rg_n;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;
  }
  const int half_te = te / 2;  // dx tiles: rows (i, i + 8), cols (j, j + te/2)

  for (int n0 = start; n0 < end; n0 += kRowChunk) {
    const int rows = min(kRowChunk, end - n0);
    stage_rows<VEC>(gs, pitch, g + static_cast<size_t>(n0) * dr, dr, rows,
                    dr, dr4);
    stage_rows<VEC>(xs, te, x + static_cast<size_t>(n0) * de + e0, de, rows,
                    te_valid, te);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // dM_rho[e-tile, :] += x[chunk, e-tile]^T g[chunk, :], ascending n
    if (has_tile) {
      float part[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) part[i][k] = 0.0f;
      }
      for (int n = 0; n < rows; ++n) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xs + n * te + 4 * eg);
        const float4 gv =
            *reinterpret_cast<const float4*>(gs + n * pitch + 4 * rg);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
        const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            part[i][k] = fmaf(xa[i], ga[k], part[i][k]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[i][k] = __fadd_rn(acc[i][k], part[i][k]);
        }
      }
    }

    // dx[chunk, e-tile] = g[chunk, :] M[e-tile, :]^T; zero-padded columns
    // add 0
    for (int cb = threadIdx.x; cb < (kRowChunk / 2) * half_te;
         cb += kThreads) {
      const int i = cb / half_te, j = cb % half_te;
      if (i >= rows) continue;
      const float* ga = gs + i * pitch;
      const float* gb = gs + (i + kRowChunk / 2) * pitch;
      const float* ma = ms + j * pitch;
      const float* mb = ms + (j + half_te) * pitch;
      float s00 = 0.0f, s01 = 0.0f, s10 = 0.0f, s11 = 0.0f;
      for (int c = 0; c < dr4; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(ga + c);
        const float4 b = *reinterpret_cast<const float4*>(gb + c);
        const float4 u = *reinterpret_cast<const float4*>(ma + c);
        const float4 v = *reinterpret_cast<const float4*>(mb + c);
        s00 = dot4(a, u, s00);
        s01 = dot4(a, v, s01);
        s10 = dot4(b, u, s10);
        s11 = dot4(b, v, s11);
      }
      float* out_a = dx + static_cast<size_t>(n0 + i) * de + e0;
      float* out_b = out_a + static_cast<size_t>(kRowChunk / 2) * de;
      const bool row_b = i + kRowChunk / 2 < rows;
      if (j < te_valid) {
        out_a[j] = s00;
        if (row_b) out_b[j] = s10;
      }
      if (j + half_te < te_valid) {
        out_a[j + half_te] = s01;
        if (row_b) out_b[j + half_te] = s11;
      }
    }
    __syncthreads();  // before the next chunk overwrites gs and xs
  }

  // the dM tile, written once
  if (!has_tile) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = 4 * eg + i;
    if (e >= te_valid) break;
    float* out = dm_tile + static_cast<size_t>(e) * dr + 4 * rg;
    if (VEC) {
      *reinterpret_cast<float4*>(out) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (4 * rg + k < dr) out[k] = acc[i][k];
      }
    }
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

template <bool VEC>
cudaError_t launch_bwd(const float* m3, const float* x, const float* g,
                       const int* rel_off, float* dx, float* dm, int rows,
                       const BwdShape& sh, cudaStream_t s) {
  const size_t smem =
      (static_cast<size_t>(sh.te + kRowChunk) * sh.pitch +
       static_cast<size_t>(kRowChunk) * sh.te) * sizeof(float);
  cudaError_t err = allow_smem(bwd_kernel<VEC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(rows, (sh.de + sh.te - 1) / sh.te);
  bwd_kernel<VEC><<<grid, kThreads, smem, s>>>(m3, x, g, rel_off, dx, dm,
                                               sh);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
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

// d_r up to 4 * kThreads = 1,024 columns (cudaErrorInvalidValue beyond).
extern "C" int okst_grouped_project_bwd(const float* m3, const float* x,
                                        const float* g, const int* rel_off,
                                        float* dx, float* dm, int rows,
                                        int de, int dr, void* stream) {
  if (rows < 0 || de < 1 || dr < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  BwdShape sh;
  sh.de = de;
  sh.dr = dr;
  sh.rg_n = (dr + 3) / 4;
  // e-groups of 4 rows per tile: one dM tile per thread, at most
  // kMaxEGroups, and no more than de needs
  int eg = min(kMaxEGroups, kThreads / sh.rg_n);
  eg = min(eg, (de + 3) / 4);
  if (eg < 1) return static_cast<int>(cudaErrorInvalidValue);
  sh.te = 4 * eg;
  sh.pitch = 4 * sh.rg_n + ((sh.rg_n % 2 == 0) ? 4 : 0);
  const bool vec = dr % 4 == 0 && de % 4 == 0 && aligned16(m3) &&
                   aligned16(x) && aligned16(g) && aligned16(dm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec ? launch_bwd<true>(m3, x, g, rel_off, dx, dm, rows, sh, s)
          : launch_bwd<false>(m3, x, g, rel_off, dx, dm, rows, sh, s));
}
