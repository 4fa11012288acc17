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
// relations instead, and each block works on its own run.
//
// Forward. What bounds it on an H100 is device memory, and its bytes are M:
// at the TransR config (below) it must read M of the 1,305 relations present
// (104.4 MB) and x (15.4 MB) and write y (7.7 MB), 38.1 us at 3.35 TB/s,
// against 11.5 us for its 385 M FMAs. So the design streams M_rho once, as
// whole rows in 16-byte copies, with several stages in flight:
//   - grid (rho, run chunk, column tile): a block takes a chunk of 4 * nrg
//     rows of the run of rho (40 rows at dr = 100) at the full width dr (column
//     tiles of 256 only above that). The grid's second dimension strides
//     over the chunks of a long run, so a hub relation (or a KG with few
//     relations) spreads over the card: ceil(8,192 / relation rows) blocks a
//     relation, 7 at the config, 683 with WN18RR's 12 rows. The run
//     lengths are known only on the device, so the grid cannot follow them:
//     the ~8,000 blocks that find no chunk at the config cost nothing
//     measurable, 32 blocks a relation (43,000) cost a third more time
//     (chip_smoke.py times 1, 7 and 32). A block whose first chunk lies past
//     the run's end, as every block of an absent relation, returns before
//     it copies anything;
//   - M_rho streams through a ring of kFwdStages stages, each a contiguous
//     span of te rows x dr (16 KB at te = 40) beside the chunk's x[:, e-tile],
//     all copied with cp.async; kFwdStages - 1 stages are in flight before
//     the first FMA and while a stage is computed;
//   - register tiles: a thread owns 4 rows of the chunk x one float4 column
//     group; a 4-e step reads four rows of M (LDS.128, consecutive lanes on
//     consecutive column groups) and its rows' x (LDS.128, a broadcast) for
//     64 FMAs; no shuffles;
//   - each y element is summed by one thread over e ascending with fmaf, so
//     the result does not depend on the grid and two launches give the same
//     bits; y is written with 16-byte stores.
// Odd widths (de or dr not a multiple of 4, or unaligned rows) take 4-byte
// copies and scalar stores; the shared layout is the same. Shared memory
// does not grow with de or dr, so the forward takes any de and dr up to
// 256 * 65,535 columns (the grid's z limit; cudaErrorInvalidValue beyond).
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

constexpr int kThreads = 256;          // 8 warps per block
constexpr int kLogThreads = 8;
static_assert(kThreads == 1 << kLogThreads,
              "stage_tile splits a block by shifts");
constexpr size_t kMaxSmem = 232448;    // opt-in limit of one block on sm_90

// forward
constexpr int kFwdStages = 3;          // ring of e-stages of M and x
constexpr int kFwdStageFloats = 4096;  // floats of M per stage: 16 KB
constexpr int kFwdTileCols = 256;      // columns per block at most
constexpr int kFwdMaxStageRows = 64;   // rows of M per stage at most
constexpr int kFwdMaxRowGroups = 16;   // 4-row groups per chunk at most
constexpr int kFwdBlocksPerSM = 3;     // resident blocks asked of ptxas
constexpr int kFwdTargetBlocks = 8192; // grid size up to which run chunks get
                                       // blocks of their own

// backward
constexpr int kRowChunk = 16;   // run rows staged per pass
constexpr int kMaxEGroups = 10; // e-tile rows / 4: te = 40 at most

// Stage rows [0, nrows) x columns [0, ncols) of a row-major source (row
// stride ld floats) into shared rows of `pitch` floats; the rest of rows
// [0, nrows_fill) x columns [0, ncols_fill) is zero-filled (ncols_fill a
// multiple of 4). A row's copies go to a power-of-two group of threads
// (the whole block for a row of more than kThreads copies) and the groups
// walk the rows, so no copy costs a division. VEC: 16-byte copies (ncols
// and ld multiples of 4, 16-byte aligned source); otherwise 4-byte copies.
template <bool VEC>
__device__ __forceinline__ void stage_tile(float* dst, int pitch,
                                           const float* __restrict__ src,
                                           long long ld, int nrows,
                                           int nrows_fill, int ncols,
                                           int ncols_fill) {
  constexpr int kW = VEC ? 4 : 1;
  const int lg = min(kLogThreads, 32 - __clz(ncols_fill / kW - 1));
  const int col0 = (threadIdx.x & ((1 << lg) - 1)) * kW;
  for (int row = threadIdx.x >> lg; row < nrows_fill;
       row += kThreads >> lg) {
    for (int col = col0; col < ncols_fill; col += kW << lg) {
      const bool ok = row < nrows && col < ncols;
      const float* s = ok ? src + row * ld + col : src;
      if (VEC) {
        cp_async16(dst + row * pitch + col, s, ok ? 16 : 0);
      } else {
        cp_async4(dst + row * pitch + col, s, ok ? 4 : 0);
      }
    }
  }
}

// Forward geometry, fixed per launch.
struct FwdShape {
  int de, dr;
  int tc;   // columns per block tile: dr rounded up to 4, kFwdTileCols at most
  int cgs;  // float4 column groups of a tile: tc / 4
  int nrg;  // 4-row groups per run chunk: a chunk is 4 * nrg rows
  int te;   // rows of M per stage (a multiple of 4)
  int px;   // floats per staged row of x: te + 4
};

template <bool VEC>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSM)
fwd_kernel(const float* __restrict__ m3, const float* __restrict__ x,
           const int* __restrict__ rel_off, float* __restrict__ y,
           FwdShape sh) {
  extern __shared__ __align__(16) float smem[];
  const int de = sh.de, dr = sh.dr, tc = sh.tc, te = sh.te, px = sh.px;
  const int chunk = 4 * sh.nrg;
  const int rho = blockIdx.x;
  const int start = rel_off[rho], end = rel_off[rho + 1];
  const long long first = start + static_cast<long long>(blockIdx.y) * chunk;
  if (first >= end) return;  // no chunk of this run: nothing copied

  const int c0 = blockIdx.z * tc;
  const int tcv = min(tc, dr - c0);    // valid columns of this tile
  const int tcv4 = (tcv + 3) & ~3;
  const int stage_floats = te * tc + chunk * px;
  const int n_st = (de + te - 1) / te;
  const float* m = m3 + static_cast<size_t>(rho) * de * dr + c0;
  // this thread's tile: rows 4 rg .. 4 rg + 3 of the chunk, columns
  // 4 cg .. 4 cg + 3 of the column tile
  const int cg = threadIdx.x % sh.cgs, rg = threadIdx.x / sh.cgs;

  for (long long n0 = first; n0 < end;
       n0 += static_cast<long long>(gridDim.y) * chunk) {
    const int rows = static_cast<int>(min(static_cast<long long>(chunk),
                                          end - n0));
    const int rows4 = (rows + 3) & ~3;
    const bool active = rg < sh.nrg && 4 * rg < rows && 4 * cg < tcv4;

    // stage st: M_rho[e-tile, column tile] and x[chunk, e-tile]
    auto stage = [&](int st) {
      float* ms = smem + (st % kFwdStages) * stage_floats;
      float* xs = ms + te * tc;
      const int e0 = st * te;
      const int tev = min(te, de - e0), tev4 = (tev + 3) & ~3;
      const float* src = m + static_cast<size_t>(e0) * dr;
      if (VEC && tc == dr) {  // one contiguous span of tev * dr floats
        for (int i = threadIdx.x; i < tev * (dr / 4); i += kThreads) {
          cp_async16(ms + 4 * i, src + 4 * i, 16);
        }
      } else {
        stage_tile<VEC>(ms, tc, src, dr, tev, tev4, tcv, tcv4);
      }
      stage_tile<VEC>(xs, px, x + n0 * de + e0, de, rows, rows4, tev, tev4);
    };

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;
    }
    for (int st = 0; st < kFwdStages - 1; ++st) {
      if (st < n_st) stage(st);
      cp_async_commit();
    }
    for (int st = 0; st < n_st; ++st) {
      if (st + kFwdStages - 1 < n_st) stage(st + kFwdStages - 1);
      cp_async_commit();
      cp_async_wait<kFwdStages - 1>();  // stage st has landed
      __syncthreads();
      if (active) {
        const float* mp = smem + (st % kFwdStages) * stage_floats + 4 * cg;
        const float* xp = mp - 4 * cg + te * tc + 4 * rg * px;
        const int tev4 = (min(te, de - st * te) + 3) & ~3;
#pragma unroll 2
        for (int e = 0; e < tev4; e += 4) {
          float4 mv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            mv[u] = *reinterpret_cast<const float4*>(mp + (e + u) * tc);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 xv =
                *reinterpret_cast<const float4*>(xp + i * px + e);
            const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
            // e, e + 1, e + 2, e + 3 in order
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[i][0] = fmaf(xa[u], mv[u].x, acc[i][0]);
              acc[i][1] = fmaf(xa[u], mv[u].y, acc[i][1]);
              acc[i][2] = fmaf(xa[u], mv[u].z, acc[i][2]);
              acc[i][3] = fmaf(xa[u], mv[u].w, acc[i][3]);
            }
          }
        }
      }
      __syncthreads();  // before this stage's buffer is copied into again
    }

    if (!active) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (4 * rg + i >= rows) break;
      float* out = y + (n0 + 4 * rg + i) * dr + c0 + 4 * cg;
      if (VEC) {
        *reinterpret_cast<float4*>(out) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (4 * cg + k < tcv) out[k] = acc[i][k];
        }
      }
    }
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
  stage_tile<VEC>(ms, pitch, m3 + (static_cast<size_t>(rho) * de + e0) * dr,
                  dr, te_valid, te_valid, dr, dr4);

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
    stage_tile<VEC>(gs, pitch, g + static_cast<size_t>(n0) * dr, dr, rows,
                    rows, dr, dr4);
    stage_tile<VEC>(xs, te, x + static_cast<size_t>(n0) * de + e0, de, rows,
                    rows, te_valid, te);
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

template <bool VEC>
cudaError_t launch_fwd(const float* m3, const float* x, const int* rel_off,
                       float* y, int rows, const FwdShape& sh,
                       cudaStream_t s) {
  const size_t smem = static_cast<size_t>(kFwdStages) *
                      (sh.te * sh.tc + 4 * sh.nrg * sh.px) * sizeof(float);
  cudaError_t err = allow_smem(fwd_kernel<VEC>, smem);
  if (err != cudaSuccess) return err;
  const int col_tiles = (sh.dr + sh.tc - 1) / sh.tc;
  if (col_tiles > 65535) return cudaErrorInvalidValue;
  // blocks per relation: the run's length is known only on the device, so
  // the grid is sized by the relation rows alone
  const int gy = min(65535, (kFwdTargetBlocks + rows - 1) / rows);
  const dim3 grid(rows, gy, col_tiles);
  fwd_kernel<VEC><<<grid, kThreads, smem, s>>>(m3, x, rel_off, y, sh);
  return cudaGetLastError();
}

}  // namespace

// Any d_e; d_r up to kFwdTileCols * 65,535 columns (cudaErrorInvalidValue
// beyond).
extern "C" int okst_grouped_project_fwd(const float* m3, const float* x,
                                        const int* rel_off, float* y,
                                        int rows, int de, int dr,
                                        void* stream) {
  if (rows < 0 || de < 1 || dr < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  FwdShape sh;
  sh.de = de;
  sh.dr = dr;
  sh.tc = min(kFwdTileCols, (dr + 3) & ~3);
  sh.cgs = sh.tc / 4;
  sh.nrg = min(kFwdMaxRowGroups, kThreads / sh.cgs);
  sh.te = max(4, min(min((de + 3) & ~3, kFwdMaxStageRows),
                     (kFwdStageFloats / sh.tc) & ~3));
  sh.px = sh.te + 4;
  const bool vec = dr % 4 == 0 && de % 4 == 0 && aligned16(m3) &&
                   aligned16(x) && aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec ? launch_fwd<true>(m3, x, rel_off, y, rows, sh, s)
          : launch_fwd<false>(m3, x, rel_off, y, rows, sh, s));
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
