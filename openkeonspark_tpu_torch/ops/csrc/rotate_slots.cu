// RotatE's training slots scored and differentiated straight from their ids
// (sm_90a): a forward kernel that writes the slots' scores and a backward
// kernel that writes the entity table's update rows and the relation
// phases' gradient.
//
// Replaces no TPU kernel. The JAX package leaves RotatE's step to XLA's
// fusion (openkeonspark_tpu/train/step.py, models/rotate.py); in eager
// PyTorch the same step gathers every slot row (two [(1 + nE) * B, 2d]
// streams), writes each step of the rotation as a [1 + nE, B, d]
// intermediate, forward and back, and merges the slot gradients with
// merge_rows.cu. Here nothing but the scores, the update rows and the phase
// gradient leaves the chip's caches. With
//   B      positives (h[b], r[b], t[b]) and nE entity negatives each,
//   E      [rows, 2d] entity rows [re | im], theta [rows, d] phases,
//   ch_k   = neg_h[b, k] != h[b]  (negative k of positive b corrupts its
//          head; it keeps t[b]; otherwise it keeps h[b] and its tail
//          neg_t[b, k] is the corrupted entity, ops/merge.py's rule),
//   rot(x, th) = (xr * cos th - xi * sin th, xr * sin th + xi * cos th),
//   res    = rot(head, th) - tail, lane by lane,
//   s      = sum_l sqrt(res_re_l^2 + res_im_l^2 + 1e-12),
// the forward writes scores [1 + nE, B] (row 0 the positives, row 1 + k
// negative k), and the backward, given G = dL/dscores [1 + nE, B], writes
//   g      = (G / m_l) * res_l, m_l the lane's modulus; a slot's head row
//          gets rot(g, -th), its tail row -g;
//   ids [(nE + 2) * B], rows [(nE + 2) * B, 2d] in merge_rows.cu's layout:
//          segment k < nE the corrupted entity's id and row, then h with
//          base_h, then t with base_t, each base the positive's row plus,
//          k ascending, the kept side's row of every negative (+0.0 for a
//          negative that corrupts that side);
//   g_theta [B, d] the gradient of theta[r[b]], summed over the 1 + nE
//          slots.
//
// Rounding. Every lane step is the plain version's (ops/rotate_train.py,
// which runs models/rotate.py under autograd) written with __fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, so no step is contracted
// into an FMA: the residual ((xr * c) - (xi * s)) - tr; the modulus
// sqrt(((re * re) + (im * im)) + 1e-12); autograd's gradient of it,
// (G / m) * re (its G / (2m), times re, added to itself); the head row's
// (gr * c) + (gi * s) and (gi * c) - (gr * s); each slot row plus +0.0,
// as autograd adds the two halves' zero-filled gradients; the bases summed
// k ascending as merge_rows.cu sums them. cosf and sinf are the precise
// functions (no __sincosf). What differs from the plain version is the
// order of two kinds of sums: a score's sum over the d lanes (a thread's
// lanes in order, then a butterfly across the warp) and g_theta's sum over
// the slots (k ascending, where autograd reduces the broadcast with
// torch.sum), so the scores and g_theta agree within fp32 rounding of
// those sums, and given the same G the update rows agree bit for bit.
// Both kernels sum in one fixed order with no atomics: two launches on the
// same inputs give the same bits. Never build with --use_fast_math.
//
// What bounds it on an H100: bytes. Each slot reads one corrupted 8 KB row
// (at d = 1,000) in each kernel and the backward writes one 8 KB update row
// for it: at the RotatE cell's B = 1,024, nE = 256, 2.15 GB read forward,
// 2.15 GB read and 2.16 GB written back, 1.93 ms at 3.35 TB/s (the
// 14,541-row table's distinct rows are 116 MB, so rows hot in the 50 MB L2
// cost less). Design:
//   - forward: one block per positive. The block puts rot(h, th), t, cos th
//     and sin th in shared memory (6d floats), then each warp takes slots
//     (the positive, then negatives w, w + 8, ...) and streams the one row
//     the slot corrupts with 16-byte loads (four lanes of re and four of
//     im), unrolled so that several loads are in flight; a score is one
//     warp's, so it needs no block synchronisation;
//   - backward: no reduction across lanes, so a thread owns four lanes of
//     one positive and walks its slots in order, keeping the two bases and
//     theta's four partial sums (autograd's: g_re * hr, g_im * hi, -g_re *
//     hi, g_im * hr, over the slots) in registers; the block stages a chunk
//     of the negatives' ids and G in shared memory first, so a row load
//     waits for no id load, and two negatives' rows load before their
//     arithmetic.
// Rows that are not 16-byte aligned (d or a row stride not a multiple of 4,
// an unaligned view) take one lane a thread.
//
// Plain C interface, loaded with ctypes (ops/build.py); each launcher returns
// the cudaError_t of its launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kEps = 1e-12f;      // models/rotate.py's EPS, as torch rounds it
constexpr int kFwdThreads = 256;    // 8 warps, each a slot at a time
constexpr int kBwdThreads = 128;
constexpr int kChunk = 256;         // negatives staged at once (backward)
constexpr int kInFlight = 2;        // negatives whose rows load before math

// the id streams of a batch: int64 element strides, as the sampler's
// columns are strided views
struct Ids {
  const int64_t* h;
  int64_t h_st;
  const int64_t* t;
  int64_t t_st;
  const int64_t* r;
  int64_t r_st;
  const int64_t* neg_h;
  int64_t nh_row, nh_col;
  const int64_t* neg_t;
  int64_t nt_row, nt_col;
};

// V lanes of one half of a row
template <int V>
struct Lanes {
  float x[V];
};

template <int V>
__device__ __forceinline__ Lanes<V> load(const float* p) {
  Lanes<V> v;
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v.x[0] = q.x;
    v.x[1] = q.y;
    v.x[2] = q.z;
    v.x[3] = q.w;
  } else {
    v.x[0] = __ldg(p);
  }
  return v;
}

// shared or freshly written memory: a plain load
template <int V>
__device__ __forceinline__ Lanes<V> load_plain(const float* p) {
  Lanes<V> v;
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v.x[0] = q.x;
    v.x[1] = q.y;
    v.x[2] = q.z;
    v.x[3] = q.w;
  } else {
    v.x[0] = *p;
  }
  return v;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Lanes<V>& v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v.x[0], v.x[1], v.x[2],
                                                v.x[3]);
  } else {
    *p = v.x[0];
  }
}

// rot(x, th) as models/rotate.py rounds it: (xr * c) - (xi * s) and
// (xr * s) + (xi * c)
__device__ __forceinline__ void rot(float xr, float xi, float c, float s,
                                    float& out_r, float& out_i) {
  out_r = __fsub_rn(__fmul_rn(xr, c), __fmul_rn(xi, s));
  out_i = __fadd_rn(__fmul_rn(xr, s), __fmul_rn(xi, c));
}

__device__ __forceinline__ float modulus(float re, float im) {
  return __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)), kEps));
}

// the lanes [l, l + V) of slot scores' sum: sum of moduli in lane order
template <int V>
__device__ __forceinline__ float add_moduli(float acc, const Lanes<V>& re,
                                            const Lanes<V>& im) {
#pragma unroll
  for (int j = 0; j < V; ++j) acc = __fadd_rn(acc, modulus(re.x[j], im.x[j]));
  return acc;
}

template <int V>
__global__ void __launch_bounds__(kFwdThreads)
slot_scores_kernel(const float* __restrict__ E, int64_t e_st,
                   const float* __restrict__ theta, int64_t th_st, Ids ids,
                   float* __restrict__ scores, int B, int nE, int d) {
  extern __shared__ float4 smem4[];
  float* pr = reinterpret_cast<float*>(smem4);   // rot(h, th)
  float* pi = pr + d;
  float* tr = pi + d;                            // t
  float* ti = tr + d;
  float* cs = ti + d;                            // cos th, sin th
  float* sn = cs + d;
  const int b = blockIdx.x;
  const int64_t hb = ids.h[b * ids.h_st];
  const float* hrow = E + hb * e_st;
  const float* trow = E + ids.t[b * ids.t_st] * e_st;
  const float* th = theta + ids.r[b * ids.r_st] * th_st;
  for (int l = threadIdx.x; l < d; l += blockDim.x) {
    const float a = __ldg(th + l);
    const float c = cosf(a), s = sinf(a);
    rot(__ldg(hrow + l), __ldg(hrow + d + l), c, s, pr[l], pi[l]);
    tr[l] = __ldg(trow + l);
    ti[l] = __ldg(trow + d + l);
    cs[l] = c;
    sn[l] = s;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nv = d / V;
  for (int slot = warp; slot <= nE; slot += kFwdThreads / 32) {
    float acc = 0.0f;
    if (slot == 0) {                       // the positive: rot(h) - t
      for (int v = lane; v < nv; v += 32) {
        const int l = v * V;
        const Lanes<V> ar = load_plain<V>(pr + l), ai = load_plain<V>(pi + l);
        const Lanes<V> br = load_plain<V>(tr + l), bi = load_plain<V>(ti + l);
        Lanes<V> re, im;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          re.x[j] = __fsub_rn(ar.x[j], br.x[j]);
          im.x[j] = __fsub_rn(ai.x[j], bi.x[j]);
        }
        acc = add_moduli<V>(acc, re, im);
      }
    } else {
      const int k = slot - 1;
      const int64_t nh = ids.neg_h[b * ids.nh_row + k * ids.nh_col];
      const bool head = nh != hb;
      const float* row =
          E + (head ? nh : ids.neg_t[b * ids.nt_row + k * ids.nt_col]) * e_st;
      if (head) {                          // rot(h') - t
#pragma unroll 4
        for (int v = lane; v < nv; v += 32) {
          const int l = v * V;
          const Lanes<V> xr = load<V>(row + l), xi = load<V>(row + d + l);
          const Lanes<V> c = load_plain<V>(cs + l), s = load_plain<V>(sn + l);
          const Lanes<V> br = load_plain<V>(tr + l), bi = load_plain<V>(ti + l);
          Lanes<V> re, im;
#pragma unroll
          for (int j = 0; j < V; ++j) {
            rot(xr.x[j], xi.x[j], c.x[j], s.x[j], re.x[j], im.x[j]);
            re.x[j] = __fsub_rn(re.x[j], br.x[j]);
            im.x[j] = __fsub_rn(im.x[j], bi.x[j]);
          }
          acc = add_moduli<V>(acc, re, im);
        }
      } else {                             // rot(h) - t'
#pragma unroll 4
        for (int v = lane; v < nv; v += 32) {
          const int l = v * V;
          const Lanes<V> yr = load<V>(row + l), yi = load<V>(row + d + l);
          const Lanes<V> ar = load_plain<V>(pr + l), ai = load_plain<V>(pi + l);
          Lanes<V> re, im;
#pragma unroll
          for (int j = 0; j < V; ++j) {
            re.x[j] = __fsub_rn(ar.x[j], yr.x[j]);
            im.x[j] = __fsub_rn(ai.x[j], yi.x[j]);
          }
          acc = add_moduli<V>(acc, re, im);
        }
      }
    }
    // a butterfly: a + b == b + a, so every lane ends with the same bits
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
    }
    if (lane == 0) scores[static_cast<int64_t>(slot) * B + b] = acc;
  }
}

// one slot's lane: the gradient rows of its head and tail, given its
// residual (re, im) and G; each + 0.0 as autograd's zero-filled halves add
__device__ __forceinline__ void lane_grads(float G, float re, float im,
                                           float c, float s, float& gr,
                                           float& gi, float& hr_g,
                                           float& hi_g, float& tr_g,
                                           float& ti_g) {
  const float q = __fdiv_rn(G, modulus(re, im));
  gr = __fmul_rn(q, re);
  gi = __fmul_rn(q, im);
  hr_g = __fadd_rn(__fadd_rn(__fmul_rn(gr, c), __fmul_rn(gi, s)), 0.0f);
  hi_g = __fadd_rn(__fsub_rn(__fmul_rn(gi, c), __fmul_rn(gr, s)), 0.0f);
  tr_g = __fadd_rn(-gr, 0.0f);
  ti_g = __fadd_rn(-gi, 0.0f);
}

template <int V>
__global__ void __launch_bounds__(kBwdThreads)
slot_grads_kernel(const float* __restrict__ E, int64_t e_st,
                  const float* __restrict__ theta, int64_t th_st, Ids ids,
                  const float* __restrict__ G, int64_t* __restrict__ out_ids,
                  float* __restrict__ out, float* __restrict__ g_theta, int B,
                  int nE, int d) {
  __shared__ int64_t s_row[kChunk];     // the corrupted entity of a negative
  __shared__ float s_g[kChunk];         // its G
  __shared__ bool s_head[kChunk];       // it corrupts the head
  const int b = blockIdx.x;
  const int nv = d / V;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  const bool on = v < nv;
  const int l = on ? v * V : 0;
  const int64_t d2 = 2 * static_cast<int64_t>(d);
  const int64_t hb = ids.h[b * ids.h_st];
  const int64_t tb = ids.t[b * ids.t_st];
  auto out_row = [&](int seg) {
    return out + (static_cast<int64_t>(seg) * B + b) * d2 + l;
  };

  Lanes<V> c, s, hr, hi, pr, pi, tr, ti;
  // bases and theta's partial sums: g_re * hr, g_im * hi, -(g_re * hi),
  // g_im * hr of each slot's head (autograd's four products)
  Lanes<V> bhr, bhi, btr, bti, a1, a2, a3, a4;
  if (on) {
    const Lanes<V> th = load<V>(theta + ids.r[b * ids.r_st] * th_st + l);
    hr = load<V>(E + hb * e_st + l);
    hi = load<V>(E + hb * e_st + d + l);
    tr = load<V>(E + tb * e_st + l);
    ti = load<V>(E + tb * e_st + d + l);
    const float g0 = __ldg(G + b);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      c.x[j] = cosf(th.x[j]);
      s.x[j] = sinf(th.x[j]);
      rot(hr.x[j], hi.x[j], c.x[j], s.x[j], pr.x[j], pi.x[j]);
      float gr, gi;
      lane_grads(g0, __fsub_rn(pr.x[j], tr.x[j]), __fsub_rn(pi.x[j], ti.x[j]),
                 c.x[j], s.x[j], gr, gi, bhr.x[j], bhi.x[j], btr.x[j],
                 bti.x[j]);
      a1.x[j] = __fmul_rn(gr, hr.x[j]);
      a2.x[j] = __fmul_rn(gi, hi.x[j]);
      a3.x[j] = -__fmul_rn(gr, hi.x[j]);
      a4.x[j] = __fmul_rn(gi, hr.x[j]);
    }
  }

  for (int k0 = 0; k0 < nE; k0 += kChunk) {
    const int n = min(kChunk, nE - k0);
    __syncthreads();                    // the previous chunk is done
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int k = k0 + i;
      const int64_t nh = ids.neg_h[b * ids.nh_row + k * ids.nh_col];
      const bool head = nh != hb;
      const int64_t id =
          head ? nh : ids.neg_t[b * ids.nt_row + k * ids.nt_col];
      s_row[i] = id;
      s_head[i] = head;
      s_g[i] = __ldg(G + static_cast<int64_t>(1 + k) * B + b);
      if (blockIdx.y == 0) out_ids[static_cast<int64_t>(k) * B + b] = id;
    }
    __syncthreads();
    if (!on) continue;
    for (int i0 = 0; i0 < n; i0 += kInFlight) {
      Lanes<V> xr[kInFlight], xi[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        if (i0 + j < n) {
          const float* row = E + s_row[i0 + j] * e_st + l;
          xr[j] = load<V>(row);
          xi[j] = load<V>(row + d);
        }
      }
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        if (i0 + j >= n) continue;
        const int i = i0 + j;
        const bool head = s_head[i];
        const float g = s_g[i];
        Lanes<V> wr, wi;                 // the corrupted entity's row
#pragma unroll
        for (int q = 0; q < V; ++q) {
          float re, im, rr, ri;
          if (head) {                    // rot(h') - t
            rot(xr[j].x[q], xi[j].x[q], c.x[q], s.x[q], rr, ri);
            re = __fsub_rn(rr, tr.x[q]);
            im = __fsub_rn(ri, ti.x[q]);
          } else {                       // rot(h) - t'
            re = __fsub_rn(pr.x[q], xr[j].x[q]);
            im = __fsub_rn(pi.x[q], xi[j].x[q]);
          }
          float gr, gi, hr_g, hi_g, tr_g, ti_g;
          lane_grads(g, re, im, c.x[q], s.x[q], gr, gi, hr_g, hi_g, tr_g,
                     ti_g);
          const float sh = head ? xr[j].x[q] : hr.x[q];   // the slot's head
          const float shi = head ? xi[j].x[q] : hi.x[q];
          a1.x[q] = __fadd_rn(a1.x[q], __fmul_rn(gr, sh));
          a2.x[q] = __fadd_rn(a2.x[q], __fmul_rn(gi, shi));
          a3.x[q] = __fadd_rn(a3.x[q], -__fmul_rn(gr, shi));
          a4.x[q] = __fadd_rn(a4.x[q], __fmul_rn(gi, sh));
          wr.x[q] = head ? hr_g : tr_g;
          wi.x[q] = head ? hi_g : ti_g;
          bhr.x[q] = __fadd_rn(bhr.x[q], head ? 0.0f : hr_g);
          bhi.x[q] = __fadd_rn(bhi.x[q], head ? 0.0f : hi_g);
          btr.x[q] = __fadd_rn(btr.x[q], head ? tr_g : 0.0f);
          bti.x[q] = __fadd_rn(bti.x[q], head ? ti_g : 0.0f);
        }
        float* w = out_row(k0 + i);
        store<V>(w, wr);
        store<V>(w + d, wi);
      }
    }
  }
  if (!on) return;
  store<V>(out_row(nE), bhr);
  store<V>(out_row(nE) + d, bhi);
  store<V>(out_row(nE + 1), btr);
  store<V>(out_row(nE + 1) + d, bti);
  // theta's gradient as autograd forms it: cos th's ((a1 + a2) * -sin th)
  // plus sin th's ((a3 + a4) * cos th)
  Lanes<V> gt;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    gt.x[j] = __fadd_rn(__fmul_rn(__fadd_rn(a1.x[j], a2.x[j]), -s.x[j]),
                        __fmul_rn(__fadd_rn(a3.x[j], a4.x[j]), c.x[j]));
  }
  store<V>(g_theta + static_cast<int64_t>(b) * d + l, gt);
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    out_ids[static_cast<int64_t>(nE) * B + b] = hb;
    out_ids[static_cast<int64_t>(nE + 1) * B + b] = tb;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// 16-byte lane vectors where every row start and half is aligned
bool vec4(const float* E, int64_t e_st, const float* theta, int64_t th_st,
          int d) {
  return d % 4 == 0 && e_st % 4 == 0 && th_st % 4 == 0 && aligned16(E) &&
         aligned16(theta);
}

bool bad_shape(int B, int nE, int d) { return B < 0 || nE < 0 || d < 1; }

template <int V>
int launch_scores(const float* E, int64_t e_st, const float* theta,
                  int64_t th_st, const Ids& ids, float* scores, int B, int nE,
                  int d, cudaStream_t st) {
  const size_t smem = 6 * static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        slot_scores_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  slot_scores_kernel<V><<<B, kFwdThreads, smem, st>>>(
      E, e_st, theta, th_st, ids, scores, B, nE, d);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_grads(const float* E, int64_t e_st, const float* theta,
                 int64_t th_st, const Ids& ids, const float* G,
                 int64_t* out_ids, float* out, float* g_theta, int B, int nE,
                 int d, cudaStream_t st) {
  const int nv = d / V;
  const dim3 grid(B, (nv + kBwdThreads - 1) / kBwdThreads);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  slot_grads_kernel<V><<<grid, kBwdThreads, 0, st>>>(
      E, e_st, theta, th_st, ids, G, out_ids, out, g_theta, B, nE, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// E [rows, 2d] and theta [rows, d] fp32 with unit column stride and row
// strides e_st, th_st; h, t, r [B] and neg_h, neg_t [B, nE] int64 with
// element strides; scores [1 + nE, B] a new contiguous buffer
extern "C" int okst_rotate_slot_scores(
    const float* E, int64_t e_st, const float* theta, int64_t th_st,
    const int64_t* h, int64_t h_st, const int64_t* t, int64_t t_st,
    const int64_t* r, int64_t r_st, const int64_t* neg_h, int64_t nh_row,
    int64_t nh_col, const int64_t* neg_t, int64_t nt_row, int64_t nt_col,
    float* scores, int B, int nE, int d, void* stream) {
  if (bad_shape(B, nE, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const Ids ids{h, h_st, t, t_st, r, r_st, neg_h, nh_row, nh_col,
                neg_t, nt_row, nt_col};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4(E, e_st, theta, th_st, d)) {
    return launch_scores<4>(E, e_st, theta, th_st, ids, scores, B, nE, d, st);
  }
  return launch_scores<1>(E, e_st, theta, th_st, ids, scores, B, nE, d, st);
}

// the same tables and ids; G [1 + nE, B] contiguous; ids [(nE + 2) * B],
// out [(nE + 2) * B, 2d] and g_theta [B, d]: new contiguous buffers
extern "C" int okst_rotate_slot_grads(
    const float* E, int64_t e_st, const float* theta, int64_t th_st,
    const int64_t* h, int64_t h_st, const int64_t* t, int64_t t_st,
    const int64_t* r, int64_t r_st, const int64_t* neg_h, int64_t nh_row,
    int64_t nh_col, const int64_t* neg_t, int64_t nt_row, int64_t nt_col,
    const float* G, int64_t* out_ids, float* out, float* g_theta, int B,
    int nE, int d, void* stream) {
  if (bad_shape(B, nE, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const Ids ids{h, h_st, t, t_st, r, r_st, neg_h, nh_row, nh_col,
                neg_t, nt_row, nt_col};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4(E, e_st, theta, th_st, d) && aligned16(out) && aligned16(g_theta)) {
    return launch_grads<4>(E, e_st, theta, th_st, ids, G, out_ids, out,
                           g_theta, B, nE, d, st);
  }
  return launch_grads<1>(E, e_st, theta, th_st, ids, G, out_ids, out, g_theta,
                         B, nE, d, st);
}
