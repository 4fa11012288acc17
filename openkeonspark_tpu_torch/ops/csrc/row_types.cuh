// Row element types of the row kernels (scatter_rows.cu, merge_rows.cu,
// sm_90a): fp32 rows, and bf16 rows held as their 16-bit patterns. Each add
// rounds as eager PyTorch rounds one add in the row's dtype, so a kernel that
// adds in the plain version's order agrees with it bit for bit.
//
// bf16: an add is an fp32 __fadd_rn of the two bf16 values, rounded once to
// bf16 (__float2bfloat16_rn): the fp32 sum of two bf16 values is exact, or,
// when their exponents lie more than 16 apart, off by far less than half a
// bf16 ulp of the larger, so the one rounding gives the correctly rounded
// bf16 sum, as PyTorch's bf16 add (widen, add in fp32, round) gives it.
// Never build with --use_fast_math: every add is an explicit __fadd_rn.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace okst {

// fp32 rows: four columns to a float4
struct Fp32 {
  using Elem = float;
  using Vec = float4;
  static constexpr int kVec = 4;               // columns per 16-byte load
  __device__ static float zero() { return 0.0f; }
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float4 add(float4 a, float4 b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  }
};

// bf16 rows as their 16-bit patterns: eight columns to a uint4, the lower
// column in the low half of each 32-bit word
struct Bf16 {
  using Elem = unsigned short;
  using Vec = uint4;
  static constexpr int kVec = 8;
  __device__ static unsigned short zero() { return 0; }
  __device__ static unsigned short load(const unsigned short* p) {
    return __ldg(p);
  }
  __device__ static unsigned short add_f(float a, float b) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(__fadd_rn(a, b)));
  }
  __device__ static unsigned short add(unsigned short a, unsigned short b) {
    return add_f(__uint_as_float(static_cast<uint32_t>(a) << 16),
                 __uint_as_float(static_cast<uint32_t>(b) << 16));
  }
  __device__ static uint32_t add2(uint32_t a, uint32_t b) {
    const uint32_t lo = add_f(__uint_as_float(a << 16),
                              __uint_as_float(b << 16));
    const uint32_t hi = add_f(__uint_as_float(a & 0xffff0000u),
                              __uint_as_float(b & 0xffff0000u));
    return lo | (hi << 16);
  }
  __device__ static uint4 add(uint4 a, uint4 b) {
    return make_uint4(add2(a.x, b.x), add2(a.y, b.y), add2(a.z, b.z),
                      add2(a.w, b.w));
  }
};

}  // namespace okst
