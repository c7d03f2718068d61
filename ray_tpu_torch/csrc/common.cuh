// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel reads and writes its tensors 16 bytes per thread (8 bf16
// or 4 f32 values) and computes in f32; these helpers hide the storage
// type behind that one access width.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  // The same from shared memory (no read-only cache path there).
  __device__ __forceinline__ static void load_shared(const float* p,
                                                     float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
  // The 16 bytes as they lie in memory, and back: kernels that hold a
  // row in registers keep it packed (4 registers a vector in either type).
  __device__ __forceinline__ static void widen(const uint4 v, float* out) {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* in) {
    return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]),
                      __float_as_uint(in[2]), __float_as_uint(in[3]));
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  // A bf16 value is the high half of the f32 with the same bits, so the
  // widening is two shifts/masks per 32-bit word (exact).
  __device__ __forceinline__ static void widen(const uint4 v, float* out) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    widen(__ldg(reinterpret_cast<const uint4*>(p)), out);
  }
  __device__ __forceinline__ static void load_shared(const __nv_bfloat16* p,
                                                     float* out) {
    widen(*reinterpret_cast<const uint4*>(p), out);
  }
  // Round 8 f32 values to bf16 (to nearest even, as torch's cast).
  __device__ __forceinline__ static uint4 pack(const float* in) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16(in[2 * i]));
      const uint32_t hi =
          __bfloat16_as_ushort(__float2bfloat16(in[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* in) {
    *reinterpret_cast<uint4*>(p) = pack(in);
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Round an f32 value through the storage type (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// dtype codes passed from Python (ops/_build.py: DTYPE_CODES).
enum DType : int { kF32 = 0, kBF16 = 1 };

}  // namespace rtt
