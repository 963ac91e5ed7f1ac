// Shared helpers for the port's kernels: f32 <-> storage-type conversion,
// vector loads and stores of N consecutive values, and the error-string
// export every library carries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace spt {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int Bytes> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// N * sizeof(T) bytes move in chunks of min(that, 16) bytes; the pointer must
// be aligned to the chunk. Callers choose N so the size is a power of two or
// a multiple of 16.
template <typename T, int N>
struct Chunks {
  static constexpr int kBytes = N * (int)sizeof(T);
  static constexpr int kChunk = kBytes >= 16 ? 16 : kBytes;
  static constexpr int kPer = kChunk / (int)sizeof(T);
  static constexpr int kCount = kBytes / kChunk;
  static_assert(kBytes % kChunk == 0, "size must be a power of two or a multiple of 16 bytes");
  using V = typename Raw<kChunk>::type;
};

// Load N values of T and widen them to f32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&x)[N]) {
  using K = Chunks<T, N>;
#pragma unroll
  for (int k = 0; k < K::kCount; ++k) {
    const typename K::V raw = reinterpret_cast<const typename K::V*>(p)[k];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < K::kPer; ++j) x[k * K::kPer + j] = to_f32(e[j]);
  }
}

// Round N f32 values to T (round to nearest even) and store them.
template <typename T, int N>
__device__ __forceinline__ void store_from_f32(T* p, const float (&x)[N]) {
  using K = Chunks<T, N>;
#pragma unroll
  for (int k = 0; k < K::kCount; ++k) {
    typename K::V raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < K::kPer; ++j) e[j] = from_f32<T>(x[k * K::kPer + j]);
    reinterpret_cast<typename K::V*>(p)[k] = raw;
  }
}

__host__ __device__ __forceinline__ bool aligned(const void* p, size_t bytes) {
  return (reinterpret_cast<size_t>(p) & (bytes - 1)) == 0;
}

// Let the kernel Func take up to `bytes` of dynamic shared memory on the
// current device. By default a block's static and dynamic shared memory
// together may not pass 48 KB; the opened limit is a setting of the device,
// so it is made once per kernel and device (callers launch only on tensors
// of the current device).
template <auto Func>
inline cudaError_t open_smem(int bytes) {
  constexpr int kDevices = 64;  // devices whose opened limit is remembered
  static bool opened[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kDevices && opened[dev])) return err;
  err = cudaFuncSetAttribute(Func, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kDevices) opened[dev] = true;
  return err;
}

}  // namespace spt

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
