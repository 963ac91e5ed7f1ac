// Kernel A: SHPL patch pooling (the fusion layer's cross-view pool).
//
// Replaces the forward of sparse_pooling_tpu/ops/sparse_pool.py
// `_patch_pool_denom_with_vjp.impl` (:176-187, with `_gather_point_patches`
// :124-150) and `_patch_pool_with_vjp.impl` (:234-243). On the TPU these are
// XLA gathers and segment sums, not a Pallas kernel. Per point p of frame b:
//
//   g[c]  = sum_k vals[b,p,k] * src[b, window(cols[b,p,0])_k, c]   (f32)
//   acc[b*T + rows[b,p], c] += g[c]           c < C
//   acc[b*T + rows[b,p], C] += sum_k vals[b,p,k]   (with the denominator)
//
// then out = acc[:, :C] / den where den > 1e-12, else 0.
//
// The window is the 2x2 block at (cols[...,0] / Ws, cols[...,0] % Ws) with
// the start clamped so the block fits (XLA gather CLIP mode); a source dim of
// 1 duplicates its single row/column. Rows index the batch-flattened
// accumulator (b*T + row); ids outside [0, B*T) are dropped, as the
// reference's segment_sum over the flattened batch drops them.
//
// Bound: bytes. Each point reads its 4 taps' 4*C source values, 4 weights,
// 4 indices and its row, and does ~8*C flops; the f32 accumulator scatter is
// the largest stream. Design: one warp per point, lanes over channels, so
// each tap is one coalesced C-wide row read and the scatter is C coalesced
// f32 atomics. The sum order of the atomics varies run to run (tolerance:
// f32 rounding of a sum of <= tens of entries per target cell).
#include "common.cuh"

namespace {

template <typename T>
__global__ void patch_pool_scatter(const T* __restrict__ src, int B, int Hs, int Ws,
                                   int C, const int* __restrict__ rows,
                                   const int* __restrict__ cols,
                                   const float* __restrict__ vals, int P, int Tn,
                                   int acc_c, float* __restrict__ acc) {
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * P) return;
  const int b = (int)(warp / P);
  const long long row = (long long)b * Tn + rows[warp];
  if (row < 0 || row >= (long long)B * Tn) return;

  const int c00 = cols[warp * 4];
  const int sh = Hs > 1 ? 2 : 1;
  const int sw = Ws > 1 ? 2 : 1;
  const int v0 = min(max(c00 / Ws, 0), Hs - sh);
  const int u0 = min(max(c00 % Ws, 0), Ws - sw);
  const int v1 = v0 + sh - 1;
  const int u1 = u0 + sw - 1;
  const float w0 = vals[warp * 4 + 0];
  const float w1 = vals[warp * 4 + 1];
  const float w2 = vals[warp * 4 + 2];
  const float w3 = vals[warp * 4 + 3];

  const T* base = src + (long long)b * Hs * Ws * C;
  const T* p00 = base + ((long long)v0 * Ws + u0) * C;
  const T* p01 = base + ((long long)v0 * Ws + u1) * C;
  const T* p10 = base + ((long long)v1 * Ws + u0) * C;
  const T* p11 = base + ((long long)v1 * Ws + u1) * C;
  float* dst = acc + row * acc_c;
  for (int c = lane; c < C; c += 32) {
    float g = spt::to_f32(p00[c]) * w0;
    g = g + spt::to_f32(p01[c]) * w1;
    g = g + spt::to_f32(p10[c]) * w2;
    g = g + spt::to_f32(p11[c]) * w3;
    atomicAdd(dst + c, g);
  }
  if (acc_c > C && lane == 0) atomicAdd(dst + C, ((w0 + w1) + w2) + w3);
}

__global__ void patch_pool_divide(const float* __restrict__ acc, long long n_rows, int C,
                                  float* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_rows * C) return;
  const long long r = i / C;
  const int c = (int)(i % C);
  const float den = acc[r * (C + 1) + C];
  out[i] = den > 1e-12f ? acc[r * (C + 1) + c] / fmaxf(den, 1e-12f) : 0.0f;
}

template <typename T>
int launch(const void* src, int B, int Hs, int Ws, int C, const int* rows,
           const int* cols, const float* vals, int P, int Tn, int with_den,
           float* acc, float* out, cudaStream_t stream) {
  const long long n_rows = (long long)B * Tn;
  const int acc_c = with_den ? C + 1 : C;
  float* target = with_den ? acc : out;
  cudaError_t err = cudaMemsetAsync(target, 0, sizeof(float) * n_rows * acc_c, stream);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long n_warps = (long long)B * P;
  if (n_warps > 0) {
    const long long blocks = (n_warps * 32 + threads - 1) / threads;
    patch_pool_scatter<T><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(src), B, Hs, Ws, C, rows, cols, vals, P, Tn, acc_c, target);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (with_den && n_rows * C > 0) {
    const long long blocks = (n_rows * C + threads - 1) / threads;
    patch_pool_divide<<<(unsigned)blocks, threads, 0, stream>>>(acc, n_rows, C, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 source, 1 = bfloat16 source. acc: [B*T, C+1] f32
// scratch (with_den only); out: [B*T, C] f32.
extern "C" int sparse_pool_patch_launch(const void* src, int dtype, int B, int Hs, int Ws,
                                        int C, const int* rows, const int* cols,
                                        const float* vals, int P, int Tn, int with_den,
                                        float* acc, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(src, B, Hs, Ws, C, rows, cols, vals, P, Tn, with_den, acc, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(src, B, Hs, Ws, C, rows, cols, vals, P, Tn, with_den, acc,
                                 out, s);
  return (int)cudaErrorInvalidValue;
}
