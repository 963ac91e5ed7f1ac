// Kernel B: fused ELL sparse pool, out[t, c] = sum_k w[t, k] * src[idx[t, k], c].
//
// Replaces sparse_pooling_tpu/ops/pallas_sparse_pool.py `sparse_pool_ell_pallas`
// (:70, body `_ell_kernel` :57, pallas_call :88), and computes the same
// function as the probe tools/probe_pallas_shpl.py `make_ell_ds_kernel` (:66).
// The TPU kernel pins src [S, C] in VMEM and gathers K rows per target tile;
// here one thread owns one (t, c) output, so a warp reads C-contiguous source
// rows (coalesced) and the K indices/weights of a row are broadcast loads.
// Accumulates in f32 and writes the source dtype. No padding: the ragged
// edge of the T*C range is masked. Indices outside [0, S) contribute nothing.
//
// Bound: bytes. Reads T*K*(4+4) bytes of table, up to S*C source values
// (L2-resident at these sizes), writes T*C values; 2*T*K*C flops.
#include "common.cuh"

namespace {

template <typename T>
__global__ void ell_pool(const T* __restrict__ src, int S, int C, const int* __restrict__ idx,
                         const float* __restrict__ w, int Tn, int K, T* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)Tn * C) return;
  const long long t = i / C;
  const int c = (int)(i % C);
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int j = idx[t * K + k];
    if (j >= 0 && j < S) acc = acc + spt::to_f32(src[(long long)j * C + c]) * w[t * K + k];
  }
  out[i] = spt::from_f32<T>(acc);
}

template <typename T>
int launch(const void* src, int S, int C, const int* idx, const float* w, int Tn, int K,
           void* out, cudaStream_t stream) {
  const long long n = (long long)Tn * C;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  ell_pool<T><<<(unsigned)blocks, threads, 0, stream>>>(static_cast<const T*>(src), S, C, idx,
                                                         w, Tn, K, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (src and out share it).
extern "C" int ell_sparse_pool_launch(const void* src, int dtype, int S, int C, const int* idx,
                                      const float* w, int Tn, int K, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(src, S, C, idx, w, Tn, K, out, s);
  if (dtype == 1) return launch<__nv_bfloat16>(src, S, C, idx, w, Tn, K, out, s);
  return (int)cudaErrorInvalidValue;
}
