// Kernel B: ELL sparse pool over a batch of frames,
//   out[b, t, c] = sum_k w[b, t, k] * src[b, idx[b, t, k], c],
// with src [B, S, C], idx and w [B, T, K], out [B, T, C]; one frame is B = 1.
//
// Replaces the Pallas kernel sparse_pooling_tpu/ops/pallas_sparse_pool.py
// `sparse_pool_ell_pallas` (:70, body `_ell_kernel` :57, pallas_call :88)
// and the probe tools/probe_pallas_shpl.py `make_ell_ds_kernel` (:66), which
// compute the same function for one frame; the batch is the JAX package's
// `sparse_pool_ell_batch` (ops/sparse_pool.py:374, a vmap of the same pool).
// The TPU kernel pins src [S, C] in VMEM and gathers K rows per target tile.
//
// What bounds it here. It is a gather with a short weighted sum: no matrix
// product and no tile reuse. The source (at most a few MB a frame) sits in the
// 50 MB L2, so the card's time goes to (1) the bytes of the tables and the
// output, (2) the latency of each row's K source gathers, (3) the L2 reads of
// the taps, up to T*K*C*sizeof(src) if every slot were live.
//
// What the design does about it.
// * A group of G lanes owns one target row; each lane holds 16 bytes of
//   channels (8 bf16 or 4 f32) and makes one 16-byte store, so a warp covers
//   32 / G rows and its stores are whole lines. G is C / 8 (bf16) or C / 4
//   (f32) rounded up to a power of two, at most 32; wider rows loop.
// * A row's slots are loaded once: for K = 8 (the config's `ell_k`) as two
//   16-byte index loads and two weight loads shared by the group; other K in
//   chunks of 8 scalar loads.
// * All gathers of a chunk are issued before the sum, read-only (`__ldg`),
//   so up to 8 loads per lane are in flight at once instead of a chain of
//   dependent loads. No branch sits between them: an index outside [0, S) is
//   clamped to 0 and its weight set to 0, and a slot whose weight is 0 (the
//   ELL padding: index 0, weight 0) is not loaded at all (a predicated load)
//   and costs no arithmetic; a row (or chunk of 8 slots) of padding is skipped
//   whole. 84% of the slots of the main path's BEV tables are padding, so
//   this is most of the saving. Dropping a zero-weight slot is exact for
//   finite sources: it would add 0 * x = +-0 to the sum. Only an inf or NaN
//   source value differs.
// * f32 products summed in k order, one rounding to the output dtype.
// * Frames are found by row: frame = row / T, source base frame * S * C, so
//   indices stay local to their frame and the host adds no offsets.
// * A scalar path (one channel a lane) takes a C that is not a multiple of
//   the vector width or a source or output not 16-byte aligned; the K = 8
//   path also needs 16-byte aligned tables.
//
// Out-of-range indices. The kernel drops an index outside [0, S) (it adds
// nothing). The plain twin (ops/sparse_pool.py) wraps a negative index and
// raises on one >= S; JAX's `jnp.take` wraps -1 and returns NaN for >= S. The
// host builder only emits indices in [0, S).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;  // slots whose source loads are in flight together

// Slots [k0, k0 + kChunk) of one row as (index, weight). A slot past K or
// with an index outside [0, S) comes back as index 0, weight 0.
template <int KT>
__device__ __forceinline__ void load_slots(const int* __restrict__ ri, const float* __restrict__ rw,
                                           int K, int k0, int S, int (&j)[kChunk],
                                           float (&wk)[kChunk]) {
  if constexpr (KT == kChunk) {
    const int4 i0 = __ldg(reinterpret_cast<const int4*>(ri));
    const int4 i1 = __ldg(reinterpret_cast<const int4*>(ri) + 1);
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(rw));
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(rw) + 1);
    j[0] = i0.x; j[1] = i0.y; j[2] = i0.z; j[3] = i0.w;
    j[4] = i1.x; j[5] = i1.y; j[6] = i1.z; j[7] = i1.w;
    wk[0] = w0.x; wk[1] = w0.y; wk[2] = w0.z; wk[3] = w0.w;
    wk[4] = w1.x; wk[5] = w1.y; wk[6] = w1.z; wk[7] = w1.w;
  } else {
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const bool in = k0 + s < K;
      j[s] = in ? __ldg(ri + k0 + s) : 0;
      wk[s] = in ? __ldg(rw + k0 + s) : 0.0f;
    }
  }
#pragma unroll
  for (int s = 0; s < kChunk; ++s) {
    const bool ok = (unsigned)j[s] < (unsigned)S;
    j[s] = ok ? j[s] : 0;
    wk[s] = ok ? wk[s] : 0.0f;
  }
}

// Adds the live slots of one chunk to acc: all source loads first (a
// predicated load per slot), then the sums in k order.
template <typename T, int V>
__device__ __forceinline__ void gather_add(const T* __restrict__ frame, int C, int c0,
                                           const int (&j)[kChunk], const float (&wk)[kChunk],
                                           float (&acc)[V]) {
  using Raw = typename spt::Raw<V * (int)sizeof(T)>::type;
  Raw raw[kChunk];
#pragma unroll
  for (int s = 0; s < kChunk; ++s)
    raw[s] = wk[s] != 0.0f ? __ldg(reinterpret_cast<const Raw*>(frame + (long long)j[s] * C + c0))
                           : Raw{};
#pragma unroll
  for (int s = 0; s < kChunk; ++s) {
    if (wk[s] == 0.0f) continue;  // adds +-0: skipping it saves 3 * V instructions
    const T* e = reinterpret_cast<const T*>(&raw[s]);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = acc[v] + spt::to_f32(e[v]) * wk[s];
  }
}

__device__ __forceinline__ bool any_live(const float (&wk)[kChunk]) {
  bool live = false;
#pragma unroll
  for (int s = 0; s < kChunk; ++s) live |= wk[s] != 0.0f;
  return live;
}

// T: storage type; V: channels a lane loads and stores at once (16 bytes, or
// 1 on the scalar path); KT: 8 for the K = 8 path (a row's slots loaded once),
// 0 for any K (chunks of 8 slots per channel chunk); kFit: C = G * V, so each
// lane owns exactly one chunk of channels and its code is straight-line, with
// no channel loop and no bounds test (the main path's C = 64 bf16 and the
// probe's C = 32 f32 take it).
template <typename T, int V, int KT, bool kFit>
__global__ void __launch_bounds__(kThreads)
ell_pool(const T* __restrict__ src, int S, int C, const int* __restrict__ idx,
         const float* __restrict__ w, long long rows, int Tn, int K, int group_log2,
         T* __restrict__ out) {
  const int G = 1 << group_log2;
  const long long r = (blockIdx.x * (long long)kThreads + threadIdx.x) >> group_log2;
  if (r >= rows) return;
  const int lane = threadIdx.x & (G - 1);
  const T* frame = src + (long long)((int)r / Tn) * S * C;  // rows < 2^31 (the wrapper checks)
  const int* ri = idx + r * (KT ? KT : K);
  const float* rw = w + r * (KT ? KT : K);
  T* orow = out + r * C;
  int j[kChunk];
  float wk[kChunk];
  bool live = false;
  if constexpr (KT == kChunk) {
    load_slots<KT>(ri, rw, K, 0, S, j, wk);
    live = any_live(wk);  // a row of padding: no loads, no arithmetic
  }
  auto pool = [&](int c0) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    if constexpr (KT == kChunk) {
      if (live) gather_add<T, V>(frame, C, c0, j, wk, acc);
    } else {
      for (int k0 = 0; k0 < K; k0 += kChunk) {
        load_slots<KT>(ri, rw, K, k0, S, j, wk);
        if (any_live(wk)) gather_add<T, V>(frame, C, c0, j, wk, acc);
      }
    }
    spt::store_from_f32<T, V>(orow + c0, acc);
  };
  if constexpr (kFit) {
    pool(lane * V);
  } else {
    for (int c0 = lane * V; c0 < C; c0 += G * V) pool(c0);
  }
}

int ceil_log2(int n) {
  int g = 0;
  while ((1 << g) < n) ++g;
  return g;
}

template <typename T, int V, int KT>
int launch_path(const T* src, int S, int C, const int* idx, const float* w, long long rows,
                int Tn, int K, T* out, cudaStream_t stream) {
  const int log2 = ceil_log2((C + V - 1) / V);
  const int group_log2 = log2 < 5 ? log2 : 5;
  const long long blocks = ((rows << group_log2) + kThreads - 1) / kThreads;
  if (C == (V << group_log2))
    ell_pool<T, V, KT, true><<<(unsigned)blocks, kThreads, 0, stream>>>(src, S, C, idx, w, rows,
                                                                        Tn, K, group_log2, out);
  else
    ell_pool<T, V, KT, false><<<(unsigned)blocks, kThreads, 0, stream>>>(src, S, C, idx, w, rows,
                                                                         Tn, K, group_log2, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* src_v, int B, int S, int C, const int* idx, const float* w, int Tn, int K,
           void* out_v, cudaStream_t stream) {
  const long long rows = (long long)B * Tn;
  if (rows == 0 || C == 0) return 0;
  const T* src = static_cast<const T*>(src_v);
  T* out = static_cast<T*>(out_v);
  constexpr int kVec = 16 / (int)sizeof(T);
  const bool vec = C % kVec == 0 && spt::aligned(src, 16) && spt::aligned(out, 16);
  const bool k8 = K == kChunk && spt::aligned(idx, 16) && spt::aligned(w, 16);
  if (vec && k8) return launch_path<T, kVec, kChunk>(src, S, C, idx, w, rows, Tn, K, out, stream);
  if (vec) return launch_path<T, kVec, 0>(src, S, C, idx, w, rows, Tn, K, out, stream);
  if (k8) return launch_path<T, 1, kChunk>(src, S, C, idx, w, rows, Tn, K, out, stream);
  return launch_path<T, 1, 0>(src, S, C, idx, w, rows, Tn, K, out, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (src and out share it).
extern "C" int ell_sparse_pool_launch(const void* src, int dtype, int B, int S, int C,
                                      const int* idx, const float* w, int Tn, int K, void* out,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(src, B, S, C, idx, w, Tn, K, out, s);
  if (dtype == 1) return launch<__nv_bfloat16>(src, B, S, C, idx, w, Tn, K, out, s);
  return (int)cudaErrorInvalidValue;
}
