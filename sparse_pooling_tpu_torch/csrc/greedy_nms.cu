// Greedy non-maximum suppression of a batch of frames: one thread block a
// frame runs every greedy round of its frame, so a call is one launch.
//
// Replaces no `pl.pallas_call`. The JAX package's greedy NMS
// (sparse_pooling_tpu/ops/nms.py `_nms_batch`) is a `lax.fori_loop` that XLA
// compiles into one device loop; in eager PyTorch the same loop is a host
// loop of about 32 small ops a round (ops/nms.py `nms_batch_plain`), and the
// card idles while the host dispatches them: 300 rounds for the RPN and 100
// a class for the final NMS of every request.
//
// Contract: the plain twin's indices and validity, bit for bit.
// * A round picks the first maximum of the live scores as `torch.argmax`
//   does: a NaN counts as larger than any number, ties go to the lower index.
// * A pick is valid where its score is > -inf (a NaN pick is not). Once a
//   pick is invalid nothing is suppressed any more, so every later round
//   repeats it: the rest of the outputs are (that index, false); for a frame
//   whose scores are all -inf that index is 0.
// * After a valid pick, a candidate is suppressed (its score set to -inf)
//   where iou > threshold, and the pick itself always is. Every float
//   operation rounds where the twin's separate f32 ops round:
//     area  = clamp_min(y2 - y1, 0) * clamp_min(x2 - x1, 0)
//     inter = clamp_min(min(py2, y2) - max(py1, y1), 0)
//           * clamp_min(min(px2, x2) - max(px1, x1), 0)
//     union = (area_pick + area) - inter
//     iou   = union > 0 ? inter / max(union, (float)1e-12) : 0
//   with min, max and clamp_min passing a NaN on as PyTorch's do, an IEEE
//   division, and no fused multiply-add (`--fmad=false`). The threshold is
//   the f32 value of the twin's Python float, as PyTorch compares a float32
//   tensor with a scalar. Where inter is 0 the IoU is 0 exactly, so the
//   division is skipped.
//
// What bounds it. A round needs the previous round's suppressions, so the
// K rounds are a chain; each is a block-wide argmax over N keys and one IoU
// pass over the live candidates. The bytes (20 a candidate, read once) take
// about 0.1 us at the main path's shapes; the time is the chain of K rounds,
// each the latency of two block reductions and N / (4 x 32) IoU steps on
// each of the SM's four schedulers: about 2 us a round at N = 4096 on an
// H100. A frame is one block, so B frames fill B SMs.
//
// What the design does about it.
// * A score is kept as a 32-bit key whose unsigned order is argmax's
//   order: a float's bits made monotone (negative values inverted), +0 for
//   both zeros, every NaN as 0xffffffff. A warp then reduces with two
//   `redux.sync` instructions (the largest key, then the lowest index that
//   holds it) instead of ten shuffles; a lane with no candidate holds key 0,
//   below -inf's.
// * One barrier a round: each warp writes its best (key, index) to one of
//   two slot arrays, by round parity, and after the barrier every warp
//   reduces the slots itself, so no second barrier hands the pick back. A
//   thread reads and writes only its own candidates' keys (index tid +
//   k x blockDim), so no other barrier is needed between rounds.
// * Keys live in shared memory (4 bytes a candidate, up to kMaxCandidates).
//   A live candidate's box is one 16-byte read-only load a round, from L1
//   while the frame's boxes fit there (64 KB at N = 4096). Staging the boxes
//   in shared memory too was 7% faster at the rcnn RPN's shape (0.581
//   against 0.628 ms on an H100, 0.2% of a request) but needs a second path
//   where they do not fit (N above 11596).
// * A dead candidate (key of -inf) costs one shared load a round; the IoU
//   division runs only where the intersection is not 0.
// * Up to 1024 threads a block, N rounded up to whole warps below that.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlotBytes = 2 * 2 * 32 * 4;             // the static slot arrays
constexpr int kMaxSmem = 227 * 1024 - kSlotBytes;      // dynamic shared memory a block may take
constexpr int kMaxCandidates = 56 * 1024;              // keys alone: 224 KB
constexpr unsigned kNoCandidate = 0u;                  // below every score's key
constexpr unsigned kNegInfKey = 0x007fffffu;           // key(-inf)
constexpr unsigned kNanKey = 0xffffffffu;              // key(NaN): above +inf's 0xff800000

// Monotone key of a score: unsigned order = argmax's order of the floats.
__device__ __forceinline__ unsigned score_key(float s) {
  if (s != s) return kNanKey;
  if (s == 0.0f) s = 0.0f;  // -0 ties +0, as the floats compare
  const unsigned u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// min, max and clamp_min as PyTorch's: a NaN operand gives NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clamp0(float a) { return a != a ? a : fmaxf(a, 0.0f); }

__device__ __forceinline__ float box_area(float4 b) {
  return clamp0(b.z - b.x) * clamp0(b.w - b.y);
}

// Whether candidate c is suppressed by the pick p (boxes [y1, x1, y2, x2]).
__device__ __forceinline__ bool suppressed(float4 p, float p_area, float4 c, float thr) {
  const float inter = clamp0(nan_min(p.z, c.z) - nan_max(p.x, c.x)) *
                      clamp0(nan_min(p.w, c.w) - nan_max(p.y, c.y));
  float iou = 0.0f;
  if (inter != 0.0f) {
    const float uni = (p_area + box_area(c)) - inter;
    if (uni > 0.0f) iou = inter / fmaxf(uni, (float)1e-12);
  }
  return iou > thr;
}

__global__ void __launch_bounds__(kMaxThreads)
greedy_nms(const float4* __restrict__ boxes, const float* __restrict__ scores, int N, int K, float thr,
           long long* __restrict__ out_idx, bool* __restrict__ out_valid) {
  extern __shared__ unsigned key[];  // [N]
  __shared__ unsigned slot_key[2][32];
  __shared__ unsigned slot_idx[2][32];
  const int tid = threadIdx.x, step = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = step >> 5;
  const float4* fbox = boxes + (size_t)blockIdx.x * N;
  const float* fscore = scores + (size_t)blockIdx.x * N;
  long long* oidx = out_idx + (size_t)blockIdx.x * K;
  bool* ovalid = out_valid + (size_t)blockIdx.x * K;

  for (int i = tid; i < N; i += step) key[i] = score_key(fscore[i]);
  __syncthreads();

  for (int r = 0; r < K; ++r) {
    // this thread's best: the first of its largest keys
    unsigned bk = kNoCandidate, bi = UINT_MAX;
    for (int i = tid; i < N; i += step) {
      const unsigned k = key[i];
      if (k > bk) bk = k, bi = (unsigned)i;
    }
    // the warp's, then the block's through the slots of this round's parity
    unsigned wk = __reduce_max_sync(kFull, bk);
    unsigned wi = __reduce_min_sync(kFull, bk == wk ? bi : UINT_MAX);
    const int par = r & 1;
    if (lane == 0) slot_key[par][warp] = wk, slot_idx[par][warp] = wi;
    __syncthreads();
    bk = lane < warps ? slot_key[par][lane] : kNoCandidate;
    bi = lane < warps ? slot_idx[par][lane] : UINT_MAX;
    wk = __reduce_max_sync(kFull, bk);
    const int pick = (int)__reduce_min_sync(kFull, bk == wk ? bi : UINT_MAX);
    if (!(wk > kNegInfKey && wk != kNanKey)) {
      // -inf or NaN: nothing is suppressed, so every later round repeats it
      for (int j = r + tid; j < K; j += step) oidx[j] = pick, ovalid[j] = false;
      return;
    }
    if (tid == 0) oidx[r] = pick, ovalid[r] = true;
    const float4 p = __ldg(fbox + pick);
    const float p_area = box_area(p);
    for (int i = tid; i < N; i += step) {
      if (key[i] == kNegInfKey) continue;
      if (i == pick || suppressed(p, p_area, __ldg(fbox + i), thr)) key[i] = kNegInfKey;
    }
  }
}

int launch(const float4* boxes, const float* scores, int B, int N, int K, float thr, long long* out_idx,
           bool* out_valid, cudaStream_t stream) {
  // opened whatever N: with the static slots, N above 12160 passes 48 KB
  const cudaError_t err = spt::open_smem<greedy_nms>(kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)N * sizeof(unsigned);
  const int rounded = (N + 31) / 32 * 32;
  const int threads = rounded < kMaxThreads ? rounded : kMaxThreads;
  greedy_nms<<<(unsigned)B, threads, smem, stream>>>(boxes, scores, N, K, thr, out_idx, out_valid);
  return (int)cudaGetLastError();
}

}  // namespace

// The most candidates a frame the kernel takes.
extern "C" int greedy_nms_max_candidates() { return kMaxCandidates; }

// boxes: [B, N, 4] f32 [y1, x1, y2, x2], 16-byte aligned; scores: [B, N] f32
// (-inf masks a candidate); out_idx: [B, K] int64; out_valid: [B, K] bool.
// B >= 1, K >= 1 and 1 <= N <= kMaxCandidates, else nothing launches.
extern "C" int greedy_nms_launch(const void* boxes, const float* scores, int B, int N, int K, float thr,
                                 long long* out_idx, bool* out_valid, void* stream) {
  if (B < 1 || K < 1 || N < 1 || N > kMaxCandidates || !spt::aligned(boxes, 16))
    return (int)cudaErrorInvalidValue;
  return launch(static_cast<const float4*>(boxes), scores, B, N, K, thr, out_idx, out_valid,
                static_cast<cudaStream_t>(stream));
}
