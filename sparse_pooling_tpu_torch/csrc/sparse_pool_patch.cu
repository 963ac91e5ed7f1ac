// Kernel A: SHPL patch pooling (the fusion layer's cross-view pool).
//
// Replaces the forward of sparse_pooling_tpu/ops/sparse_pool.py
// `_patch_pool_denom_with_vjp.impl` (:176-187, with `_gather_point_patches`
// :124-150) and `_patch_pool_with_vjp.impl` (:234-243). On the TPU these are
// XLA gathers and segment sums, not a Pallas kernel. Per point p of frame b:
//
//   g[c]  = sum_k vals[b,p,k] * src[b, window(cols[b,p,0])_k, c]   (f32)
//   acc[b*T + rows[b,p], c] += g[c]           c < C
//   den[b*T + rows[b,p]]    += sum_k vals[b,p,k]   (with the denominator)
//
// then out = acc / den where den > 1e-12, else 0 (without the denominator,
// out = acc).
//
// The window is the 2x2 block at (cols[...,0] floor-div Ws, cols[...,0]
// floor-mod Ws) with the start clamped so the block fits (XLA gather CLIP
// mode); a source dim of 1 duplicates its single row/column. Floor, as the
// reference's `//` and `%`, also for a negative index (C's `/` and `%`
// truncate and would take another window there). Rows index the
// batch-flattened output (b*T + row); ids outside [0, B*T) are dropped, as
// the reference's segment_sum over the flattened batch drops them. A point
// whose four weights are all 0 (padding, or outside the extents or canvas)
// adds exactly +0.0 to its row for finite sources and is skipped.
//
// Bound on an H100: bytes. At the main path's shapes (B = 8, 16384 points a
// frame, C = 64, bf16 source) a call must write the 18 MB f32 output and
// read 4-8 MB of source rows and 4.5 MB of point tables: 7-8 us at 3.35 TB/s.
// Beyond that, each of the ~90K live points reads its 4 taps' rows, ~46 MB
// served from L2, which keeps the gather above ~9 us. The first version
// scattered point-major: 64 f32 atomicAdds per point into an 18.3 MB
// [B*T, C+1] accumulator that had to be zeroed first and read again by a
// dividing pass, some 55 MB of traffic beside 8.4M atomics.
//
// Design: a target-major (CSR) gather with no accumulator in device memory
// and no atomics on features there. Besides the L2 traffic, what holds it
// back is the longest chain of dependent loads: the points are very unevenly
// spread (at the main path's inputs one BEV target row has 493 and four in
// five rows have none), so the gather splits the work by points, never by
// rows.
// (1) count: one thread per live point adds one to its row's int32 count
//     ([B*T], 282 KB to zero) and keeps the count it saw as its ticket.
// (2) scan: one block per 8192 counts writes their exclusive prefix; the last
//     block to finish scans the blocks' totals (one block scanning all the
//     counts is held to one SM's bandwidth: 14-16 us on an H100) and starts
//     each frame's slots at the next multiple of 128, the gather's block.
// (3) place: each live point writes its index to dense slot offs[row] +
//     ticket: the rows back to back, each row's points contiguous but in the
//     order the atomics of (1) gave them. A warp per 32 target rows writes the
//     empty rows' zeros.
// (4) order: a thread per dense slot ranks its point among its row's points
//     by point index (the count of the row's smaller indices; the lanes of a
//     row longer than 32 compare against it together, 32 indices a step
//     shared by shuffles, as rows run to 493 points at the main path's
//     inputs) and writes its row, its window's first pixel and its four
//     weights to the final slot: offs[row] + the frame's padding + rank. Each
//     row's points now lie in point order, whatever order (1) gave them.
// (5) gather: one block per 128 consecutive slots, a thread per slot. A block
//     scan numbers the runs of equal rows. Sub-groups of 8 lanes each walk 8
//     slots, a lane loading 8 channels of each tap (16 bytes of bf16; where C
//     is no multiple of 8 or a tensor is not 16-byte aligned, 32 lanes walk
//     32 slots, one channel a lane) and
//     summing 4 taps x weight in f32 registers with the weight sum beside
//     them, and store each run's sum in the block's run buffer in shared
//     memory, at the run's first slot. A run that spans sub-groups leaves one
//     partial sum per sub-group, each at the first of its slots in that
//     sub-group, and they are added in sub-group order. A row lying wholly in
//     the block is written out once, divided where the weight sum exceeds
//     1e-12. The block's first and last rows, which may go on in the blocks
//     beside it, go to a carry buffer instead; the last block of such a row to
//     finish (a ticket per row, after a fence) adds its blocks' carries in
//     block order and writes it.
// So every f32 sum is taken in an order that the inputs fix: a launch gives
// the same bits as the last on the same inputs, and a frame's rows do not
// depend on the other frames of its batch. Against the twin's
// `index_add_` the order differs (tolerance: f32 rounding of a sum of <=
// hundreds of terms). The bf16 accumulation mode replaces (5) by a warp per
// row that walks the ordered slots (below), whose bf16 sums follow the
// points' order as the reference's do.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanPer = 8;  // counts per thread: two int4
constexpr int kScanTile = kScanThreads * kScanPer;
constexpr int kSlots = 128;  // slots per gather block, one per thread
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ long long round_up(long long n, long long m) {
  return (n + m - 1) / m * m;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// The scratch buffer, carved in this order; every part starts 16-byte aligned.
// Kernel A starts each frame's slots at a multiple of kSlots (`pad`, `fend`),
// so that the gather splits a frame's rows the same way whatever frames come
// before it in the batch; A-bwd's scan (frames 0) does not.
struct Scratch {
  int* hist;        // [n_pad] counts per row; zeroed with `done` and `arrive`
  int* done;        // [4] scan blocks finished, the live-point total, the slots' end
  int* arrive;      // [round4(n_blocks)] gather blocks done with a spanning row
  int* local;       // [n_pad] exclusive prefix within each 8192 rows
  int* tile_sum;    // [round4(n_tiles)] counts per 8192 rows
  int* tile_base;   // [round4(n_tiles)] their exclusive prefix
  int* pad;         // [round4(frames)] slots left empty before each frame's first
  int* fend;        // [round4(frames)] the slot past each frame's last
  float4* slot_w;   // [n_slots] weights, in slot order
  int* rank;        // [n_slots] a point's ticket within its row, -1 if skipped
  int* slot_key;    // [n_slots] the point at each slot, in ticket order (place)
  int* slot_pix;    // [n_slots] window's first pixel (flat over B*Hs*Ws)
  int* slot_row;    // [n_slots] target row (flat over B*T)
  float* carry;     // [n_blocks, 2, C + 1] a gather block's first and last rows
  int frames = 0;   // B, or 0: no frame starts aligned
  int frame_rows = 1;  // T

  struct Sizes {
    long long n_pad, n_tiles, n_slots, n_blocks, n_frames;
  };
  __host__ static Sizes sizes(long long B, long long Tn, long long P) {
    const long long n_pad = round_up(B * Tn, kScanTile);
    // each frame may leave up to kSlots - 1 slots empty at its end
    const long long n_blocks = (B * P + kSlots - 1) / kSlots + B;
    return {n_pad, round_up(n_pad / kScanTile, 4), n_blocks * kSlots + 4, n_blocks,
            round_up(B, 4)};
  }
  __host__ static long long ints(long long B, long long Tn, long long P, int C) {
    const Sizes z = sizes(B, Tn, P);
    return 2 * z.n_pad + 4 + round_up(z.n_blocks, 4) + 2 * z.n_tiles + 2 * z.n_frames +
           8 * z.n_slots + round_up(z.n_blocks * 2 * (C + 1), 4);
  }
  __host__ __device__ Scratch() {}
  __host__ Scratch(int* base, long long B, long long Tn, long long P) {
    const Sizes z = sizes(B, Tn, P);
    hist = base;
    done = hist + z.n_pad;
    arrive = done + 4;
    local = arrive + round_up(z.n_blocks, 4);
    tile_sum = local + z.n_pad;
    tile_base = tile_sum + z.n_tiles;
    pad = tile_base + z.n_tiles;
    fend = pad + z.n_frames;
    slot_w = reinterpret_cast<float4*>(fend + z.n_frames);
    rank = reinterpret_cast<int*>(slot_w + z.n_slots);
    slot_key = rank + z.n_slots;
    slot_pix = slot_key + z.n_slots;
    slot_row = slot_pix + z.n_slots;
    carry = reinterpret_cast<float*>(slot_row + z.n_slots);
    frames = (int)B;
    frame_rows = (int)Tn;
  }
};

// A row's first slot: dense (the rows back to back, where the place pass
// puts the points in ticket order) and final (each frame's rows starting at
// a multiple of kSlots, where the order pass moves them).
__device__ __forceinline__ long long dense_of(const Scratch& s, long long row) {
  return (long long)s.tile_base[row / kScanTile] + s.local[row];
}

__device__ __forceinline__ long long slot_of(const Scratch& s, long long row) {
  return dense_of(s, row) + (s.frames ? s.pad[row / s.frame_rows] : 0);
}

// The rank of `mine` among the n keys at keys[base, base + n): the count of
// smaller keys. Every lane of the warp calls it (dead lanes with live false).
// A lane of a run of at most 32 walks it alone; the lanes of a longer run
// walk it together, 32 keys a step, each key loaded once and shared by
// shuffles, so a run of hundreds costs its warps a few hundred shuffles.
__device__ __forceinline__ int rank_in_run(const int* __restrict__ keys, long long base, int n,
                                           int mine, bool live) {
  const int lane = threadIdx.x & 31;
  int r = 0;
  if (live && n <= 32)
    for (int k = 0; k < n; ++k) r += __ldg(keys + base + k) < mine;
  unsigned todo = __ballot_sync(kFull, live && n > 32);
  while (todo) {
    const int leader = __ffs(todo) - 1;
    const long long run = __shfl_sync(kFull, base, leader);
    const int len = __shfl_sync(kFull, n, leader);
    const bool in_run = live && n > 32 && base == run;
    int v = lane < len ? __ldg(keys + run + lane) : 0x7fffffff;
    for (int c = 0; c < len; c += 32) {
      // the next step's keys load while this step's are compared
      const int next = c + 32 + lane < len ? __ldg(keys + run + c + 32 + lane) : 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 32; ++j) r += (__shfl_sync(kFull, v, j) < mine) & in_run;
      v = next;
    }
    todo &= ~__ballot_sync(kFull, in_run);
  }
  return r;
}

__device__ __forceinline__ float finish(float acc, float den, int with_den) {
  return with_den ? (den > 1e-12f ? acc / fmaxf(den, 1e-12f) : 0.0f) : acc;
}

__global__ void patch_pool_count(const int* __restrict__ rows, const float* __restrict__ vals,
                                 int B, int P, int Tn, Scratch s) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)B * P) return;
  const long long id = (i / P) * Tn + rows[i];
  const float* w = vals + i * 4;
  const bool live = (w[0] != 0.0f) | (w[1] != 0.0f) | (w[2] != 0.0f) | (w[3] != 0.0f);
  s.rank[i] = (live && id >= 0 && id < (long long)B * Tn) ? atomicAdd(s.hist + id, 1) : -1;
}

// Inclusive scan of one int per thread over a block of kWarps warps; *total
// gets the sum. Every thread of the block calls it (it holds two barriers).
template <int kWarps>
__device__ __forceinline__ int block_inclusive_scan(int v, int* total) {
  __shared__ int warp_tot[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int t = warp_tot[k];
    before += k < warp ? t : 0;
    sum += t;
  }
  *total = sum;
  __syncthreads();  // warp_tot is free for the next call
  return before + incl;
}

// Block t scans counts [t * kScanTile, (t + 1) * kScanTile) into s.local;
// the last block to finish scans the blocks' totals into s.tile_base and
// writes the live-point total to s.done[1].
__global__ void __launch_bounds__(kScanThreads) patch_pool_scan(Scratch s, int n_tiles) {
  constexpr int kVec = kScanPer / 4;
  const long long at = ((long long)blockIdx.x * kScanThreads + threadIdx.x) * kVec;
  const int4* hist = reinterpret_cast<const int4*>(s.hist) + at;
  int4* local = reinterpret_cast<int4*>(s.local) + at;
  int4 cur[kVec];
  int tot = 0;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    cur[k] = hist[k];
    tot += cur[k].x + cur[k].y + cur[k].z + cur[k].w;
  }
  int block_total;
  int run = block_inclusive_scan<kScanThreads / 32>(tot, &block_total) - tot;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    int4 e;
    e.x = run;
    e.y = e.x + cur[k].x;
    e.z = e.y + cur[k].y;
    e.w = e.z + cur[k].z;
    run = e.w + cur[k].w;
    local[k] = e;
  }
  __shared__ int is_last;
  if (threadIdx.x == 0) {
    s.tile_sum[blockIdx.x] = block_total;
    __threadfence();
    is_last = atomicAdd(s.done, 1) == n_tiles - 1;
  }
  __syncthreads();
  if (!is_last) return;
  int carry = 0;
  for (int base = 0; base < n_tiles; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < n_tiles ? __ldcg(s.tile_sum + i) : 0;
    int total;
    const int e = block_inclusive_scan<kScanThreads / 32>(v, &total) - v;
    if (i < n_tiles) s.tile_base[i] = carry + e;
    carry += total;
  }
  if (threadIdx.x == 0) s.done[1] = carry;
  if (!s.frames) return;
  // each frame's first slot at the next multiple of kSlots: the rows before
  // frame b hold `excl` points, the frames before it `base` slots
  __syncthreads();  // this block's tile_base writes
  int base = 0;
  for (int b0 = 0; b0 < s.frames; b0 += kScanThreads) {
    const int b = b0 + threadIdx.x;
    int excl = 0, n = 0;
    if (b < s.frames) {
      const long long r0 = (long long)b * s.frame_rows;
      excl = __ldcg(s.tile_base + r0 / kScanTile) + __ldcg(s.local + r0);
      const long long r1 = r0 + s.frame_rows;
      n = (b + 1 < s.frames ? __ldcg(s.tile_base + r1 / kScanTile) + __ldcg(s.local + r1) : carry) -
          excl;
    }
    const int room = (int)round_up(n, kSlots);
    int total;
    const int start = base + block_inclusive_scan<kScanThreads / 32>(room, &total) - room;
    if (b < s.frames) {
      s.pad[b] = start - excl;
      s.fend[b] = start + n;
    }
    base += total;
  }
  if (threadIdx.x == 0) s.done[2] = base;
}

// Also writes the empty target rows' zeros: a warp per 32 rows.
__global__ void patch_pool_place(const int* __restrict__ rows, int B, int P, int Tn, int C,
                                 Scratch s, float* __restrict__ out, float* __restrict__ den_out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long n_rows = (long long)B * Tn;
  const long long row0 = (i >> 5) * 32;
  if (row0 < n_rows) {
    const long long mine = row0 + (threadIdx.x & 31);
    const unsigned empty = __ballot_sync(kFull, mine < n_rows && s.hist[mine] == 0);
    if (den_out != nullptr && (empty >> (threadIdx.x & 31) & 1)) den_out[mine] = 0.0f;
    float* dst = out + row0 * C;
    if (C % 4 == 0 && spt::aligned(out, 16)) {
      const int c4 = C / 4;
      for (int e = threadIdx.x & 31; e < 32 * c4; e += 32)
        if (empty >> (e / c4) & 1) reinterpret_cast<float4*>(dst)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int e = threadIdx.x & 31; e < 32 * C; e += 32)
        if (empty >> (e / C) & 1) dst[e] = 0.0f;
    }
  }
  if (i >= (long long)B * P) return;
  const int r = s.rank[i];
  if (r < 0) return;
  s.slot_key[dense_of(s, (i / P) * Tn + rows[i]) + r] = (int)i;
}

// A thread per dense slot: its point's rank among its row's points by point
// index gives the final slot it moves to.
__global__ void patch_pool_order(const int* __restrict__ rows, const int* __restrict__ cols,
                                 const float* __restrict__ vals, int P, int Hs, int Ws, int Tn,
                                 Scratch s) {
  const long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const bool live = q < s.done[1];
  int i = 0, b = 0, n = 0;
  long long id = 0, base = 0;
  if (live) {
    i = __ldg(s.slot_key + q);
    b = i / P;
    id = (long long)b * Tn + rows[i];
    base = dense_of(s, id);
    n = s.hist[id];
  }
  const int r = rank_in_run(s.slot_key, base, n, i, live);
  if (!live) return;
  const int c00 = cols[i * 4LL];
  const int v = floor_div(c00, Ws);
  const int v0 = min(max(v, 0), Hs - (Hs > 1 ? 2 : 1));
  const int u0 = min(max(c00 - v * Ws, 0), Ws - (Ws > 1 ? 2 : 1));
  const long long at = slot_of(s, id) + r;
  s.slot_row[at] = (int)id;
  s.slot_pix[at] = (b * Hs + v0) * Ws + u0;
  const float* w = vals + i * 4LL;
  s.slot_w[at] = make_float4(w[0], w[1], w[2], w[3]);
}

// One block per kSlots slots; sub-groups of S lanes walk S slots each, W
// channels a lane, S * W channels a pass. Six blocks fit an SM (<= 80
// registers, < 37 KB of shared memory), so the main path's ~700 live blocks
// run in one wave on an H100's 132 SMs.
template <typename T, int W, int S>
__global__ void __launch_bounds__(kSlots, 6)
patch_pool_gather(const T* __restrict__ src, int Hs, int Ws, int C, Scratch s, int with_den,
                  float* __restrict__ out, float* __restrict__ den_out) {
  constexpr int kPass = S * W;
  constexpr int kVec = W > 1 ? 4 : 1;  // channels a thread writes (C % 8 == 0 then)
  // a run's sum at its first slot, or a sub-group's part of a run that spans
  // sub-groups at the first of its slots there; + the weight sum
  __shared__ float runbuf[kSlots][kPass + 1];
  __shared__ int slot_run[kSlots];
  __shared__ int run_row[kSlots];
  __shared__ int run_lo[kSlots + 1];  // a run's first slot; run_lo[n_runs] = n_here
  __shared__ int pix_s[kSlots];
  __shared__ float4 w_s[kSlots];
  __shared__ int warp_last_row[kSlots / 32];
  __shared__ int edge_s[2];  // the rows of the slots just before and after the block
  __shared__ long long span_s[2][2];  // first and last gather block of the first, last row
  __shared__ int last_s[2];  // this block combines the first, last row

  const int t = threadIdx.x;
  const long long k0 = blockIdx.x * (long long)kSlots;
  // the slot arrays hold n_blocks * kSlots + 4 entries, so these loads stay
  // inside them; entries past the frame's last are masked below
  if (k0 >= s.done[2]) return;  // the grid covers every point, not only the live ones
  const int row = s.slot_row[k0 + t];
  const int pix = s.slot_pix[k0 + t];
  const float4 w = s.slot_w[k0 + t];
  // a frame's slots start at a multiple of kSlots, so the block's first slot
  // is live and the block holds one frame's
  const int frame = s.slot_row[k0] / s.frame_rows;
  const long long frame_first = slot_of(s, (long long)frame * s.frame_rows);
  const int frame_end = s.fend[frame];
  if (t < 2) edge_s[t] = t == 0 ? (k0 > frame_first ? s.slot_row[k0 - 1] : -1) : s.slot_row[k0 + kSlots];
  const int n_here = (int)min((long long)kSlots, frame_end - k0);
  pix_s[t] = pix;
  w_s[t] = w;
  if ((t & 31) == 31) warp_last_row[t >> 5] = row;
  __syncthreads();
  const int up = __shfl_up_sync(kFull, row, 1);
  const int prev = (t & 31) ? up : (t > 0 ? warp_last_row[(t >> 5) - 1] : -1);
  const int starts = t < n_here && (t == 0 || row != prev);
  int n_runs;
  const int run = block_inclusive_scan<kSlots / 32>(starts, &n_runs) - 1;
  slot_run[t] = run;
  if (starts) {
    run_row[run] = row;
    run_lo[run] = t;
  }
  if (t == 0) run_lo[n_runs] = n_here;
  __syncthreads();
  const int first_row = run_row[0];
  const int last_row = run_row[n_runs - 1];
  long long span[2] = {0, 0};  // thread 0 (1): gather blocks of the first (last) row
  if (t < 2) {
    const int r = t == 0 ? first_row : last_row;
    const long long first = slot_of(s, r);
    span[0] = first / kSlots;
    span[1] = (first + s.hist[r] - 1) / kSlots;
  }
  const bool open_before = k0 > frame_first && edge_s[0] == first_row;
  const bool open_after = k0 + n_here < frame_end && edge_s[1] == last_row;
  const int right = Ws > 1 ? 1 : 0;
  const int down = Hs > 1 ? Ws : 0;
  const int sub_lo = (t / S) * S;
  const int sub_hi = min(sub_lo + S, n_here);
  const int ls = t % S;
  float* carry = s.carry + blockIdx.x * 2LL * (C + 1);

  for (int c0 = 0; c0 < C; c0 += kPass) {
    const int c = c0 + ls * W;
    float acc[W] = {};
    float den = 0.0f;
    int cur = -1;
    auto flush = [&]() {
      if (cur < 0) return;
      float* dst = runbuf[max(run_lo[cur], sub_lo)];
      if (c < C) {
#pragma unroll
        for (int j = 0; j < W; ++j) dst[ls * W + j] = acc[j];
      }
      if (ls == 0) dst[kPass] = den;
    };
#pragma unroll 2
    for (int q = sub_lo; q < sub_hi; ++q) {
      if (slot_run[q] != cur) {
        flush();
        cur = slot_run[q];
#pragma unroll
        for (int j = 0; j < W; ++j) acc[j] = 0.0f;
        den = 0.0f;
      }
      const float4 x = w_s[q];
      den = den + (((x.x + x.y) + x.z) + x.w);
      if (c < C) {
        float t00[W], t01[W], t10[W], t11[W];
        const T* p = src + (long long)pix_s[q] * C + c;
        spt::load_f32<T, W>(p, t00);
        spt::load_f32<T, W>(p + (long long)right * C, t01);
        spt::load_f32<T, W>(p + (long long)down * C, t10);
        spt::load_f32<T, W>(p + (long long)(down + right) * C, t11);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          float g = t00[j] * x.x;
          g = g + t01[j] * x.y;
          g = g + t10[j] * x.z;
          g = g + t11[j] * x.w;
          acc[j] = acc[j] + g;
        }
      }
    }
    flush();
    __syncthreads();
    // a thread per kVec channels of a run
    for (int e = t; e < n_runs * (kPass / kVec); e += kSlots) {
      const int r = e / (kPass / kVec);
      const int ch = (e - r * (kPass / kVec)) * kVec;
      if (c0 + ch >= C) continue;
      // the run's parts, one a sub-group it reaches, in sub-group order
      const int lo = run_lo[r];
      float v[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = runbuf[lo][ch + j];
      float d = runbuf[lo][kPass];
      for (int q = (lo / S + 1) * S; q < run_lo[r + 1]; q += S) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) v[j] = v[j] + runbuf[q][ch + j];
        d = d + runbuf[q][kPass];
      }
      // a row open towards a neighbour goes to carry [0] (first) or [1] (last)
      const int side = r == 0 && open_before ? 0 : (r == n_runs - 1 && open_after ? 1 : -1);
      if (side < 0) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) v[j] = finish(v[j], d, with_den);
        spt::store_from_f32<float, kVec>(out + (long long)run_row[r] * C + c0 + ch, v);
        if (den_out != nullptr && c0 + ch == 0) den_out[run_row[r]] = d;
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) carry[side * (C + 1) + c0 + ch + j] = v[j];
        if (c0 + ch == 0) carry[side * (C + 1) + C] = d;
      }
    }
    __syncthreads();
  }

  // a row open towards a neighbour: the last of its blocks to get here adds
  // the carries (the fence makes this block's carries visible first)
  __threadfence();
  __syncthreads();
  if (t < 2) {
    const bool open = t == 0 ? open_before : open_after && !(n_runs == 1 && open_before);
    span_s[t][0] = span[0];
    span_s[t][1] = span[1];
    last_s[t] = open && atomicAdd(s.arrive + span[0], 1) == (int)(span[1] - span[0]);
  }
  __syncthreads();
  for (int side = 0; side < 2; ++side) {
    if (!last_s[side]) continue;
    const long long k1 = span_s[side][0];
    const long long k2 = span_s[side][1];
    const long long stride = C + 1;
    const float* cb = s.carry;
    for (int c = t; c < C; c += kSlots) {
      float v = __ldcg(cb + (2 * k1 + 1) * stride + c);
      float d = __ldcg(cb + (2 * k1 + 1) * stride + C);
      for (long long k = k1 + 1; k <= k2; ++k) {
        v = v + __ldcg(cb + 2 * k * stride + c);
        d = d + __ldcg(cb + 2 * k * stride + C);
      }
      out[(long long)(side == 0 ? first_row : last_row) * C + c] =
          finish(v, d, with_den);
      if (den_out != nullptr && c == 0) den_out[side == 0 ? first_row : last_row] = d;
    }
  }
}

// The bf16 accumulation mode (`sparse_pool.accum_dtype = "bfloat16"`), as
// the reference's `impl` computes it: each tap's product rounded to bf16,
// the four summed in f32 and rounded, the weight sum of each point in f32
// and rounded, and each row's sums taken in bf16, rounding after every add,
// in the order of the points (XLA's scatter-add adds a segment's entries in
// index order). A warp per target row walks its slots, which the order pass
// left in point order, a lane per channel. This mode is off the main path
// (its default is float32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
patch_pool_gather_bf16(const T* __restrict__ src, int Hs, int Ws, int C, Scratch s,
                       long long n_rows, int with_den, float* __restrict__ out,
                       float* __restrict__ den_out) {
  const long long row = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int n = s.hist[row];
  if (n == 0) return;  // the place pass wrote the empty row's zeros
  const long long base = slot_of(s, row);
  const auto bf = [](float x) { return __bfloat162float(__float2bfloat16_rn(x)); };
  float den = 0.0f;  // every lane takes the weight sum
  for (int k = 0; k < n; ++k) {
    const float4 x = s.slot_w[base + k];
    den = bf(den + bf(((x.x + x.y) + x.z) + x.w));
  }
  const int right = Ws > 1 ? 1 : 0;
  const int down = Hs > 1 ? Ws : 0;
  for (int c = lane; c < C; c += 32) {
    float acc = 0.0f;
    for (int k = 0; k < n; ++k) {
      const long long q = base + k;
      const float4 x = s.slot_w[q];
      const T* p = src + (long long)s.slot_pix[q] * C + c;
      float g = bf(bf(spt::to_f32(p[0])) * bf(x.x));
      g = g + bf(bf(spt::to_f32(p[(long long)right * C])) * bf(x.y));
      g = g + bf(bf(spt::to_f32(p[(long long)down * C])) * bf(x.z));
      g = g + bf(bf(spt::to_f32(p[(long long)(down + right) * C])) * bf(x.w));
      acc = bf(acc + bf(g));
    }
    out[row * C + c] = finish(acc, den, with_den);
  }
  if (lane == 0 && den_out != nullptr) den_out[row] = den;
}

template <typename T, int W, int S>
cudaError_t gather(const T* src, int Hs, int Ws, int C, const Scratch& s, long long n_blocks,
                   int with_den, float* out, float* den_out, cudaStream_t stream) {
  patch_pool_gather<T, W, S><<<(unsigned)n_blocks, kSlots, 0, stream>>>(
      src, Hs, Ws, C, s, with_den, out, den_out);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* src_v, int B, int Hs, int Ws, int C, const int* rows, const int* cols,
           const float* vals, int P, int Tn, int with_den, int accum_bf16, int* scratch,
           float* out, float* den_out, cudaStream_t stream) {
  const T* src = static_cast<const T*>(src_v);
  const long long n_rows = (long long)B * Tn;
  const long long n_pts = (long long)B * P;
  if (n_rows == 0 || C == 0) return 0;
  const Scratch::Sizes z = Scratch::sizes(B, Tn, P);
  const Scratch s(scratch, B, Tn, P);

  if (n_pts == 0) {
    if (den_out != nullptr) {
      const cudaError_t e = cudaMemsetAsync(den_out, 0, sizeof(float) * n_rows, stream);
      if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * n_rows * C, stream);
  }
  cudaError_t err = cudaMemsetAsync(
      s.hist, 0, sizeof(int) * (z.n_pad + 4 + round_up(z.n_blocks, 4)), stream);
  if (err != cudaSuccess) return (int)err;
  const long long pt_blocks = (n_pts + kThreads - 1) / kThreads;
  patch_pool_count<<<(unsigned)pt_blocks, kThreads, 0, stream>>>(rows, vals, B, P, Tn, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n_tiles = (int)(z.n_pad / kScanTile);
  patch_pool_scan<<<n_tiles, kScanThreads, 0, stream>>>(s, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // a thread per point, and a warp per 32 target rows
  const long long place_blocks = max(pt_blocks, (n_rows + kThreads - 1) / kThreads);
  patch_pool_place<<<(unsigned)place_blocks, kThreads, 0, stream>>>(rows, B, P, Tn, C, s, out,
                                                                     den_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // a thread per dense slot: the grid covers every point, the live ones hold slots
  patch_pool_order<<<(unsigned)pt_blocks, kThreads, 0, stream>>>(rows, cols, vals, P, Hs, Ws, Tn,
                                                                  s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (accum_bf16) {
    patch_pool_gather_bf16<T><<<(unsigned)((n_rows * 32 + kThreads - 1) / kThreads), kThreads, 0,
                                stream>>>(src, Hs, Ws, C, s, n_rows, with_den, out, den_out);
    return (int)cudaGetLastError();
  }
  // the vector form also stores 4 channels at once: out must be 16-byte aligned
  if (C % 8 == 0 && spt::aligned(src, 16) && spt::aligned(out, 16))
    err = gather<T, 8, 8>(src, Hs, Ws, C, s, z.n_blocks, with_den, out, den_out, stream);
  else
    err = gather<T, 1, 32>(src, Hs, Ws, C, s, z.n_blocks, with_den, out, den_out, stream);
  return (int)err;
}

// ---------------------------------------------------------------- A-bwd
//
// The source gradient of the pool, the forward's transpose: every live
// corner entry (p, k) adds vals[p,k] * g[row_p] (divided by den[row_p] where
// the forward divided) to source cell cols[p,k]:
//
//   g_src[b*Hs*Ws + cols[b,p,k], c] += vals[b,p,k] / den[b*T + rows[b,p]]
//                                      * g[b*T + rows[b,p], c]
//
// with the division's gradient 0 where den <= 1e-12, as in the reference's
// `_patch_pool_denom_with_vjp.bwd` (sparse_pool.py:196-221, the quotient
// differentiated outside it, :319-326), keyed by cols[..., k] itself. Flat ids
// outside the batch add nothing.
//
// Bound on an H100: bytes. At the main path's shapes (B = 8, 16384 points a
// frame, C = 64, bf16 source maps) a call reads the distinct live rows of g
// (f32, 4-6 MB), the point tables (4.5 MB) and writes the bf16 source
// gradient (7.7 / 9.0 MB): 5 us at 3.35 TB/s.
//
// Design: a scatter of 4P entries into the source map becomes a gather with
// no atomics on features. The entries are sorted by source cell with A's
// count and scan, and the gather splits the work by entries, never by cells:
// at the main path's inputs one BEV cell takes 1133 entries, the mean is 14.
// (1) count: a thread per point, its four corners' live entries (a non-zero
//     weight, both ids in range, a row with den > 1e-12) counted per cell;
//     the lanes of a warp that share a cell take one atomic between them
//     (`__match_any_sync`) and keep their tickets;
// (2) A's two-level scan of the counts;
// (3) place: a thread per point writes each live entry's index (4 p + k) at
//     offs[cell] + ticket; a warp per 32 cells writes the unreached cells'
//     zeros;
// (4) order: a thread per slot ranks its entry among its cell's by entry
//     index (A's rank, the lanes of a long cell together: cells run to 1133
//     entries) and writes its cell and its (row of g, weight over the row's
//     weight sum) pair, 12 bytes, at offs[cell] + rank: each cell's entries
//     in entry order, whatever order the atomics of (1) gave them;
// (5) gather: a group of G lanes walks 32 consecutive slots, 16 bytes of g's
//     row a lane where C is a multiple of 64 (G = 16), else one channel a
//     lane (G = 32). A lane reads one slot's entry and the group shares them
//     by shuffles, so each lane issues the loads of 8 rows before it sums
//     them. A run of one cell that lies wholly in the group's slots is
//     written once, in the source dtype. A run that goes on in the chunk
//     before or after goes to a carry buffer; the last of its cell's chunks
//     to finish (a ticket per cell, after a fence) adds the carries in chunk
//     order and writes the cell.
// Every f32 sum is taken in an order the inputs fix (entry order within a
// chunk, chunks in order), so a launch gives the same bits as the last.
//
// What holds it back on an H100 at the main path's shapes: the gather
// (26-29 us) reads one 256-byte f32 row of g per live entry, 92 MB from the
// L2, where the bound counts each distinct row once; count and place (24-30
// us) make 360K atomics that return a rank and as many scattered slot
// writes. A warp per cell, the first design, took 246 us for the BEV map,
// held by the one warp of the 1133-entry cell: hence the split by entries.

constexpr int kChunk = 32;  // slots a lane group walks in the A-bwd gather
constexpr int kBatch = 8;   // rows of g a lane loads before it sums them

// A-bwd's scratch, carved in this order; every part starts 16-byte aligned.
// Its first parts (hist, done, arrive, local, tile_sum, tile_base) are laid
// out as A's, so that A's scan runs on `scan`.
struct BwdScratch {
  Scratch scan;
  int4* rank;      // [n_pts] each corner entry's ticket within its cell, -1 if dead
  int* slot_key;   // [n_slots] the entry (4 p + k) at each slot, in ticket order
  int* slot_cell;  // [n_slots] source cell (flat over B*Hs*Ws)
  int2* slot_rw;   // [n_slots] row of g (flat over B*T), the weight's bits
  float* carry;    // [n_chunks, 2, C] a chunk's runs open before (0) and after (1)

  struct Sizes {
    long long n_pad, n_tiles, n_chunks, n_slots;
  };
  __host__ static Sizes sizes(long long n_cells, long long n_pts) {
    const long long n_pad = round_up(n_cells, kScanTile);
    const long long n_chunks = (4 * n_pts + kChunk - 1) / kChunk;
    return {n_pad, round_up(n_pad / kScanTile, 4), n_chunks, n_chunks * kChunk + 4};
  }
  __host__ static long long ints(long long n_cells, long long n_pts, int C) {
    const Sizes z = sizes(n_cells, n_pts);
    return 2 * z.n_pad + 4 + round_up(z.n_chunks, 4) + 2 * z.n_tiles + 4 * n_pts +
           4 * z.n_slots + round_up(z.n_chunks * 2 * C, 4);
  }
  __host__ BwdScratch(int* base, long long n_cells, long long n_pts) {
    const Sizes z = sizes(n_cells, n_pts);
    scan.hist = base;
    scan.done = scan.hist + z.n_pad;
    scan.arrive = scan.done + 4;
    scan.local = scan.arrive + round_up(z.n_chunks, 4);
    scan.tile_sum = scan.local + z.n_pad;
    scan.tile_base = scan.tile_sum + z.n_tiles;
    rank = reinterpret_cast<int4*>(scan.tile_base + z.n_tiles);
    slot_key = reinterpret_cast<int*>(rank + n_pts);
    slot_cell = slot_key + z.n_slots;
    slot_rw = reinterpret_cast<int2*>(slot_cell + z.n_slots);
    carry = reinterpret_cast<float*>(slot_rw + z.n_slots);
  }
};

__global__ void patch_pool_bwd_count(const int* __restrict__ rows, const int* __restrict__ cols,
                                     const float* __restrict__ vals,
                                     const float* __restrict__ den, int B, int P, int Tn,
                                     int n_src, BwdScratch s) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const bool in = i < (long long)B * P;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  long long b = 0;
  bool row_live = false;
  if (in) {
    b = i / P;
    const long long row = b * Tn + rows[i];
    row_live = row >= 0 && row < (long long)B * Tn;
    if (row_live && den != nullptr) row_live = den[row] > 1e-12f;
  }
  // all four corners' atomics go out before any result is waited for
  int key[4], base[4];
  unsigned peers[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    long long cell = -1;
    if (row_live && vals[i * 4 + k] != 0.0f) {
      cell = b * n_src + cols[i * 4 + k];
      if (cell >= (long long)B * n_src) cell = -1;
    }
    // every lane takes part: a dead entry's key matches no other lane
    key[k] = cell >= 0 ? (int)cell : -1 - lane;
    peers[k] = __match_any_sync(kFull, key[k]);
    base[k] = 0;
    if (key[k] >= 0 && (peers[k] & below) == 0)
      base[k] = atomicAdd(s.scan.hist + key[k], __popc(peers[k]));
  }
  int r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int first = __shfl_sync(kFull, base[k], __ffs(peers[k]) - 1);
    r[k] = key[k] >= 0 ? first + __popc(peers[k] & below) : -1;
  }
  if (in) s.rank[i] = make_int4(r[0], r[1], r[2], r[3]);
}

// Also writes the unreached cells' zeros: a warp per 32 cells.
template <typename O>
__global__ void patch_pool_bwd_place(const int* __restrict__ cols, int B, int P, int n_src, int C,
                                     BwdScratch s, O* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long n_cells = (long long)B * n_src;
  const long long cell0 = (i >> 5) * 32;
  if (cell0 < n_cells) {
    const long long mine = cell0 + (threadIdx.x & 31);
    const unsigned empty = __ballot_sync(kFull, mine < n_cells && s.scan.hist[mine] == 0);
    O* dst = out + cell0 * C;
    constexpr int kPer = 16 / (int)sizeof(O);  // values per 16-byte store
    if (C % kPer == 0 && spt::aligned(out, 16)) {
      const int cv = C / kPer;
      for (int k = threadIdx.x & 31; k < 32 * cv; k += 32)
        if (empty >> (k / cv) & 1) reinterpret_cast<uint4*>(dst)[k] = make_uint4(0, 0, 0, 0);
    } else {
      for (int k = threadIdx.x & 31; k < 32 * C; k += 32)
        if (empty >> (k / C) & 1) dst[k] = spt::from_f32<O>(0.0f);
    }
  }
  if (i >= (long long)B * P) return;
  const int4 r4 = s.rank[i];
  if ((r4.x & r4.y & r4.z & r4.w) < 0) return;  // every corner dead
  const long long b = i / P;
  const int rk[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (rk[k] >= 0) s.slot_key[slot_of(s.scan, b * n_src + cols[i * 4 + k]) + rk[k]] = (int)(i * 4 + k);
}

// A thread per slot: its entry's rank among its cell's entries by entry
// index gives the slot it moves to.
__global__ void patch_pool_bwd_order(const int* __restrict__ rows, const int* __restrict__ cols,
                                     const float* __restrict__ vals,
                                     const float* __restrict__ den, int P, int Tn, int n_src,
                                     BwdScratch s) {
  const long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const bool live = q < s.scan.done[1];
  int e = 0, n = 0;
  long long b = 0, cell = 0, base = 0;
  if (live) {
    e = __ldg(s.slot_key + q);
    b = (e >> 2) / P;
    cell = b * n_src + cols[e];
    base = slot_of(s.scan, cell);
    n = s.scan.hist[cell];
  }
  const int r = rank_in_run(s.slot_key, base, n, e, live);
  if (!live) return;
  const long long row = b * Tn + rows[e >> 2];
  const float w = den != nullptr ? vals[e] / den[row] : vals[e];
  s.slot_cell[base + r] = (int)cell;
  s.slot_rw[base + r] = make_int2((int)row, __float_as_int(w));
}

// G lanes a group, W channels a lane, G * W channels a pass; a group per
// kChunk slots.
template <typename O, int G, int W>
__global__ void __launch_bounds__(kThreads, 3)
patch_pool_bwd_gather(const float* __restrict__ g, int C, BwdScratch s, O* __restrict__ out) {
  static_assert(G % kBatch == 0 && 32 % G == 0, "a group is whole batches and divides a warp");
  const int gl = threadIdx.x % G;
  const unsigned gmask =
      G == 32 ? kFull : (((1u << G) - 1) << ((threadIdx.x & 31) / G * G));
  const long long chunk = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / G;
  const int n_live = s.scan.done[1];
  const long long q0 = chunk * kChunk;
  if (q0 >= n_live) return;  // the grid covers every entry, not only the live ones
  const int n_here = (int)min((long long)kChunk, n_live - q0);
  const int prev = q0 > 0 ? s.slot_cell[q0 - 1] : -1;
  const int next = q0 + n_here < n_live ? s.slot_cell[q0 + n_here] : -1;
  float* carry = s.carry + chunk * 2 * C;
  int open_cell[2] = {-1, -1};  // the cells of the runs open before and after the chunk

  for (int c0 = 0; c0 < C; c0 += G * W) {
    const int c = c0 + gl * W;
    const bool has_c = c < C;
    float acc[W] = {};
    int cur = -1;
    bool first = true;
    const auto flush = [&](bool last) {
      const bool open0 = first && cur == prev;
      const bool open1 = last && cur == next;
      if (!open0 && !open1) {
        if (has_c) spt::store_from_f32<O, W>(out + (long long)cur * C + c, acc);
      } else {
        const int side = open0 ? 0 : 1;
        if (has_c) spt::store_from_f32<float, W>(carry + side * C + c, acc);
        open_cell[side] = cur;
      }
      first = false;
    };
    for (int base = 0; base < n_here; base += G) {
      // each lane reads one slot's entry; the group shares them by shuffles
      const int mine = base + gl;
      int cell_l = -1, row_l = 0;
      float w_l = 0.0f;
      if (mine < n_here) {
        cell_l = s.slot_cell[q0 + mine];
        const int2 rw = s.slot_rw[q0 + mine];
        row_l = rw.x;
        w_l = __int_as_float(rw.y);
      }
      const int n_b = min(G, n_here - base);
      for (int j0 = 0; j0 < n_b; j0 += kBatch) {
        float v[kBatch][W];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int row = __shfl_sync(gmask, row_l, j0 + j, G);
          if (j0 + j < n_b && has_c) {
            spt::load_f32<float, W>(g + (long long)row * C + c, v[j]);
          } else {
#pragma unroll
            for (int n = 0; n < W; ++n) v[j][n] = 0.0f;
          }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (j0 + j >= n_b) break;
          const int cell = __shfl_sync(gmask, cell_l, j0 + j, G);
          const float wt = __shfl_sync(gmask, w_l, j0 + j, G);
          if (cell != cur) {
            if (cur >= 0) flush(false);
            cur = cell;
#pragma unroll
            for (int n = 0; n < W; ++n) acc[n] = 0.0f;
          }
#pragma unroll
          for (int n = 0; n < W; ++n) acc[n] = acc[n] + wt * v[j][n];
        }
      }
    }
    flush(true);
  }

  // a cell open towards a neighbour: the last of its chunks to get here adds
  // the carries, its first chunk's side 1 and the others' side 0, in order
  // (the fence makes this group's carries visible first)
  __threadfence();
  __syncwarp(gmask);
  for (int side = 0; side < 2; ++side) {
    const int cell = open_cell[side];
    if (cell < 0 || (side == 1 && cell == open_cell[0])) continue;  // one run open both ways
    const long long first_slot = slot_of(s.scan, cell);
    const long long k1 = first_slot / kChunk;
    const long long k2 = (first_slot + s.scan.hist[cell] - 1) / kChunk;
    int last = 0;
    if (gl == 0) last = atomicAdd(s.scan.arrive + k1, 1) == (int)(k2 - k1);
    if (!__shfl_sync(gmask, last, 0, G)) continue;
    for (int ch = gl; ch < C; ch += G) {
      float v = __ldcg(s.carry + (2 * k1 + 1) * C + ch);
      for (long long k = k1 + 1; k <= k2; ++k) v = v + __ldcg(s.carry + 2 * k * C + ch);
      out[(long long)cell * C + ch] = spt::from_f32<O>(v);
    }
  }
}

template <typename O>
int launch_bwd(const float* g, const float* den, int B, int Tn, int C, const int* rows,
               const int* cols, const float* vals, int P, int Hs, int Ws, int* scratch,
               void* out_v, cudaStream_t stream) {
  O* out = static_cast<O*>(out_v);
  const long long n_src = (long long)Hs * Ws;
  const long long n_cells = (long long)B * n_src;
  const long long n_pts = (long long)B * P;
  if (n_cells == 0 || C == 0) return 0;
  if (n_pts == 0) return (int)cudaMemsetAsync(out, 0, sizeof(O) * n_cells * C, stream);
  const BwdScratch::Sizes z = BwdScratch::sizes(n_cells, n_pts);
  const BwdScratch s(scratch, n_cells, n_pts);
  cudaError_t err = cudaMemsetAsync(
      s.scan.hist, 0, sizeof(int) * (z.n_pad + 4 + round_up(z.n_chunks, 4)), stream);
  if (err != cudaSuccess) return (int)err;
  const long long pt_blocks = (n_pts + kThreads - 1) / kThreads;
  patch_pool_bwd_count<<<(unsigned)pt_blocks, kThreads, 0, stream>>>(rows, cols, vals, den, B, P,
                                                                     Tn, (int)n_src, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n_tiles = (int)(z.n_pad / kScanTile);
  patch_pool_scan<<<n_tiles, kScanThreads, 0, stream>>>(s.scan, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // a thread per point, and a warp per 32 cells
  const long long place_blocks = max(pt_blocks, (n_cells + kThreads - 1) / kThreads);
  patch_pool_bwd_place<O><<<(unsigned)place_blocks, kThreads, 0, stream>>>(cols, B, P, (int)n_src,
                                                                          C, s, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // a thread per slot: the grid covers every corner entry, the live ones hold slots
  patch_pool_bwd_order<<<(unsigned)((4 * n_pts + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      rows, cols, vals, den, P, Tn, (int)n_src, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (C % 64 == 0 && spt::aligned(g, 16) && spt::aligned(out, 16))
    patch_pool_bwd_gather<O, 16, 4><<<(unsigned)((z.n_chunks * 16 + kThreads - 1) / kThreads),
                                      kThreads, 0, stream>>>(g, C, s, out);
  else
    patch_pool_bwd_gather<O, 32, 1><<<(unsigned)((z.n_chunks * 32 + kThreads - 1) / kThreads),
                                      kThreads, 0, stream>>>(g, C, s, out);
  return (int)cudaGetLastError();
}

}  // namespace

// int32 scratch the wrapper allocates (16-byte aligned): see Scratch.
extern "C" long long sparse_pool_patch_scratch_ints(int B, int P, int Tn, int C) {
  return Scratch::ints(B, Tn, P, C);
}

// dtype: 0 = float32 source, 1 = bfloat16 source. accum_bf16: 0 sums in f32
// (the gather above), 1 in bf16 (`patch_pool_gather_bf16`). scratch: the
// int32 buffer above; out: [B*T, C] f32; den: [B*T] f32 weight sums, or
// null (written only with with_den).
extern "C" int sparse_pool_patch_launch(const void* src, int dtype, int B, int Hs, int Ws,
                                        int C, const int* rows, const int* cols,
                                        const float* vals, int P, int Tn, int with_den,
                                        int accum_bf16, int* scratch, float* out, float* den,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!spt::aligned(scratch, 16)) return (int)cudaErrorMisalignedAddress;
  float* den_out = with_den ? den : nullptr;
  if (dtype == 0)
    return launch<float>(src, B, Hs, Ws, C, rows, cols, vals, P, Tn, with_den, accum_bf16,
                         scratch, out, den_out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(src, B, Hs, Ws, C, rows, cols, vals, P, Tn, with_den,
                                 accum_bf16, scratch, out, den_out, s);
  return (int)cudaErrorInvalidValue;
}

// int32 scratch of A-bwd (16-byte aligned): see BwdScratch.
extern "C" long long sparse_pool_patch_bwd_scratch_ints(int B, int P, int n_src, int C) {
  return BwdScratch::ints((long long)B * n_src, (long long)B * P, C);
}

// g: [B*T, C] f32 gradient of the pooled output; den: [B*T] f32 weight sums
// of the forward, or null where it did not divide; out: [B, Hs, Ws, C] in
// dtype (0 = float32, 1 = bfloat16).
extern "C" int sparse_pool_patch_bwd_launch(const float* g, const float* den, int B, int Tn,
                                            int C, const int* rows, const int* cols,
                                            const float* vals, int P, int Hs, int Ws, int dtype,
                                            int* scratch, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!spt::aligned(scratch, 16)) return (int)cudaErrorMisalignedAddress;
  if (dtype == 0)
    return launch_bwd<float>(g, den, B, Tn, C, rows, cols, vals, P, Hs, Ws, scratch, out, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, den, B, Tn, C, rows, cols, vals, P, Hs, Ws, scratch, out,
                                     s);
  return (int)cudaErrorInvalidValue;
}
