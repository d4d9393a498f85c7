// window_rows (K17): a digitize batch's photons gathered from the photon
// arena through its piece table, kept where their channel lies in
// [0, C), in row order (row = window * C + channel), with each row's
// channel extents.
//
// Replaces: wfsim_tpu/pipeline/digitize.py:224-260 (the arena gather of
// gather_digitize, whose one-hot select stands in for the row gathers a
// TPU ran at <0.5 GB/s, :235-250) and :270-284 (the channel extents, a
// flattened min/max scatter); the one-window form digitize_window,
// :96-123.  On the TPU the batch was a dense (B, n_cap) slab of photon
// slots, masked past each window's count, and the superposition took the
// photons unsorted; the port's superposition (superpose_adc.cu) takes each
// row's photons as one run in arena order (its fixed order of adds, F4),
// so this kernel also lays the photons out in row order, with no sort.
//
// What bounds it on the H100: bytes.  Each photon's channel, time and
// gain are read once and its time and gain written once (~20 bytes a
// photon), the piece table and the per-row arrays besides: a few
// microseconds at the main path's sizes, under the cost of a launch.  The
// work is latency: two passes over the photons whose placement is stable.
//
// The host cuts every window's photons (its pieces' photons one after
// another, in table order) into segments of at most WINDOW_SEGMENT
// photons (pipeline/digitize.py; at least one segment a window, empty for
// a window without photons) and
// hands over the plan [window, first segment of the window, segments of
// the window, first photon, length] per segment.  A block a segment, two
// launches:
//
// 1. count: the block's photons, kPerThread a thread a tile of kTile, each
//    photon's piece by a binary search of the window's piece starts, add
//    to the segment's per-channel count, min and max of t // dt in shared
//    memory (integer atomics: order-free); the segment's (C,) counts,
//    minima and maxima and its kept total go to the scratch;
// 2. place: the window's base is the sum of the kept totals of the
//    segments before the window's first; each channel's total over the
//    window's segments and its count in the segments before this one give,
//    after a block scan over the channels, where this segment's photons of
//    each channel start.  The window's first segment writes the rows'
//    row_ptr and extents (min and max over the window's segments).  Then
//    the photons again in arena order, a tile at a time: within a warp a
//    photon's rank among the photons of its channel is the count of lower
//    lanes with the same channel (__match_any_sync), a warp adds the
//    counts of the warps before it (a (warps, C) table in shared memory),
//    and each channel's cursor moves by the tile's count.  So each row
//    holds its photons in arena order: bitwise window_photons_ref.
//
// t and gain have one slot a photon of the table (the host's total): the
// kept photons fill [0, row_ptr[B * C]) and the rest is zeroed, so nothing
// is read back.  Photons with a channel outside [0, C) are dropped, as
// window_photons_ref drops them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;                   // photons a thread a tile
constexpr int kTile = kThreads * kPerThread;
constexpr int kMaxChannels = 1024;
constexpr int kChPerThread = kMaxChannels / kThreads;
constexpr int kPlan = 5;                        // words a segment's plan
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

struct Batch {
  const int* t;
  const int* ch;
  const float* gain;
  const long long* pieces;    // (B, P, 3) [arena_lo, count, t_offset]
  const long long* pstart;    // (B, P) each piece's first photon in its window
  const long long* plan;      // (n_seg, kPlan)
  int n_pieces;               // P
  int n_seg;
  int n_ch;                   // C
  int dt;
};

// int32 add and subtract that wrap modulo 2^32, as torch's do
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int clamp_to(int x, int hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// torch.div(t, dt, rounding_mode='floor') for dt > 0
__device__ __forceinline__ int floor_div(int t, int dt) {
  const int q = t / dt;
  return (t % dt < 0) ? q - 1 : q;
}

// photon j of window w (j below the window's total): its arena index and
// its piece's t_offset.  The piece is the last whose start is <= j: pieces
// without photons share their start with the next piece, so it holds j.
__device__ __forceinline__ long long arena_index(const Batch& b, int w,
                                                 long long j,
                                                 long long& toff) {
  const long long* ps = b.pstart + static_cast<long long>(w) * b.n_pieces;
  int lo = 0, hi = b.n_pieces;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ps + mid) <= j) lo = mid; else hi = mid;
  }
  const long long* pc =
      b.pieces + (static_cast<long long>(w) * b.n_pieces + lo) * 3;
  toff = __ldg(pc + 2);
  return __ldg(pc) + (j - __ldg(ps + lo));
}

// int64 arena time plus t_offset, cast to int32 (wrapping, as the twin's
// .to(torch.int32))
__device__ __forceinline__ int shifted_time(int t, long long toff) {
  return static_cast<int>(static_cast<unsigned>(
      static_cast<unsigned long long>(static_cast<long long>(t) + toff)));
}

struct Segment {
  int w, s0, nw, len;
  long long j0;
};

__device__ __forceinline__ Segment segment_of(const Batch& b, int s) {
  const long long* p = b.plan + static_cast<long long>(s) * kPlan;
  Segment g;
  g.w = static_cast<int>(__ldg(p));
  g.s0 = static_cast<int>(__ldg(p + 1));
  g.nw = static_cast<int>(__ldg(p + 2));
  g.j0 = __ldg(p + 3);
  g.len = static_cast<int>(__ldg(p + 4));
  return g;
}

// the sums of a and c over the block, in every thread
__device__ __forceinline__ void block_sum2(int& a, int& c, int* red) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    c += __shfl_xor_sync(kFull, c, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = c;
  }
  __syncthreads();
  a = 0;
  c = 0;
  for (int i = 0; i < kWarps; ++i) {
    a += red[i];
    c += red[kWarps + i];
  }
}

// the sum of v over the threads before this one
__device__ __forceinline__ int block_exclusive_scan(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  __syncthreads();
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int i = 0; i < warp; ++i) before += red[i];
  return before + incl - v;
}

__global__ void __launch_bounds__(kThreads)
window_rows_count_kernel(Batch b, int* __restrict__ seg_cnt,
                         int* __restrict__ seg_min, int* __restrict__ seg_max,
                         int* __restrict__ seg_total) {
  extern __shared__ int sh[];
  __shared__ int red[2 * kWarps];
  const int C = b.n_ch;
  int* cnt = sh;
  int* mn = sh + C;
  int* mx = sh + 2 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    cnt[c] = 0;
    mn[c] = kBig;
    mx[c] = -kBig;
  }
  __syncthreads();
  const Segment g = segment_of(b, blockIdx.x);
  for (int base = 0; base < g.len; base += kTile) {
    int chv[kPerThread], tv[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int i = base + q * kThreads + threadIdx.x;
      chv[q] = -1;
      tv[q] = 0;
      if (i < g.len) {
        long long toff;
        const long long a = arena_index(b, g.w, g.j0 + i, toff);
        chv[q] = __ldg(b.ch + a);
        tv[q] = shifted_time(__ldg(b.t + a), toff);
      }
    }
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int c = chv[q];
      if (c >= 0 && c < C) {
        const int s = floor_div(tv[q], b.dt);
        atomicAdd(cnt + c, 1);
        atomicMin(mn + c, s);
        atomicMax(mx + c, s);
      }
    }
  }
  __syncthreads();
  int kept = 0, unused = 0;
  const long long row0 = static_cast<long long>(blockIdx.x) * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    seg_cnt[row0 + c] = cnt[c];
    seg_min[row0 + c] = mn[c];
    seg_max[row0 + c] = mx[c];
    kept += cnt[c];
  }
  block_sum2(kept, unused, red);
  if (threadIdx.x == 0) seg_total[blockIdx.x] = kept;
}

__global__ void __launch_bounds__(kThreads)
window_rows_place_kernel(Batch b, const int* __restrict__ seg_cnt,
                         const int* __restrict__ seg_min,
                         const int* __restrict__ seg_max,
                         const int* __restrict__ seg_total, int n_win,
                         int n_samples, int left_pad, int right_pad,
                         int n_out, int* __restrict__ t_out,
                         float* __restrict__ gain_out,
                         int* __restrict__ row_ptr, int* __restrict__ ch_left,
                         int* __restrict__ ch_right,
                         unsigned char* __restrict__ has) {
  extern __shared__ int sh[];
  __shared__ int red[2 * kWarps];
  const int C = b.n_ch;
  int* cursor = sh;            // (C,) the next slot of each channel's row
  int* wcnt = sh + C;          // (kWarps, C) a sub-tile's counts by warp
  const int s = blockIdx.x;
  const Segment g = segment_of(b, s);
  const int k = s - g.s0;
  for (int i = threadIdx.x; i < kWarps * C; i += kThreads) wcnt[i] = 0;

  // the window's base: the kept photons of the windows before it
  int before = 0, total = 0;
  for (int i = threadIdx.x; i < b.n_seg; i += kThreads) {
    const int v = __ldg(seg_total + i);
    total += v;
    if (i < g.s0) before += v;
  }
  block_sum2(before, total, red);

  // each channel's photons in the window and in its segments before this
  // one; thread t takes the channels t * per .. t * per + per - 1
  const int per = (C + kThreads - 1) / kThreads;
  int tot[kChPerThread], pre[kChPerThread], lo[kChPerThread],
      hi[kChPerThread];
  int mine = 0;
#pragma unroll
  for (int u = 0; u < kChPerThread; ++u) {
    tot[u] = 0;
    pre[u] = 0;
    lo[u] = kBig;
    hi[u] = -kBig;
    const int c = threadIdx.x * per + u;
    if (u < per && c < C) {
      for (int kk = 0; kk < g.nw; ++kk) {
        const long long o = static_cast<long long>(g.s0 + kk) * C + c;
        const int v = __ldg(seg_cnt + o);
        tot[u] += v;
        if (kk < k) pre[u] += v;
        if (k == 0) {
          lo[u] = min(lo[u], __ldg(seg_min + o));
          hi[u] = max(hi[u], __ldg(seg_max + o));
        }
      }
    }
    mine += tot[u];
  }
  const int first = block_exclusive_scan(mine, red);
  int off = before + first;
#pragma unroll
  for (int u = 0; u < kChPerThread; ++u) {
    const int c = threadIdx.x * per + u;
    if (u < per && c < C) {
      cursor[c] = off + pre[u];
      if (k == 0) {
        const long long row = static_cast<long long>(g.w) * C + c;
        row_ptr[row] = off;
        has[row] = hi[u] >= lo[u] ? 1 : 0;
        ch_left[row] = clamp_to(wrap_sub(lo[u], left_pad), n_samples - 1);
        ch_right[row] = clamp_to(wrap_add(hi[u], right_pad), n_samples - 1);
      }
      off += tot[u];
    }
  }
  if (k == 0 && g.w == n_win - 1 && threadIdx.x == kThreads - 1)
    row_ptr[static_cast<long long>(n_win) * C] = before + first + mine;
  // the slots past the kept photons: zero, shared among the blocks
  for (long long i = total + static_cast<long long>(s) * kThreads +
                     threadIdx.x;
       i < n_out; i += static_cast<long long>(b.n_seg) * kThreads) {
    t_out[i] = 0;
    gain_out[i] = 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < g.len; base += kTile) {
    int key[kPerThread], tv[kPerThread];
    float gv[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int i = base + q * kThreads + threadIdx.x;
      key[q] = -1;
      tv[q] = 0;
      gv[q] = 0.0f;
      if (i < g.len) {
        long long toff;
        const long long a = arena_index(b, g.w, g.j0 + i, toff);
        const int c = __ldg(b.ch + a);
        key[q] = (c >= 0 && c < C) ? c : -1;
        tv[q] = shifted_time(__ldg(b.t + a), toff);
        gv[q] = __ldg(b.gain + a);
      }
    }
    // sub-tile q: the photons base + q * kThreads + [0, kThreads), in
    // order; lane order within a warp, warp order within the sub-tile
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int c = key[q];
      const unsigned same = __match_any_sync(kFull, c);
      const int rank = __popc(same & below);
      const bool lead = c >= 0 && rank == 0;
      if (lead) wcnt[warp * C + c] = __popc(same);
      __syncthreads();
      if (c >= 0) {
        int pos = cursor[c] + rank;
        for (int v = 0; v < warp; ++v) pos += wcnt[v * C + c];
        t_out[pos] = tv[q];
        gain_out[pos] = gv[q];
      }
      __syncthreads();
      if (lead) {
        atomicAdd(cursor + c, __popc(same));
        wcnt[warp * C + c] = 0;
      }
      __syncwarp();
    }
  }
}

}  // namespace

// The batch's rows: out t, gain (n_out,), row_ptr (n_win * n_ch + 1,),
// ch_left, ch_right (n_win * n_ch,) int32 and has (n_win * n_ch,) bool.
// scratch holds n_seg * (3 * n_ch + 1) int32 (written before it is read).
// left_pad / right_pad: what the extents subtract from the row's first
// sample and add to its last before the clip to [0, n_samples - 1].
extern "C" int wfsim_window_rows(
    const void* t, const void* ch, const void* gain, const void* pieces,
    const void* pstart, int n_pieces, const void* plan, int n_seg, int n_win,
    int n_ch, int n_samples, int dt, int left_pad, int right_pad, int n_out,
    void* scratch, void* t_out, void* gain_out, void* row_ptr, void* ch_left,
    void* ch_right, void* has, void* stream) {
  if (n_win <= 0 || n_seg < n_win || n_ch <= 0 || n_ch > kMaxChannels ||
      n_pieces < 0 || n_samples <= 0 || dt <= 0 || n_out < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Batch b;
  b.t = static_cast<const int*>(t);
  b.ch = static_cast<const int*>(ch);
  b.gain = static_cast<const float*>(gain);
  b.pieces = static_cast<const long long*>(pieces);
  b.pstart = static_cast<const long long*>(pstart);
  b.plan = static_cast<const long long*>(plan);
  b.n_pieces = n_pieces;
  b.n_seg = n_seg;
  b.n_ch = n_ch;
  b.dt = dt;
  int* seg_cnt = static_cast<int*>(scratch);
  int* seg_min = seg_cnt + static_cast<long long>(n_seg) * n_ch;
  int* seg_max = seg_min + static_cast<long long>(n_seg) * n_ch;
  int* seg_total = seg_max + static_cast<long long>(n_seg) * n_ch;
  window_rows_count_kernel<<<n_seg, kThreads, 3 * n_ch * sizeof(int), st>>>(
      b, seg_cnt, seg_min, seg_max, seg_total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_rows_place_kernel<<<n_seg, kThreads,
                             (1 + kWarps) * n_ch * sizeof(int), st>>>(
      b, seg_cnt, seg_min, seg_max, seg_total, n_win, n_samples, left_pad,
      right_pad, n_out, static_cast<int*>(t_out),
      static_cast<float*>(gain_out), static_cast<int*>(row_ptr),
      static_cast<int*>(ch_left), static_cast<int*>(ch_right),
      static_cast<unsigned char*>(has));
  return static_cast<int>(cudaGetLastError());
}
