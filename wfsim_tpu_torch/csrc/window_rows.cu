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
// photon), the piece table and the per-row arrays besides: 0.5-6 us at
// 3.35 TB/s at the main path's sizes, under the cost of a launch.  The
// work is latency: a stable placement over a batch that the host does not
// size, so the design counts dependent round trips to device memory.  The
// first design (a block a segment of up to 8,192 photons, each photon's
// piece by a binary search of dependent loads, a device-memory round trip
// and two barriers a 256-photon sub-tile, every block summing the counts
// of all segments before it) took 12-66x its bound on NVIDIA H100 80GB
// HBM3 at 700.00 W.  This one:
//
// - a block takes a segment of up to kSeg = 8,192 of a window's photons
//   (the host's plan; at least one segment a window) and holds them in
//   registers, kPer a thread, loaded in one round trip after the
//   segment's pieces are staged in shared memory (each photon's piece a
//   search of those few);
// - a window of one segment (the default run's largest batch has none
//   longer than 4,709 photons) needs no table: its block has the
//   window's counts, extents and row offsets;
//   a longer window's segments write per-channel counts, minima and
//   maxima, and "last block done" scans turn them into bases, linear in
//   the segments: the last segment of a group of G = 16 scans the group,
//   the last group of a window scans the groups (extents, row offsets);
//   the last window of the batch scans the windows' totals into bases;
// - the place pass counts each warp's run of the segment by channel
//   (shared atomics, from registers), scans the warps and the channels in
//   shared memory into each warp's cursors, ranks each photon among the
//   lower lanes of its step (the lanes of its channel from eleven
//   ballots) and stages the segment's time, gain and destination in row
//   order in shared memory; the segment is then written out with
//   neighbouring threads on neighbouring addresses (one contiguous run
//   for a window of one segment, a run a channel otherwise);
// - a segment that lies inside one piece (the common case) finds its
//   photons' arena indices by one add.
//
// Two launches, no read-back.  So each row holds its photons in arena
// order: bitwise window_photons_ref.  t and gain have one slot a photon of
// the table (the host's total): the kept photons fill [0, row_ptr[B * C])
// and the rest is zeroed.  Photons with a channel outside [0, C) are
// dropped, as window_photons_ref drops them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                        // photons a thread
constexpr int kSeg = kThreads * kPer;           // photons a segment at most
constexpr int kMaxChannels = 1024;
constexpr int kChPerThread = kMaxChannels / kThreads;
constexpr int kGroup = 16;                      // segments a group
constexpr int kScanLoads = 8;                   // scan rows in flight
constexpr int kStage = 256;                     // pieces staged a block
constexpr int kPlan = 6;                        // words a segment's plan
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

struct Batch {
  const int* t;
  const int* ch;
  const float* gain;
  const long long* pieces;    // (B, P, 3) [arena_lo, count, t_offset]
  const long long* pstart;    // (B, P) each piece's first photon in its window
  const long long* plan;      // (n_seg, kPlan) see Segment
  int n_win;                  // B
  int n_pieces;               // P
  int n_seg;
  int n_grp;
  int n_ch;                   // C
  int dt;
};

// the per-segment, per-group and per-window tables (written before read;
// the segment and group tables only for windows of more than one segment)
struct Tables {
  int* sc;      // (n_seg, C) a segment's counts, then their prefix in the group
  int* smn;     // (n_seg, C) a segment's minima of t // dt
  int* smx;     // (n_seg, C) and maxima
  int* gc;      // (n_grp, C) a group's totals, then their prefix in the window
  int* gmn;     // (n_grp, C)
  int* gmx;     // (n_grp, C)
  int* rowoff;  // (B, C) each row's first slot within its window
  int* wtot;    // (B,) each window's kept photons
  int* wbase;   // (B + 1,) each window's first slot; wbase[B] the kept total
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

// int64 arena time plus t_offset, cast to int32 (wrapping, as the twin's
// .to(torch.int32))
__device__ __forceinline__ int shifted_time(int t, long long toff) {
  return static_cast<int>(static_cast<unsigned>(
      static_cast<unsigned long long>(static_cast<long long>(t) + toff)));
}

// a block's segment, from the host's plan [window, its first segment, its
// segments, first photon, photons, its first group]: index k in the
// window, group g (first segment g_s0, segments g_n), the window's groups
// (first w_g0, count w_gn)
struct Segment {
  int w, s0, nw, k, g, g_s0, g_n, w_g0, w_gn, len;
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
  g.w_g0 = static_cast<int>(__ldg(p + 5));
  g.k = s - g.s0;
  g.g = g.w_g0 + g.k / kGroup;
  g.g_s0 = g.s0 + (g.k / kGroup) * kGroup;
  g.g_n = min(kGroup, g.s0 + g.nw - g.g_s0);
  g.w_gn = (g.nw + kGroup - 1) / kGroup;
  return g;
}

// The pieces that hold the segment's photons, staged once a block: every
// piece of the window where it has at most kStage (their starts, arena_lo
// - start and t_offset); else the window's starts are searched in device
// memory.  A photon's piece is the last whose start is <= its index in
// the window (pieces without photons share their start with the next).
struct Pieces {
  long long start[kStage];
  long long delta[kStage];
  long long toff[kStage];
  // the segment inside one piece (the common case): its arena_lo - start
  // and t_offset, so that a photon's index is one add
  long long one_delta, one_toff;
  int one;
};

// photon j of the segment's window: its arena index and its piece's
// t_offset
__device__ __forceinline__ long long arena_index(const Batch& b,
                                                 const Segment& g,
                                                 const Pieces& sp, long long j,
                                                 long long& toff) {
  if (b.n_pieces <= kStage) {
    int lo = 0, hi = b.n_pieces;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (sp.start[mid] <= j) lo = mid; else hi = mid;
    }
    toff = sp.toff[lo];
    return sp.delta[lo] + j;
  }
  const long long* ps = b.pstart + static_cast<long long>(g.w) * b.n_pieces;
  int lo = 0, hi = b.n_pieces;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ps + mid) <= j) lo = mid; else hi = mid;
  }
  const long long* pc =
      b.pieces + (static_cast<long long>(g.w) * b.n_pieces + lo) * 3;
  toff = __ldg(pc + 2);
  return __ldg(pc) + (j - __ldg(ps + lo));
}

__device__ void stage_pieces(const Batch& b, const Segment& g, Pieces& sp) {
  // a piece start strictly inside the segment: more than one piece
  int inside = b.n_pieces > kStage;
  if (b.n_pieces <= kStage) {
    const long long row = static_cast<long long>(g.w) * b.n_pieces;
    for (int i = threadIdx.x; i < b.n_pieces; i += kThreads) {
      const long long* pc = b.pieces + (row + i) * 3;
      const long long st = __ldg(b.pstart + row + i);
      sp.start[i] = st;
      sp.delta[i] = __ldg(pc) - st;
      sp.toff[i] = __ldg(pc + 2);
      inside |= st > g.j0 && st < g.j0 + g.len;
    }
  }
  inside = __syncthreads_or(inside);
  if (threadIdx.x == 0) {
    sp.one = !inside && g.len > 0;
    if (sp.one) {
      long long toff;
      sp.one_delta = arena_index(b, g, sp, g.j0, toff) - g.j0;
      sp.one_toff = toff;
    }
  }
  __syncthreads();
}

// the segment's photons of this thread (slots q, see slot): channel (-1
// past the segment), time and, with kGain, gain; loads all issued before
// any is used
template <bool kGain>
__device__ __forceinline__ void load_photons(const Batch& b, const Segment& g,
                                             const Pieces& sp, int* chv,
                                             int* tv, float* gv);

// the segment's photon of thread slot q: index in the segment (warp w
// takes the contiguous run [w * 32 kPer, (w + 1) * 32 kPer), step q its
// photons w * 32 kPer + 32 q + lane)
__device__ __forceinline__ int slot(int q) {
  return (threadIdx.x >> 5) * (32 * kPer) + 32 * q + (threadIdx.x & 31);
}

template <bool kGain>
__device__ __forceinline__ void load_photons(const Batch& b, const Segment& g,
                                             const Pieces& sp, int* chv,
                                             int* tv, float* gv) {
  if (sp.one) {
    const long long a0 = sp.one_delta + g.j0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = min(slot(q), g.len - 1);
      chv[q] = __ldg(b.ch + a0 + i);
      tv[q] = __ldg(b.t + a0 + i);
      if (kGain) gv[q] = __ldg(b.gain + a0 + i);
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (slot(q) >= g.len) chv[q] = -1;
      tv[q] = shifted_time(tv[q], sp.one_toff);
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = slot(q);
    chv[q] = -1;
    tv[q] = 0;
    if (kGain) gv[q] = 0.0f;
    if (i < g.len) {
      long long toff;
      const long long a = arena_index(b, g, sp, g.j0 + i, toff);
      chv[q] = __ldg(b.ch + a);
      tv[q] = shifted_time(__ldg(b.t + a), toff);
      if (kGain) gv[q] = __ldg(b.gain + a);
    }
  }
}

// the lanes of the warp whose channel equals this lane's (-1 alike), as
// __match_any_sync(kFull, c) gives them, from one ballot a bit of the
// channel (11 bits: channels below 1,024 and -1)
__device__ __forceinline__ unsigned lanes_alike(int c) {
  unsigned same = kFull;
#pragma unroll
  for (int bit = 0; bit < 11; ++bit) {
    const bool on = (c >> bit) & 1;
    const unsigned m = __ballot_sync(kFull, on);
    same &= on ? m : ~m;
  }
  return same;
}

// the sum of v over the threads before this one, and the block's total
__device__ __forceinline__ int block_exclusive_scan(int v, int& total,
                                                    int* red) {
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
  total = 0;
  for (int i = 0; i < kWarps; ++i) {
    const int r = red[i];
    if (i < warp) before += r;
    total += r;
  }
  return before + incl - v;
}

// cnt[c] -> its exclusive prefix over the channels (thread t takes the
// channels t * per ..); returns the block's total in every thread
__device__ int channel_scan(int* cnt, int C, int* red) {
  const int per = (C + kThreads - 1) / kThreads;
  int v[kChPerThread];
  int mine = 0;
#pragma unroll
  for (int u = 0; u < kChPerThread; ++u) {
    const int c = threadIdx.x * per + u;
    v[u] = (u < per && c < C) ? cnt[c] : 0;
    mine += v[u];
  }
  int total;
  int off = block_exclusive_scan(mine, total, red);
#pragma unroll
  for (int u = 0; u < kChPerThread; ++u) {
    const int c = threadIdx.x * per + u;
    if (u < per && c < C) cnt[c] = off;
    off += v[u];
  }
  __syncthreads();
  return total;
}

// True in every thread of the one block that is the n-th to arrive at
// counter *ctr (after its writes are fenced); that block sets the counter
// back to 0, so every launch leaves the scratch as it found it
__device__ __forceinline__ bool last_to_arrive(unsigned* ctr, unsigned n,
                                               int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned prev = atomicAdd(ctr, 1u);
    *flag = prev == n - 1;
    if (prev == n - 1) *ctr = 0u;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// a row's extents from its minimum and maximum of t // dt
__device__ __forceinline__ void write_extents(
    long long row, int lo, int hi, int n_samples, int left_pad, int right_pad,
    int* ch_left, int* ch_right, unsigned char* has) {
  has[row] = hi >= lo ? 1 : 0;
  ch_left[row] = clamp_to(wrap_sub(lo, left_pad), n_samples - 1);
  ch_right[row] = clamp_to(wrap_add(hi, right_pad), n_samples - 1);
}

// Rows r0 .. r0 + n - 1 of the (rows, C) tables of counts, minima and
// maxima, at channel c (written by other blocks: read past L1): the
// counts become their exclusive prefix; returns their total, with the
// minimum lo and maximum hi
__device__ int scan_rows(int* v_tab, const int* lo_tab, const int* hi_tab,
                         int r0, int n, int C, int c, int& lo, int& hi) {
  int run = 0;
  lo = kBig;
  hi = -kBig;
  for (int q0 = 0; q0 < n; q0 += kScanLoads) {
    int v[kScanLoads], l[kScanLoads], h[kScanLoads];
#pragma unroll
    for (int q = 0; q < kScanLoads; ++q) {
      if (q0 + q < n) {
        const long long o = static_cast<long long>(r0 + q0 + q) * C + c;
        v[q] = __ldcg(v_tab + o);
        l[q] = __ldcg(lo_tab + o);
        h[q] = __ldcg(hi_tab + o);
      }
    }
#pragma unroll
    for (int q = 0; q < kScanLoads; ++q) {
      if (q0 + q < n) {
        v_tab[static_cast<long long>(r0 + q0 + q) * C + c] = run;
        run += v[q];
        lo = min(lo, l[q]);
        hi = max(hi, h[q]);
      }
    }
  }
  return run;
}

__global__ void __launch_bounds__(kThreads)
window_rows_count_kernel(Batch b, Tables tb, unsigned* __restrict__ ctr,
                         int n_samples, int left_pad, int right_pad,
                         int* __restrict__ ch_left, int* __restrict__ ch_right,
                         unsigned char* __restrict__ has) {
  extern __shared__ __align__(16) int sh[];
  __shared__ Pieces sp;
  __shared__ int red[kWarps];
  __shared__ int flag;
  const int C = b.n_ch;
  int* cnt = sh;
  int* mn = sh + C;
  int* mx = sh + 2 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    cnt[c] = 0;
    mn[c] = kBig;
    mx[c] = -kBig;
  }
  const int s = blockIdx.x;
  const Segment g = segment_of(b, s);
  stage_pieces(b, g, sp);      // ends in a barrier
  int chv[kPer], tv[kPer];
  load_photons<false>(b, g, sp, chv, tv, nullptr);
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int c = chv[q];
    if (c >= 0 && c < C) {
      const int v = floor_div(tv[q], b.dt);
      atomicAdd(cnt + c, 1);
      atomicMin(mn + c, v);
      atomicMax(mx + c, v);
    }
  }
  __syncthreads();
  const long long ro = static_cast<long long>(g.w) * C;
  // (ctr: a counter a group, then a window, then one for the batch)
  if (g.nw == 1) {
    // the window is this segment: its extents and total, no table
    for (int c = threadIdx.x; c < C; c += kThreads)
      write_extents(ro + c, mn[c], mx[c], n_samples, left_pad, right_pad,
                    ch_left, ch_right, has);
    const int total = channel_scan(cnt, C, red);
    if (threadIdx.x == 0) tb.wtot[g.w] = total;
  } else {
    const long long so = static_cast<long long>(s) * C;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      tb.sc[so + c] = cnt[c];
      tb.smn[so + c] = mn[c];
      tb.smx[so + c] = mx[c];
    }
    // the last segment of the group: the segments' counts become their
    // prefix within the group; the group's totals, minima and maxima
    if (!last_to_arrive(ctr + g.g, g.g_n, &flag)) return;
    const long long go = static_cast<long long>(g.g) * C;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      int l, h;
      tb.gc[go + c] = scan_rows(tb.sc, tb.smn, tb.smx, g.g_s0, g.g_n, C, c, l,
                                h);
      tb.gmn[go + c] = l;
      tb.gmx[go + c] = h;
    }
    // the last group of the window: the groups' totals become their
    // prefix within the window; each row's extents and offset
    if (!last_to_arrive(ctr + b.n_grp + g.w, g.w_gn, &flag)) return;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      int l, h;
      cnt[c] = scan_rows(tb.gc, tb.gmn, tb.gmx, g.w_g0, g.w_gn, C, c, l, h);
      write_extents(ro + c, l, h, n_samples, left_pad, right_pad, ch_left,
                    ch_right, has);
    }
    __syncthreads();
    const int total = channel_scan(cnt, C, red);
    for (int c = threadIdx.x; c < C; c += kThreads) tb.rowoff[ro + c] = cnt[c];
    if (threadIdx.x == 0) tb.wtot[g.w] = total;
  }

  // the last window: the windows' bases
  if (!last_to_arrive(ctr + b.n_grp + b.n_win, b.n_win, &flag)) return;
  int carry = 0;
  for (int w0 = 0; w0 < b.n_win; w0 += kThreads) {
    const int w = w0 + threadIdx.x;
    const int v = w < b.n_win ? __ldcg(tb.wtot + w) : 0;
    int sum;
    const int before = block_exclusive_scan(v, sum, red);
    if (w < b.n_win) tb.wbase[w] = carry + before;
    carry += sum;
  }
  if (threadIdx.x == 0) tb.wbase[b.n_win] = carry;
}

// the place pass's dynamic shared memory: the warps' counts (kWarps, C),
// each channel's first slot in the segment and its destination's offset
// (C each), then, from the next even word (the 8-byte pairs' alignment),
// the staged segment (kSeg (time, gain) pairs and kSeg destinations)
__host__ __device__ constexpr int place_staged_word(int C) {
  return ((kWarps + 2) * C + 1) & ~1;
}
__host__ __device__ constexpr int place_smem_words(int C) {
  return place_staged_word(C) + 3 * kSeg;
}

__global__ void __launch_bounds__(kThreads)
window_rows_place_kernel(Batch b, Tables tb, int n_out,
                         int* __restrict__ t_out, float* __restrict__ gain_out,
                         int* __restrict__ row_ptr) {
  extern __shared__ __align__(16) int sh[];
  __shared__ Pieces sp;
  __shared__ int red[kWarps];
  const int C = b.n_ch;
  int* wcnt = sh;                    // (kWarps, C)
  int* first = sh + kWarps * C;      // (C,) a channel's first slot here
  int* delta = first + C;            // (C,) its destination minus that slot
  int2* st_tg = reinterpret_cast<int2*>(sh + place_staged_word(C));
  int* st_pos = reinterpret_cast<int*>(st_tg + kSeg);          // (kSeg,)
  const int s = blockIdx.x;
  const Segment g = segment_of(b, s);
  for (int i = threadIdx.x; i < kWarps * C; i += kThreads) wcnt[i] = 0;
  const int wb = __ldg(tb.wbase + g.w);
  const int kept = __ldg(tb.wbase + b.n_win);
  const long long ro = static_cast<long long>(g.w) * C;
  // each channel's destination for this segment's first photon of it,
  // less the segment's slots before that photon's (set after the scan);
  // a window of one segment: its base
  if (g.nw == 1) {
    for (int c = threadIdx.x; c < C; c += kThreads) delta[c] = wb;
  } else {
    const long long go = static_cast<long long>(g.g) * C;
    const long long so = static_cast<long long>(s) * C;
    for (int c = threadIdx.x; c < C; c += kThreads)
      delta[c] = wb + __ldg(tb.rowoff + ro + c) + __ldg(tb.gc + go + c) +
                 __ldg(tb.sc + so + c);
  }
  // the slots past the kept photons: zero, shared among the blocks
  for (long long i = kept + static_cast<long long>(s) * kThreads + threadIdx.x;
       i < n_out; i += static_cast<long long>(b.n_seg) * kThreads) {
    t_out[i] = 0;
    gain_out[i] = 0.0f;
  }
  stage_pieces(b, g, sp);      // ends in a barrier
  int chv[kPer], tv[kPer];
  float gv[kPer];
  load_photons<true>(b, g, sp, chv, tv, gv);
  // each warp's counts of its run, by channel (order-free)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int* mine = wcnt + warp * C;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int c = chv[q];
    if (c >= 0 && c < C) atomicAdd(mine + c, 1);
    else chv[q] = -1;
  }
  __syncthreads();
  // a channel's count in the segment; the warps' counts become their
  // prefix within the channel
  for (int c = threadIdx.x; c < C; c += kThreads) {
    int run = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int v = wcnt[k * C + c];
      wcnt[k * C + c] = run;
      run += v;
    }
    first[c] = run;
  }
  __syncthreads();
  const int n_kept = channel_scan(first, C, red);
  // the warps' cursors: the channel's first slot in the segment plus the
  // counts of the warps before
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int f = first[c];
    if (g.k == 0)
      row_ptr[ro + c] = g.nw == 1 ? wb + f : wb + __ldg(tb.rowoff + ro + c);
    if (g.nw != 1) delta[c] -= f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) wcnt[k * C + c] += f;
  }
  if (g.k == 0 && g.w == b.n_win - 1 && threadIdx.x == 0)
    row_ptr[static_cast<long long>(b.n_win) * C] = kept;
  __syncthreads();
  // the segment in row order in shared memory: a photon's slot is its
  // warp's cursor for its channel plus its rank among the lower lanes of
  // its step; a window of one segment is one run from its base, a longer
  // one's slots keep their destinations
  const bool one_run = g.nw == 1;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int c = chv[q];
    const unsigned same = lanes_alike(c);
    if (c >= 0) {
      const int l = mine[c] + __popc(same & below);
      st_tg[l] = make_int2(tv[q], __float_as_int(gv[q]));
      if (!one_run) st_pos[l] = delta[c] + l;
    }
    __syncwarp();
    if (c >= 0 && (same & below) == 0) mine[c] += __popc(same);
    __syncwarp();
  }
  __syncthreads();
  for (int l = threadIdx.x; l < n_kept; l += kThreads) {
    const int pos = one_run ? wb + l : st_pos[l];
    const int2 v = st_tg[l];
    t_out[pos] = v.x;
    gain_out[pos] = __int_as_float(v.y);
  }
}

}  // namespace

// The batch's rows, all in one int32 buffer `work` carved in this order:
// t (n_out), gain (n_out, float32), row_ptr (B * C + 1), ch_left,
// ch_right (B * C), has (B * C bytes, padded to whole words), then the
// tables: sc, smn, smx (n_seg * C each), gc, gmn, gmx (n_grp * C each),
// rowoff (B * C), wtot (B), wbase (B + 1).  `table` is the host plan, one
// int64 array: pieces (B * P * 3), pstart (B * P), the segments' plans
// (n_seg * 6).  `ctr` is n_grp + B + 1 zeroed 32-bit words, left zero.
// seg_len must be the kernel's segment (kSeg).  left_pad / right_pad: what
// the extents subtract from the row's first sample and add to its last
// before the clip to [0, n_samples - 1].
extern "C" int wfsim_window_rows(
    const void* t, const void* ch, const void* gain, const void* table,
    int n_win, int n_pieces, int n_seg, int n_grp, int n_ch, int seg_len,
    int n_samples, int dt, int left_pad, int right_pad, int n_out,
    void* work, void* ctr, void* stream) {
  if (n_win <= 0 || n_seg < n_win || n_grp < 0 || n_ch <= 0 ||
      n_ch > kMaxChannels || n_pieces < 0 || n_samples <= 0 || dt <= 0 ||
      n_out < 0 || seg_len != kSeg)
    return static_cast<int>(cudaErrorInvalidValue);
  const int place_bytes = place_smem_words(n_ch) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      window_rows_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      place_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long R = static_cast<long long>(n_win) * n_ch;
  Batch b;
  b.t = static_cast<const int*>(t);
  b.ch = static_cast<const int*>(ch);
  b.gain = static_cast<const float*>(gain);
  b.pieces = static_cast<const long long*>(table);
  b.pstart = b.pieces + 3LL * n_win * n_pieces;
  b.plan = b.pstart + static_cast<long long>(n_win) * n_pieces;
  b.n_win = n_win;
  b.n_pieces = n_pieces;
  b.n_seg = n_seg;
  b.n_grp = n_grp;
  b.n_ch = n_ch;
  b.dt = dt;
  int* w = static_cast<int*>(work);
  int* t_out = w;
  float* gain_out = reinterpret_cast<float*>(w + n_out);
  int* row_ptr = w + 2LL * n_out;
  int* ch_left = row_ptr + R + 1;
  int* ch_right = ch_left + R;
  unsigned char* has = reinterpret_cast<unsigned char*>(ch_right + R);
  Tables tb;
  tb.sc = ch_right + R + (R + 3) / 4;
  tb.smn = tb.sc + static_cast<long long>(n_seg) * n_ch;
  tb.smx = tb.smn + static_cast<long long>(n_seg) * n_ch;
  tb.gc = tb.smx + static_cast<long long>(n_seg) * n_ch;
  tb.gmn = tb.gc + static_cast<long long>(n_grp) * n_ch;
  tb.gmx = tb.gmn + static_cast<long long>(n_grp) * n_ch;
  tb.rowoff = tb.gmx + static_cast<long long>(n_grp) * n_ch;
  tb.wtot = tb.rowoff + R;
  tb.wbase = tb.wtot + n_win;
  window_rows_count_kernel<<<n_seg, kThreads, 3 * n_ch * sizeof(int), st>>>(
      b, tb, static_cast<unsigned*>(ctr), n_samples, left_pad, right_pad,
      ch_left, ch_right, has);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_rows_place_kernel<<<n_seg, kThreads, place_bytes, st>>>(
      b, tb, n_out, t_out, gain_out, row_ptr);
  return static_cast<int>(cudaGetLastError());
}
