// zle_intervals: zero-length-encoding interval search per channel row.
//
// Replaces: wfsim_tpu/ops/zle.py:30 find_intervals and :119
// zle_all_channels (reference semantics: wfsim/utils.py:14-58 and
// wfsim/core/rawdata.py:274-311; oracles tests/reference_semantics.py:11-29
// and native/fastpath.c:find_intervals).
//
// What bounds it on the H100: one read of each in-window int16 sample and
// the write of the (rows, K) start and end slots; then the instructions
// that turn samples into intervals.  The TPU form made the scan
// data-parallel with a cumulative sum, four shifted window sums and a
// block compression, all through HBM.  Here one warp owns one row and all
// 32 lanes work on it, with no intermediate arrays:
//
// - The warp walks [ch_left, ch_right] in steps of 1,024 samples; each
//   lane loads 32 consecutive samples as four 16-byte loads where they lie
//   inside the window (the groups are laid on the row's 16-byte
//   boundaries, so every such load is aligned, also on rows of an odd
//   length) and sample by sample at the window's two ends, and turns them
//   into one 32-bit mask of below-threshold samples.  A step without a
//   below sample (one ballot) costs nothing more.  The per-step work
//   (ballots, shuffles, ranks) is shared by 1,024 samples: the kernel
//   issues few instructions a sample.
// - The reference's sequential rule closes an interval at the first sample
//   i that is not below with i >= e + holdoff, e the last below sample; so
//   for holdoff >= 1 (the callers pass 2 * trigger_window + 1) two below
//   samples join one interval exactly when their distance is at most
//   holdoff.  That is the twin's rule for every holdoff >= 0 (ops/zle.py:
//   no below sample in the holdoff samples before a start, none in those
//   after an end), which the kernel follows.  A lane's first below sample
//   has as predecessor the last below sample of the nearest lane below it
//   that has one (a ballot and one shuffle), or the carry of the earlier
//   steps; a below sample more than holdoff past its predecessor (or
//   without one) starts an interval.  Inside a lane that is a below bit
//   with no below bit among the min(holdoff, 31) bits before it (a
//   shift-or of the mask, five uniform steps), and the lane's first below
//   bit when its predecessor lies more than holdoff back; one path for
//   every holdoff.  The starts are ranked by a warp prefix sum.
// - The end of interval k is the predecessor of start k + 1, or the last
//   below sample of the window: nothing looks ahead, for any holdoff.
// - The first K starts are written with the twin's padding, clip and even
//   rounding, and the walk stops once start K + 1 is found (the count is
//   capped at K and the K-th end is known then).
//
// Output, bitwise equal to zle_all_channels_ref: the first K intervals,
// padded by +-trigger_window, clipped to the row window, starts rounded up
// and ends down to even offsets, relative to ch_left.  Unused slots carry
// the same values JAX gives its sentinels (start 2^30, end -2^30 before the
// shift, clip and rounding), written by all lanes; the count is capped at K
// and 0 for rows without photons, which read no sample.
//
// nonneg (the full digitizer grid): wfsim_tpu runs ZLE there on the int32
// grid before its int16 cast (digitize.py:409-435), where every in-window
// value is >= 0 after the clip.  A negative int16 sample in the window is
// then the wrap of a value in [2^15, 2^16), which is never below a
// threshold, so with nonneg set a sample is below only if 0 <= x < thr.
// (Values >= 2^16 are refused before this kernel: superpose_adc_full
// raises.)  On the slim grid wfsim_tpu casts first and compares the int16
// samples, which is the plain x < thr.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kNone = -(1 << 30);      // "no below sample before this one"
constexpr int kWarpsPerBlock = 4;
constexpr int kVec = 8;                // samples a 16-byte load holds
constexpr int kLoads = 4;              // 16-byte loads a lane makes a step
constexpr int kLane = kVec * kLoads;   // samples a lane scans a step (32)
constexpr int kStep = 32 * kLane;      // samples a warp walks a step (1024)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  x = x > lo ? x : lo;   // jnp.clip: maximum with lo, then minimum with hi
  return x < hi ? x : hi;
}

__device__ __forceinline__ int floor_half(int x) {
  return x >= 0 ? x / 2 : -((1 - x) / 2);
}

// Samples row[g .. g + 7] as int16 pairs (sample j in the low half of word
// j / 2 for even j, the high half for odd j); row + g is 16-byte aligned.
// A group inside [lo, hi] is one 16-byte load, a group that straddles lo or
// hi reads its samples in [lo, hi] one by one (the rest read as 0), a group
// outside reads nothing.
__device__ __forceinline__ int4 load_vec(const short* __restrict__ row,
                                         int g, int lo, int hi) {
  if (g >= lo && g + kVec - 1 <= hi)
    return __ldg(reinterpret_cast<const int4*>(row + g));
  int w[4] = {0, 0, 0, 0};
  if (g + kVec - 1 >= lo && g <= hi) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (g + j >= lo && g + j <= hi) {
        const unsigned v = static_cast<unsigned short>(__ldg(row + g + j));
        w[j >> 1] |= static_cast<int>((j & 1) ? v << 16 : v);
      }
    }
  }
  return make_int4(w[0], w[1], w[2], w[3]);
}

// A lane's kLane samples of a step: kLoads 16-byte groups from g
struct Lane {
  int4 v[kLoads];
};

__device__ __forceinline__ Lane load_lane(const short* __restrict__ row,
                                          int g, int lo, int hi) {
  Lane x;
#pragma unroll
  for (int u = 0; u < kLoads; ++u) x.v[u] = load_vec(row, g + u * kVec, lo, hi);
  return x;
}

// The below-threshold flags (bit j: sample j) of a lane's kLane samples: x <
// thr on the int16 samples, or with kUnsigned on the samples read as
// uint16 (nonneg: the wrap of a value in [2^15, 2^16) reads back as that
// value) against min(thr, 2^15), which is 0 <= x < thr on the int16 ones.
template <bool kUnsigned>
__device__ __forceinline__ unsigned below_bits(const Lane& x, int thr) {
  unsigned bits = 0;
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int w[4] = {x.v[u].x, x.v[u].y, x.v[u].z, x.v[u].w};
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int word = w[j >> 1];
      int s;
      if (kUnsigned)
        s = (j & 1) ? static_cast<int>(static_cast<unsigned>(word) >> 16)
                    : (word & 0xffff);
      else
        s = (j & 1) ? (word >> 16)
                    : static_cast<int>(static_cast<short>(word & 0xffff));
      bits |= static_cast<unsigned>(s < thr) << (u * kVec + j);
    }
  }
  return bits;
}

// bits j with a bit of x among bits j - h .. j - 1 (0 <= h <= 31): the
// OR of x << s for s = 1 .. h, built from the binary digits of h
__device__ __forceinline__ unsigned covered(unsigned x, int h) {
  unsigned f = 0;  // OR of x << s for s in [0, done)
  unsigned p = x;  // OR of x << s for s in [0, w)
  int done = 0;
#pragma unroll
  for (int w = 1; w <= 16; w <<= 1) {
    if (h & w) {
      f |= p << done;
      done += w;
    }
    p |= p << w;
  }
  return f << 1;
}

// bits j of a lane's samples from g with lo <= g + j <= hi
__device__ __forceinline__ unsigned window_bits(int g, int lo, int hi) {
  unsigned m = kFull >> (32 - kLane);   // the lane's kLane samples
  if (g < lo) m = lo - g >= kLane ? 0u : m & (kFull << (lo - g));
  const int past = g + kLane - 1 - hi;  // samples past hi
  if (past > 0) m = past >= kLane ? 0u : m & (kFull >> (32 - kLane + past));
  return m;
}

__global__ void zle_intervals_kernel(
    const short* __restrict__ data, int n_rows, int n_samples,
    const int* __restrict__ thresholds, const int* __restrict__ ch_left,
    const int* __restrict__ ch_right, const unsigned char* __restrict__ has,
    int holdoff, int trigger_window, int max_intervals, int nonneg,
    int* __restrict__ starts, int* __restrict__ ends, int* __restrict__ counts) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= n_rows) return;            // whole warps only
  const int lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;

  // the row's four inputs in one round trip
  const int left = ch_left[row];
  const int right = ch_right[row];
  const bool active = has[row];
  const int thr_in = thresholds[row];
  const int hi = right - left;  // length - 1
  const int K = max_intervals;
  const int tw = trigger_window;
  int* st = starts + static_cast<long long>(row) * K;
  int* en = ends + static_cast<long long>(row) * K;

  int n = 0;  // starts found so far (the same in every lane)
  if (active) {
    const short* d = data + static_cast<long long>(row) * n_samples;
    const int thr = nonneg ? min(thr_in, 1 << 15) : thr_in;
    const int lo = left > 0 ? left : 0;
    const int top = right < n_samples - 1 ? right : n_samples - 1;
    // a below bit's predecessor inside the lane lies at most kLane - 1
    // bits back
    const int h = holdoff < kLane - 1 ? holdoff : kLane - 1;
    // the first group starts on the last 16-byte boundary at or before lo
    const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(d) >> 1) & 7);
    const int g0 = lo - ((lo + phase) & 7);
    int carry = kNone;  // the last below sample of the earlier steps
    for (int base = g0; base <= top; base += kStep) {
      const int g = base + lane * kLane;
      const Lane cur = load_lane(d, g, lo, top);
      const unsigned below = (nonneg ? below_bits<true>(cur, thr)
                                     : below_bits<false>(cur, thr)) &
                             window_bits(g, lo, top);
      const unsigned with_below = __ballot_sync(kFull, below);
      if (with_below == 0) continue;

      // the previous below sample before this lane's samples: the last
      // one of the nearest lane below with one, or the carry
      const int last = below ? g + 31 - __clz(below) : kNone;
      const unsigned before = with_below & lanes_below;
      const int from = __shfl_sync(kFull, last, before ? 31 - __clz(before) : 0);
      const int prev = before ? from : carry;
      carry = __shfl_sync(kFull, last, 31 - __clz(with_below));

      // starts: below samples more than holdoff past their predecessor;
      // the lane's first below bit is one unless prev lies too close
      unsigned sbits = below & ~covered(below, h);
      if (below && g + __ffs(below) - 1 - prev <= holdoff)
        sbits &= ~(below & (0u - below));
      if (__ballot_sync(kFull, sbits) == 0) continue;

      // rank the starts: a warp prefix sum of the lanes' counts
      const int c = __popc(sbits);
      int csum = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, csum, o);
        if (lane >= o) csum += y;
      }
      int k = n + csum - c;
      const int total = __shfl_sync(kFull, csum, 31);
      for (unsigned s = sbits; s; s &= s - 1) {
        const int j = __ffs(s) - 1;
        if (k < K)
          st[k] = floor_half(clip(g + j - left - tw, 0, hi) + 1) * 2;
        if (k >= 1 && k <= K) {
          // interval k - 1 ends at this start's predecessor
          const unsigned lower = below & ((1u << j) - 1u);
          const int e = lower ? g + 31 - __clz(lower) : prev;
          en[k - 1] = floor_half(clip(e - left + tw, 0, hi)) * 2;
        }
        ++k;
      }
      n += total;
      if (n > K) break;
    }
    // the last interval ends at the window's last below sample
    if (lane == 0 && n >= 1 && n <= K)
      en[n - 1] = floor_half(clip(carry - left + tw, 0, hi)) * 2;
  }
  const int cnt = n < K ? n : K;
  const int s_pad = floor_half(clip(kBig - left - tw, 0, hi) + 1) * 2;
  const int e_pad = floor_half(clip(-kBig - left + tw, 0, hi)) * 2;
  for (int k = cnt + lane; k < K; k += 32) {
    st[k] = s_pad;
    en[k] = e_pad;
  }
  if (lane == 0) counts[row] = cnt;
}

}  // namespace

extern "C" int wfsim_zle_intervals(
    const void* data, int n_rows, int n_samples, const void* thresholds,
    const void* ch_left, const void* ch_right, const void* has, int holdoff,
    int trigger_window, int max_intervals, int nonneg, void* starts,
    void* ends, void* counts, void* stream) {
  if (n_rows <= 0 || max_intervals <= 0 || holdoff < 0 ||
      (reinterpret_cast<uintptr_t>(data) & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  zle_intervals_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const short*>(data), n_rows, n_samples,
      static_cast<const int*>(thresholds), static_cast<const int*>(ch_left),
      static_cast<const int*>(ch_right), static_cast<const unsigned char*>(has),
      holdoff, trigger_window, max_intervals, nonneg, static_cast<int*>(starts),
      static_cast<int*>(ends), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}
