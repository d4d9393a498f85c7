// zle_intervals: zero-length-encoding interval search per channel row.
//
// Replaces: wfsim_tpu/ops/zle.py:30 find_intervals and :119
// zle_all_channels (reference semantics: wfsim/utils.py:14-58 and
// wfsim/core/rawdata.py:274-311; oracles tests/reference_semantics.py:11-29
// and native/fastpath.c:find_intervals).
//
// What bounds it on the H100: one read of each in-window int16 sample and a
// scan whose state (inside an interval, last below-threshold sample) runs
// from sample to sample.  The TPU form made the scan data-parallel with a
// cumulative sum, four shifted window sums and a block compression, all
// through HBM.  Here one warp owns one row and lane 0 runs the reference's
// sequential holdoff rule over data[row, ch_left..ch_right]: one pass, no
// intermediate arrays, and the row's samples stay in L1 for the loop.  The
// other lanes idle; the rows (B*494 of them) fill the card.
//
// Output, bitwise equal to zle_all_channels: the first K intervals, padded
// by +-trigger_window, clipped to the row window, starts rounded up and ends
// down to even offsets, relative to ch_left.  Unused slots carry the same
// values JAX gives its sentinels (start 2^30, end -2^30 before the shift,
// clip and rounding), so the whole (rows, K) arrays compare bitwise; the
// count is capped at K and 0 for rows without photons.
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

namespace {

constexpr int kBig = 1 << 30;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  x = x > lo ? x : lo;   // jnp.clip: maximum with lo, then minimum with hi
  return x < hi ? x : hi;
}

__device__ __forceinline__ int floor_half(int x) {
  return x >= 0 ? x / 2 : -((1 - x) / 2);
}

__global__ void zle_intervals_kernel(
    const short* __restrict__ data, int n_rows, int n_samples,
    const int* __restrict__ thresholds, const int* __restrict__ ch_left,
    const int* __restrict__ ch_right, const unsigned char* __restrict__ has,
    int holdoff, int trigger_window, int max_intervals, int nonneg,
    int* __restrict__ starts, int* __restrict__ ends, int* __restrict__ counts) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= n_rows || (threadIdx.x & 31) != 0) return;

  const int left = ch_left[row];
  const int right = ch_right[row];
  const int hi = right - left;  // length - 1
  const int K = max_intervals;
  int* st = starts + static_cast<long long>(row) * K;
  int* en = ends + static_cast<long long>(row) * K;

  int n = 0;
  if (has[row]) {
    const short* d = data + static_cast<long long>(row) * n_samples;
    const int thr = thresholds[row];
    bool inside = false;
    int s = -1, e = -1;
    for (int i = left; i <= right; ++i) {
      const int x = d[i];
      const bool below = x < thr && (nonneg == 0 || x >= 0);
      if (below) {
        if (!inside) { inside = true; s = i; }
        e = i;
      }
      if (inside && (i == right || (!below && i >= e + holdoff))) {
        inside = false;
        if (n < K) {
          st[n] = floor_half(clip(s - left - trigger_window, 0, hi) + 1) * 2;
          en[n] = floor_half(clip(e - left + trigger_window, 0, hi)) * 2;
        }
        ++n;
      }
    }
  }
  const int cnt = n < K ? n : K;
  const int s_pad = floor_half(clip(kBig - left - trigger_window, 0, hi) + 1) * 2;
  const int e_pad = floor_half(clip(-kBig - left + trigger_window, 0, hi)) * 2;
  for (int k = cnt; k < K; ++k) {
    st[k] = s_pad;
    en[k] = e_pad;
  }
  counts[row] = cnt;
}

}  // namespace

extern "C" int wfsim_zle_intervals(
    const void* data, int n_rows, int n_samples, const void* thresholds,
    const void* ch_left, const void* ch_right, const void* has, int holdoff,
    int trigger_window, int max_intervals, int nonneg, void* starts,
    void* ends, void* counts, void* stream) {
  if (n_rows <= 0 || max_intervals <= 0) return static_cast<int>(cudaErrorInvalidValue);
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
