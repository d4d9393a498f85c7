// pack_records: ZLE intervals -> strax 110-sample record rows.
//
// Replaces: wfsim_tpu/pipeline/digitize.py:471 pack_records (the dense
// form; the JAX production path ships the encoded pack_records_accumulate,
// which the port leaves out).
//
// What bounds it on the H100: the gather of each record's 110 int16 samples
// from the grid and the store of the (R, 110) int16 payload plus its
// (R, 6) int32 meta.  The TPU form searched the interval cumsum for every
// record with one vectorised searchsorted and gathered all R x 110 samples
// through an index array in HBM.  Here one block owns one record: thread 0
// binary-searches the record's interval in the cumsum (found in shared
// memory by the rest), then 110 threads copy neighbouring samples
// (coalesced reads of one grid row, coalesced writes of one record row) and
// zero the tail.  No index array is materialised.
//
// The wrapper computes, with torch, the per-interval record count, its
// inclusive cumsum and each interval's grid-relative start; the output is
// bitwise equal to JAX pack_records' first R rows, in its natural
// (window, channel, interval, record_i) order.
#include <cuda_runtime.h>

namespace {

constexpr int kSpr = 110;
constexpr int kThreads = 128;

__global__ void pack_records_kernel(
    const short* __restrict__ data, int n_samples, int n_channels, int max_intervals,
    const int* __restrict__ left_rel, const int* __restrict__ plen,
    const int* __restrict__ csum, int n_itv, int n_records,
    short* __restrict__ rec_data, int* __restrict__ rec_meta) {
  const int r = blockIdx.x;
  if (r >= n_records) return;
  __shared__ int sh_itv;
  if (threadIdx.x == 0) {
    // searchsorted(csum, r, side='right'): first interval whose cumsum > r
    int lo = 0, hi = n_itv;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (csum[mid] > r) hi = mid; else lo = mid + 1;
    }
    sh_itv = lo < n_itv - 1 ? lo : n_itv - 1;
  }
  __syncthreads();
  const int itv = sh_itv;
  const int base = itv > 0 ? csum[itv - 1] : 0;
  const int record_i = r - base;
  const int w = itv / (n_channels * max_intervals);
  const int c = (itv / max_intervals) % n_channels;
  const int pl = plen[itv];
  const int start_s = left_rel[itv] + record_i * kSpr;
  int length = pl - record_i * kSpr;
  length = length < 0 ? 0 : (length > kSpr ? kSpr : length);

  const int j = threadIdx.x;
  if (j < kSpr) {
    short v = 0;
    if (j < length) {
      int col = start_s + j;
      col = col < 0 ? 0 : (col > n_samples - 1 ? n_samples - 1 : col);
      v = data[(static_cast<long long>(w) * n_channels + c) * n_samples + col];
    }
    rec_data[static_cast<long long>(r) * kSpr + j] = v;
  } else if (j == kSpr) {
    int* m = rec_meta + static_cast<long long>(r) * 6;
    m[0] = w;
    m[1] = c;
    m[2] = start_s;
    m[3] = length;
    m[4] = pl;
    m[5] = record_i;
  }
}

}  // namespace

extern "C" int wfsim_pack_records(
    const void* data, int n_samples, int n_channels, int max_intervals,
    const void* left_rel, const void* plen, const void* csum, int n_itv,
    int n_records, void* rec_data, void* rec_meta, void* stream) {
  if (n_records <= 0 || n_itv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  pack_records_kernel<<<n_records, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const short*>(data), n_samples, n_channels, max_intervals,
      static_cast<const int*>(left_rel), static_cast<const int*>(plen),
      static_cast<const int*>(csum), n_itv, n_records,
      static_cast<short*>(rec_data), static_cast<int*>(rec_meta));
  return static_cast<int>(cudaGetLastError());
}
