// pack_records: ZLE intervals -> strax 110-sample record rows.
//
// Replaces: wfsim_tpu/pipeline/digitize.py:471 pack_records (the dense
// form; the JAX production path ships the encoded pack_records_accumulate,
// which the port leaves out).
//
// What bounds it on the H100: the read of each record's samples from the
// grid and the store of the (R, 110) int16 payload plus its (R, 6) int32
// meta, and the read of the interval slots in use; at the bench batch's
// size, the fixed cost of the count pass, the scan and the read-back.
// The TPU form took a cumulative sum over every interval slot (B x rows x
// K) and searched it for every record with one vectorised searchsorted,
// then gathered all R x 110 samples through an index array in HBM.  Here the plan is per
// row, and no record searches for its interval:
//
// 1. wfsim_pack_record_counts: a warp a grid row reads its count and its
//    first `count` starts and ends and writes the row's record count,
//    sum ceil(plen / 110) (plen = end - start + 1);
// 2. the wrapper takes one torch.cumsum over the rows' counts and reads
//    the total back once, to size the output;
// 3. wfsim_pack_records: a warp a row gives its intervals their first
//    records by a warp prefix sum and copies all of them in one pass.  An
//    interval of nrec records is one contiguous block of nrec x 110 output
//    samples whose sample f is grid sample left + start + f (clipped to
//    the row) for f < plen and 0 past it, and the row's blocks follow one
//    another, so each lane takes int16 pairs of the row's output in turn
//    (coalesced 32-bit stores), finds the pair's interval in a table in
//    shared memory (a cursor that only moves forward) and loads four
//    pairs before it stores them.  The meta words [w, c, start, length,
//    pulse_length, record_i] are written the same way.
//
// Records come out in the twin's (window, row, interval, record_i) order:
// the output is bitwise pack_records_ref's, the first R rows of wfsim_tpu's
// pack_records.
//
// wfsim_record_rows (K4r) lays a round's records out as strax raw_record
// rows in their sorted slots.
//
// Replaces: the per-round record fill of wfsim_tpu/pipeline/rawdata.py:1785-1818
// (_collect_digitize_work: one np.lexsort((C, S, W)), then every record's
// header and samples written into its sorted slot of the host arena; a
// host loop there, not a TPU kernel).  The order comes from
// round_order.cu; this kernel writes output row i from record perm[i]:
// the 244-byte row of raw_record_dtype(110) as 61 32-bit words, [time
// (int64), length, dt | channel << 16, pulse_length, record_i | baseline
// << 16, the 110 samples as 55 pairs], time = (win_left[win[r]] + start)
// * dt and baseline 0.  The records stay in their digitize batches'
// (rec_data, rec_meta) pairs, read through a table of the batches'
// pointers and first records: the round's samples are not copied into
// one tensor first.
//
// What bounds it on the H100: bytes.  The records' samples and meta, the
// window and the permutation read once, the rows written once.  The first
// design (a warp a row: perm, then the source row, then win and win_left
// in a chain of dependent loads, two 4-byte words a lane) kept too few
// bytes in flight and ran at 45 % of that bound (NVIDIA H100 80GB HBM3,
// 700.00 W).  Here a block takes a
// tile of kTileRows consecutive output rows: its threads load the tile's
// perm entries at once (coalesced) and find each record's batch in a
// shared copy of the table; then every thread loads its share of the
// tile's samples (kDataLoads independent 4-byte loads, all in flight
// before the first store) while the tile's headers are built beside them;
// the tile, staged in shared memory, is written with 16-byte stores (4
// rows are 976 bytes, 61 x 16, and a tile starts at a multiple of 4 rows).
// The output is bitwise record_rows_ref's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSpr = 110;
constexpr int kWarpsPerBlock = 4;
constexpr int kUnroll = 4;   // int16 pairs a lane loads before it stores
constexpr unsigned kFull = 0xffffffffu;

// torch.div(plen + 109, 110, rounding_mode='floor')
__device__ __forceinline__ int records_of(int plen) {
  const int a = plen + kSpr - 1;
  return a >= 0 ? a / kSpr : -((kSpr - 1 - a) / kSpr);
}

// the row's intervals in use: count clamped to [0, K] (the twin's
// arange(K) < counts)
__device__ __forceinline__ int n_intervals(const int* __restrict__ counts,
                                           int row, int K) {
  const int n = counts[row];
  return n < 0 ? 0 : (n > K ? K : n);
}

__global__ void record_counts_kernel(
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ counts, int n_rows, int max_intervals,
    int* __restrict__ row_records) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int K = max_intervals;
  const int n = n_intervals(counts, row, K);
  const long long off = static_cast<long long>(row) * K;
  int sum = 0;
  for (int k = lane; k < n; k += 32)
    sum += records_of(ends[off + k] - starts[off + k] + 1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  if (lane == 0) row_records[row] = sum;
}

__global__ void pack_records_kernel(
    const short* __restrict__ data, int n_samples, int n_channels,
    int max_intervals, const int* __restrict__ left_all,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ counts, const int* __restrict__ row_csum,
    int n_rows, short* __restrict__ rec_data, int* __restrict__ rec_meta) {
  // a warp's table of 32 intervals, in the chunk's sample coordinates
  // (chunk sample f = 110 x the chunk's record + its sample): the
  // interval's first pair (entry 32: the chunk's pairs), the grid sample
  // of chunk sample 0 (left + start - 110 x first record) and the chunk
  // sample where its zero tail begins (plen + 110 x first record)
  __shared__ int sh_pair[kWarpsPerBlock][33];
  __shared__ int sh_base[kWarpsPerBlock][32];
  __shared__ int sh_end[kWarpsPerBlock][32];
  const int wid = threadIdx.x / 32;
  const int row = blockIdx.x * kWarpsPerBlock + wid;
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int K = max_intervals;
  const int n = n_intervals(counts, row, K);
  if (n == 0) return;
  const int w = row / n_channels;
  const int c = row - w * n_channels;
  const int left = left_all[row];
  const short* d = data + static_cast<long long>(row) * n_samples;
  const int* st = starts + static_cast<long long>(row) * K;
  const int* en = ends + static_cast<long long>(row) * K;
  long long rec = row > 0 ? row_csum[row - 1] : 0;  // the chunk's first record
  const int t_max = n_samples - 1;
  int* tab_pair = sh_pair[wid];
  int* tab_base = sh_base[wid];
  int* tab_end = sh_end[wid];

  for (int k0 = 0; k0 < n; k0 += 32) {
    // lane i holds interval k0 + i: its grid start, length, records
    const int k = k0 + lane;
    int lrel = 0, plen = 0, nrec = 0;
    if (k < n) {
      const int s = st[k];
      lrel = left + s;
      plen = en[k] - s + 1;
      nrec = records_of(plen);
    }
    int incl = nrec;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    const int first = incl - nrec;
    tab_pair[lane] = first * (kSpr / 2);
    tab_base[lane] = lrel - first * kSpr;
    tab_end[lane] = plen + first * kSpr;
    if (lane == 0) tab_pair[32] = total * (kSpr / 2);
    __syncwarp();

    // the payload: the chunk's records, total x 55 int16 pairs, in one
    // pass; kUnroll pairs a lane, all loaded before any is stored (grid
    // samples clipped to the row, 0 past the pulse)
    unsigned* out = reinterpret_cast<unsigned*>(rec_data) + rec * (kSpr / 2);
    const int n_pairs = total * (kSpr / 2);
    int cur = 0;  // the interval of the lane's current pair
    for (int p0 = lane; p0 < n_pairs; p0 += 32 * kUnroll) {
      unsigned v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + 32 * u;
        v[u] = 0u;
        if (p < n_pairs) {
          while (tab_pair[cur + 1] <= p) ++cur;
          const int f = 2 * p;
          const int src = tab_base[cur] + f;
          const int end = tab_end[cur];
          const int c0 = min(max(src, 0), t_max);
          const int c1 = min(max(src + 1, 0), t_max);
          const unsigned v0 = f < end ? static_cast<unsigned short>(__ldg(d + c0)) : 0u;
          const unsigned v1 = f + 1 < end ? static_cast<unsigned short>(__ldg(d + c1)) : 0u;
          v[u] = v0 | (v1 << 16);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p0 + 32 * u < n_pairs) out[p0 + 32 * u] = v[u];
    }
    // the meta: total x 6 words
    int* meta = rec_meta + rec * 6;
    cur = 0;
    for (int f = lane; f < total * 6; f += 32) {
      const int r = f / 6;
      const int q = f - 6 * r;
      while (tab_pair[cur + 1] <= r * (kSpr / 2)) ++cur;
      // this record's sample 0 in chunk coordinates is 110 r
      const int li = tab_base[cur] + r * kSpr;       // its grid start
      const int first = tab_pair[cur] / (kSpr / 2);  // the interval's first
      const int pi = tab_end[cur] - first * kSpr;
      const int ri = r - first;
      const int len = min(max(pi - ri * kSpr, 0), kSpr);
      meta[f] = q == 0 ? w : q == 1 ? c : q == 2 ? li
              : q == 3 ? len : q == 4 ? pi : ri;
    }
    rec += total;
    __syncwarp();  // the table is read before the next chunk writes it
  }
}

constexpr int kMetaWords = 6;
constexpr int kRowWords = 61;     // raw_record_dtype(110).itemsize / 4
constexpr int kHeadWords = 6;     // the row's header before its samples
static_assert(kHeadWords + kSpr / 2 == kRowWords, "raw_record row layout");

constexpr int kTileRows = 32;           // output rows a block of K4r
constexpr int kRowThreads = 256;
constexpr int kDataWords = kSpr / 2;     // 55 sample pairs a row
constexpr int kDataLoads =
    (kTileRows * kDataWords + kRowThreads - 1) / kRowThreads;
constexpr int kStagedBatches = 64;       // batches whose table is staged
static_assert(kTileRows % 4 == 0, "tiles of whole 16-byte groups of rows");

// the batch of record g: the last whose first record is <= g
__device__ __forceinline__ int batch_of(const long long* first, int n_batch,
                                        long long g) {
  int lo = 0, hi = n_batch;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (first[mid] <= g) lo = mid; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kRowThreads)
record_rows_kernel(const long long* __restrict__ table, int n_batch,
                   const int* __restrict__ win,
                   const long long* __restrict__ win_left,
                   const long long* __restrict__ perm, int n, int dt,
                   unsigned* __restrict__ out) {
  __shared__ __align__(16) unsigned tile[kTileRows * kRowWords];
  __shared__ const unsigned* src[kTileRows];
  __shared__ const int* src_meta[kTileRows];
  __shared__ long long rec[kTileRows];
  __shared__ long long first[kStagedBatches + 1];
  // table: (n_batch + 1) first records, then each batch's rec_data and
  // rec_meta pointers
  const long long* tfirst = table;
  const long long* tdata = table + n_batch + 1;
  const long long* tmeta = tdata + n_batch;
  const bool staged = n_batch <= kStagedBatches;
  if (staged)
    for (int i = threadIdx.x; i <= n_batch; i += kRowThreads)
      first[i] = __ldg(tfirst + i);
  const long long row0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const int nr = static_cast<int>(min(static_cast<long long>(kTileRows),
                                      n - row0));
  __syncthreads();
  if (threadIdx.x < nr) {
    const long long g = __ldg(perm + row0 + threadIdx.x);
    const int j = staged ? batch_of(first, n_batch, g)
                         : batch_of(tfirst, n_batch, g);
    const long long loc = g - (staged ? first[j] : __ldg(tfirst + j));
    src[threadIdx.x] = reinterpret_cast<const unsigned*>(__ldg(tdata + j)) +
                       loc * kDataWords;
    src_meta[threadIdx.x] =
        reinterpret_cast<const int*>(__ldg(tmeta + j)) + loc * kMetaWords;
    rec[threadIdx.x] = g;
  }
  __syncthreads();
  // the samples: kDataLoads words a thread, all loaded before any is
  // staged
  unsigned v[kDataLoads];
#pragma unroll
  for (int u = 0; u < kDataLoads; ++u) {
    const int i = threadIdx.x + u * kRowThreads;
    const int r = i / kDataWords;
    v[u] = r < nr ? __ldg(src[r] + (i - r * kDataWords)) : 0u;
  }
  // the headers, a thread a row
  if (threadIdx.x < nr) {
    const int* m = src_meta[threadIdx.x];
    const int2 m01 = __ldg(reinterpret_cast<const int2*>(m));
    const int2 m23 = __ldg(reinterpret_cast<const int2*>(m + 2));
    const int2 m45 = __ldg(reinterpret_cast<const int2*>(m + 4));
    const long long t =
        (__ldg(win_left + __ldg(win + rec[threadIdx.x])) + m23.x) *
        static_cast<long long>(dt);
    unsigned* h = tile + threadIdx.x * kRowWords;
    h[0] = static_cast<unsigned>(t);
    h[1] = static_cast<unsigned>(static_cast<unsigned long long>(t) >> 32);
    h[2] = static_cast<unsigned>(m23.y);                      // length
    h[3] = static_cast<unsigned short>(dt)                    // dt
           | static_cast<unsigned>(static_cast<unsigned short>(m01.y)) << 16;
    h[4] = static_cast<unsigned>(m45.x);                      // pulse_length
    h[5] = static_cast<unsigned short>(m45.y);  // record_i, baseline 0
  }
#pragma unroll
  for (int u = 0; u < kDataLoads; ++u) {
    const int i = threadIdx.x + u * kRowThreads;
    const int r = i / kDataWords;
    if (r < nr) tile[r * kRowWords + kHeadWords + (i - r * kDataWords)] = v[u];
  }
  __syncthreads();
  // the tile's rows: 16-byte stores over whole groups of 4 rows, 4-byte
  // stores for a last partial group
  unsigned* o = out + row0 * kRowWords;
  const int words = nr * kRowWords;
  const int vec = (nr / 4) * kRowWords;    // 4 rows: kRowWords uint4
  for (int i = threadIdx.x; i < vec; i += kRowThreads)
    reinterpret_cast<uint4*>(o)[i] = reinterpret_cast<const uint4*>(tile)[i];
  for (int i = 4 * vec + threadIdx.x; i < words; i += kRowThreads)
    o[i] = tile[i];
}

int blocks_for(int n_rows) {
  return (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

}  // namespace

extern "C" int wfsim_pack_record_counts(
    const void* starts, const void* ends, const void* counts, int n_rows,
    int max_intervals, void* row_records, void* stream) {
  if (n_rows <= 0 || max_intervals <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  record_counts_kernel<<<blocks_for(n_rows), 32 * kWarpsPerBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(ends),
      static_cast<const int*>(counts), n_rows, max_intervals,
      static_cast<int*>(row_records));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wfsim_pack_records(
    const void* data, int n_samples, int n_channels, int max_intervals,
    const void* left_all, const void* starts, const void* ends,
    const void* counts, const void* row_csum, int n_rows, void* rec_data,
    void* rec_meta, void* stream) {
  if (n_rows <= 0 || max_intervals <= 0 || n_channels <= 0 ||
      n_samples <= 0 || (reinterpret_cast<uintptr_t>(rec_data) & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  pack_records_kernel<<<blocks_for(n_rows), 32 * kWarpsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const short*>(data), n_samples, n_channels, max_intervals,
      static_cast<const int*>(left_all), static_cast<const int*>(starts),
      static_cast<const int*>(ends), static_cast<const int*>(counts),
      static_cast<const int*>(row_csum), n_rows, static_cast<short*>(rec_data),
      static_cast<int*>(rec_meta));
  return static_cast<int>(cudaGetLastError());
}

// table: int64 on the card, the (n_batch + 1) first records of the
// batches whose (rec_data, rec_meta) hold the round's records one after
// another (the last entry n), then their n_batch rec_data pointers and
// n_batch rec_meta pointers; out 16-byte aligned.
extern "C" int wfsim_record_rows(
    const void* table, int n_batch, const void* win, const void* win_left,
    const void* perm, int n, int dt, void* out, void* stream) {
  if (n <= 0 || n_batch <= 0 || (reinterpret_cast<uintptr_t>(out) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  record_rows_kernel<<<(n + kTileRows - 1) / kTileRows, kRowThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), n_batch,
      static_cast<const int*>(win), static_cast<const long long*>(win_left),
      static_cast<const long long*>(perm), n, dt,
      static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
