// round_order: a digitize round's records in the (window, start, channel)
// order of the round's strax rows, with each window's record count.
//
// Replaces: wfsim_tpu/pipeline/rawdata.py:1780 (_collect_digitize_work's
// np.lexsort((C, S, W)) over a round's records, a host sort there, not a
// TPU kernel), and the port's stand-in for it, one stable torch.sort of
// packed 63-bit (window, start, channel) keys over the round, plus the
// torch.searchsorted of the sorted keys for the windows' counts
// (pipeline/digitize.py round_order_ref, the plain version).
//
// What bounds it on the H100: bytes.  Each record's window, start and
// channel are read once (12 bytes of its 24-byte meta row), its place in
// the order (8 bytes) and its round window (4) written once: ~2 us at
// 3.35 TB/s for the default run's first round of 282,261 records.  A
// library radix sort of the packed keys reads and writes keys and indices
// in every one of its passes (on NVIDIA H100 80GB HBM3 at 700.00 W it
// took 0.13-0.17 ms on that round, 70-80x the bound).  The structure of
// the input makes most of those passes unneeded:
//
// - a round window lies in one digitize batch, and pack_records writes a
//   batch's records window by window, so a window's records are one run
//   of the round's records (batches one after another), and the windows'
//   counts come from a search of each batch's window column (a warp a
//   window, 32 probes a step): the count launch, whose last block to
//   finish scans the counts in window order into the windows' first rows;
// - within a window the order is by (start, channel), a 32-bit key; with
//   the record's index in its window below it, the 64-bit words are
//   unique and their order is the stable order, so any sort gives the
//   library sort's permutation.  The sort launch gives each window a
//   block that ranks its records in shared memory by counting: a
//   histogram of their starts in 4,096 bins (a start shifted right as far
//   as the window's largest start needs: no shift in the default run's
//   first round, whose starts stay below 1,200; 3 bits where a window
//   reaches 20,730, as with noise and afterpulses), its scan, and the ties
//   of a bin ranked by (start, channel) among the bin's records;
// - a window of more than kCap records is cut into chunks of kCap, a
//   block each (the grid has a block per window and one per kCap records
//   of the round, so the host sizes it without reading a count back): a
//   block ranks its chunk as above, then counts each of the window's
//   other records at its place among the chunk's words (the bins before
//   its bin, then a search of its bin's few slots); a chunk record's rank
//   in the window is its place plus the other records counted at or
//   before it.  No block waits on another and nothing goes through device
//   memory but the meta rows; the work is the window's records times its
//   chunks (a window of 10^5 records takes 25 blocks that each read it).
//
// pack_records writes a window's records by channel, then start, and no
// channel has two records at one start, so a stable sort by start alone
// would do as well; the key with the channel is kept so that the result
// never depends on that.  Two launches, no read-back; the wrapper reads
// the counts back once a round.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCountThreads = 256;
constexpr int kCountWarps = kCountThreads / 32;
constexpr int kSortThreads = 512;
constexpr int kCap = 4096;                     // records a block sorts
constexpr int kPerSort = kCap / kSortThreads;  // records a thread a step
constexpr int kBins = 4096;                    // bins a block counts
static_assert(kCap <= 4096, "a record's index in its chunk fits 12 bits");
static_assert(kBins == 4096, "a start's bits past the bin fit the tie word");
constexpr int kBatchWords = 4;  // [data, meta, first record, records]
constexpr int kMetaWords = 6;
constexpr unsigned kFull = 0xffffffffu;

struct Round {
  const long long* bt;     // (NB, 4) each batch's [data, meta, first, n]
  const long long* qoff;   // (NB + 1,) each batch's first window entry
  const long long* wids;   // (W,) the round window of each batch window
  int n_batch;
  int n_win;
};

// the per-window results and the count launch's scratch, one int64 array
struct Work {
  long long* counts;   // (W,) records of each round window
  long long* first;    // (W,) its first record in the round's batch order
  long long* base;     // (W + 1,) its first row in the sorted order
  long long* wbatch;   // (W,) its batch
  long long* wlocal;   // (W,) its first record within the batch
  long long* qlb;      // (W,) by batch window: first record within the batch
  long long* qbatch;   // (W,) by batch window: the batch
  long long* xbase;    // (W + 1,) its first chunk block past chunk 0
};

// the chunks of kCap records a window of n records takes past its first
__device__ __forceinline__ long long extra_chunks(long long n) {
  return n > kCap ? (n - 1) / kCap : 0;
}

// the first index i in [0, n) with meta[i][0] >= b (n if none), by one warp
__device__ long long warp_lower_bound(const int* meta, long long n, int b) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;
  while (hi - lo > 32) {
    const long long pos = lo + (hi - lo) * (lane + 1) / 33;
    const bool less = __ldg(meta + pos * kMetaWords) < b;
    const int k = __popc(__ballot_sync(kFull, less));
    const long long below = __shfl_sync(kFull, pos, k > 0 ? k - 1 : 0);
    const long long above = __shfl_sync(kFull, pos, k < 32 ? k : 31);
    if (k > 0) lo = below + 1;
    if (k < 32) hi = above;
  }
  const long long pos = lo + lane;
  const bool less = pos < hi && __ldg(meta + pos * kMetaWords) < b;
  return lo + __popc(__ballot_sync(kFull, less));
}

// the sum of v over the threads before this one, and the block's total
template <int kThreads>
__device__ __forceinline__ long long block_exclusive_scan(long long v,
                                                          long long& total,
                                                          long long* red) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  __syncthreads();
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  long long before = 0;
  total = 0;
  for (int i = 0; i < kWarps; ++i) {
    if (i < warp) before += red[i];
    total += red[i];
  }
  return before + incl - v;
}

__global__ void __launch_bounds__(kCountThreads)
round_count_kernel(Round r, Work wk, unsigned* __restrict__ ctr) {
  __shared__ long long red[kCountWarps];
  __shared__ int flag;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kCountWarps + (threadIdx.x >> 5);
  if (q < r.n_win) {
    // the batch of window entry q: the batches whose first entry is <= q
    int j = -1;
    for (int i0 = 0; i0 <= r.n_batch; i0 += 32) {
      const int i = i0 + lane;
      const bool le = i <= r.n_batch && __ldg(r.qoff + i) <= q;
      j += __popc(__ballot_sync(kFull, le));
    }
    const int b = q - static_cast<int>(__ldg(r.qoff + j));
    const long long* bt = r.bt + kBatchWords * j;
    const int* meta = reinterpret_cast<const int*>(__ldg(bt + 1));
    const long long lb = warp_lower_bound(meta, __ldg(bt + 3), b);
    if (lane == 0) {
      wk.qlb[q] = lb;
      wk.qbatch[q] = j;
    }
  }
  // the last block: each window's count and first record, then the scan
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned prev = atomicAdd(ctr, 1u);
    flag = prev == gridDim.x - 1;
    if (flag) *ctr = 0u;
  }
  __syncthreads();
  if (!flag) return;
  __threadfence();
  for (int i = threadIdx.x; i < r.n_win; i += kCountThreads) {
    const int j = static_cast<int>(__ldcg(wk.qbatch + i));
    const long long* bt = r.bt + kBatchWords * j;
    const long long lb = __ldcg(wk.qlb + i);
    const bool last = i + 1 == static_cast<int>(__ldg(r.qoff + j + 1));
    const long long end = last ? __ldg(bt + 3) : __ldcg(wk.qlb + i + 1);
    const int w = static_cast<int>(__ldg(r.wids + i));
    wk.counts[w] = end - lb;
    wk.first[w] = __ldg(bt + 2) + lb;
    wk.wbatch[w] = j;
    wk.wlocal[w] = lb;
  }
  __syncthreads();
  long long carry = 0, xcarry = 0;
  for (int w0 = 0; w0 < r.n_win; w0 += kCountThreads) {
    const int w = w0 + threadIdx.x;
    const long long v = w < r.n_win ? __ldcg(wk.counts + w) : 0;
    long long sum, xsum;
    const long long before = block_exclusive_scan<kCountThreads>(v, sum, red);
    const long long xbefore =
        block_exclusive_scan<kCountThreads>(extra_chunks(v), xsum, red);
    if (w < r.n_win) {
      wk.base[w] = carry + before;
      wk.xbase[w] = xcarry + xbefore;
    }
    carry += sum;
    xcarry += xsum;
  }
  if (threadIdx.x == 0) {
    wk.base[r.n_win] = carry;
    wk.xbase[r.n_win] = xcarry;
  }
}

// the sort launch's dynamic shared memory: a long window's chunk words
// (kCap, 64-bit), the bins' counts, then first slots, then ends (kBins),
// the ties, then the other records' counts (kCap)
constexpr int kSortSmemBytes =
    kCap * sizeof(unsigned long long) + (kBins + kCap) * sizeof(unsigned);

// Block w < W takes window w's first chunk of kCap records, a later block
// a later chunk of a long window (in window order, by xbase) or nothing.
// A chunk is ranked by counting: a histogram of its starts >> shift in
// kBins bins (shift the least that fits its largest start), its exclusive
// scan, and each record's rank its bin's first slot plus the records of
// its bin that come before it, counted among the words each put into the
// bin's slots in an arbitrary order: (start's low shift bits, channel,
// index in the chunk) in 32 bits (shift + bits_c + 12 <= bits_s + bits_c
// <= 32, as the wrapper checks).  The ranks are those of the sort by
// (start, channel, index).  A window of at most kCap records is done.  A
// chunk of a longer window puts its words (key << 32 | index in the
// window) in rank order, counts each of the window's other records at its
// place among them (the chunk words below it: those of the bins before
// its bin, then a search of its bin's slots), and ranks its record i at
// i plus the others counted at or before i.
__global__ void __launch_bounds__(kSortThreads)
round_sort_kernel(Round r, Work wk, int bits_c, long long* __restrict__ perm,
                  int* __restrict__ win) {
  extern __shared__ __align__(16) unsigned long long s[];
  unsigned* hist = reinterpret_cast<unsigned*>(s + kCap);   // (kBins,)
  unsigned* tie = hist + kBins;                             // (kCap,)
  __shared__ long long red[kSortThreads / 32];
  __shared__ int top, ws, cs;
  if (threadIdx.x == 0) {
    top = 0;
    ws = blockIdx.x;
    cs = 0;
    if (ws >= r.n_win) {
      const long long e = ws - r.n_win;
      int lo = 0, hi = r.n_win;   // the last window whose xbase <= e
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (__ldcg(wk.xbase + mid) <= e) lo = mid; else hi = mid;
      }
      ws = e < __ldcg(wk.xbase + r.n_win) ? lo : -1;
      cs = ws < 0 ? 0 : 1 + static_cast<int>(e - __ldcg(wk.xbase + lo));
    }
  }
  __syncthreads();
  const int w = ws;
  if (w < 0) return;
  const long long n = __ldcg(wk.counts + w);
  if (n == 0) return;
  const long long first = __ldcg(wk.first + w);
  const long long base = __ldcg(wk.base + w);
  const int* meta = reinterpret_cast<const int*>(
      __ldg(r.bt + kBatchWords * __ldcg(wk.wbatch + w) + 1)) +
      __ldcg(wk.wlocal + w) * kMetaWords;
  const int c0 = cs * kCap;
  const int m = static_cast<int>(min(static_cast<long long>(kCap), n - c0));
  for (int i = threadIdx.x; i < m; i += kSortThreads) win[first + c0 + i] = w;

  // the chunk's records, kPerSort a thread, and its largest start
  int st[kPerSort];
  unsigned ch[kPerSort];
  int hi = 0;
#pragma unroll
  for (int q = 0; q < kPerSort; ++q) {
    const int i = threadIdx.x + q * kSortThreads;
    st[q] = -1;
    ch[q] = 0u;
    if (i < m) {
      const int* mi = meta + static_cast<long long>(c0 + i) * kMetaWords;
      st[q] = __ldg(mi + 2);
      ch[q] = static_cast<unsigned>(__ldg(mi + 1));
      hi = max(hi, st[q]);
    }
  }
  hi = __reduce_max_sync(kFull, hi);
  if ((threadIdx.x & 31) == 0) atomicMax(&top, hi);
  __syncthreads();
  int shift = 0;
  while ((top >> shift) >= kBins) ++shift;
  const int bins = (top >> shift) + 1;
  const unsigned low = (1u << shift) - 1u;
  for (int b = threadIdx.x; b < bins; b += kSortThreads) hist[b] = 0u;
  __syncthreads();
  unsigned mine[kPerSort], p0[kPerSort];
#pragma unroll
  for (int q = 0; q < kPerSort; ++q) {
    if (st[q] < 0) continue;
    mine[q] = ((((static_cast<unsigned>(st[q]) & low) << bits_c) | ch[q])
               << 12) | static_cast<unsigned>(threadIdx.x + q * kSortThreads);
    atomicAdd(hist + (st[q] >> shift), 1u);
  }
  __syncthreads();
  // the exclusive scan of the histogram, a run of bins a thread
  {
    const int per = (bins + kSortThreads - 1) / kSortThreads;
    const int b0 = min(bins, static_cast<int>(threadIdx.x) * per);
    const int b1 = min(bins, b0 + per);
    long long sum = 0;
    for (int b = b0; b < b1; ++b) sum += hist[b];
    long long total;
    unsigned run = static_cast<unsigned>(
        block_exclusive_scan<kSortThreads>(sum, total, red));
    for (int b = b0; b < b1; ++b) {
      const unsigned v = hist[b];
      hist[b] = run;
      run += v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kPerSort; ++q)
    if (st[q] >= 0) p0[q] = hist[st[q] >> shift];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kPerSort; ++q)
    if (st[q] >= 0) tie[atomicAdd(hist + (st[q] >> shift), 1u)] = mine[q];
  __syncthreads();   // hist[b] is now the end of bin b
  unsigned rank[kPerSort];
#pragma unroll
  for (int q = 0; q < kPerSort; ++q) {
    if (st[q] < 0) continue;
    const unsigned end = hist[st[q] >> shift];
    rank[q] = p0[q];
    if (end - p0[q] > 1)
      for (unsigned k = p0[q]; k < end; ++k) rank[q] += tie[k] < mine[q];
  }
  if (n <= kCap) {
#pragma unroll
    for (int q = 0; q < kPerSort; ++q)
      if (st[q] >= 0)
        perm[base + rank[q]] = first + threadIdx.x + q * kSortThreads;
    return;
  }

  // a chunk of a long window: its words in rank order, the ties' slots
  // cleared for the other records' counts
#pragma unroll
  for (int q = 0; q < kPerSort; ++q) {
    if (st[q] < 0) continue;
    const unsigned key = (static_cast<unsigned>(st[q]) << bits_c) | ch[q];
    s[rank[q]] = (static_cast<unsigned long long>(key) << 32) |
                 static_cast<unsigned>(c0 + threadIdx.x + q * kSortThreads);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += kSortThreads) tie[i] = 0u;
  __syncthreads();
  // kPerSort other records a thread a step: their loads, then their places
  for (long long i0 = threadIdx.x; i0 < n;
       i0 += static_cast<long long>(kPerSort) * kSortThreads) {
    int sy[kPerSort];
    unsigned long long y[kPerSort];
#pragma unroll
    for (int q = 0; q < kPerSort; ++q) {
      const long long i = i0 + q * kSortThreads;
      sy[q] = -1;
      if (i < n && (i < c0 || i >= c0 + m)) {
        const int* mi = meta + i * kMetaWords;
        sy[q] = __ldg(mi + 2);
        const unsigned key = (static_cast<unsigned>(sy[q]) << bits_c) |
                             static_cast<unsigned>(__ldg(mi + 1));
        y[q] = (static_cast<unsigned long long>(key) << 32) |
               static_cast<unsigned>(i);
      }
    }
#pragma unroll
    for (int q = 0; q < kPerSort; ++q) {
      if (sy[q] < 0) continue;
      const int b = sy[q] >> shift;
      if (b >= bins) continue;            // above every chunk word
      unsigned lo = b ? hist[b - 1] : 0u, up = hist[b];
      while (lo < up) {
        const unsigned mid = (lo + up) >> 1;
        if (s[mid] < y[q]) lo = mid + 1; else up = mid;
      }
      if (lo < static_cast<unsigned>(m)) atomicAdd(tie + lo, 1u);
    }
  }
  __syncthreads();
  // the inclusive scan of the counts, kPerSort slots a thread: the rank
  const int i0 = min(m, static_cast<int>(threadIdx.x) * kPerSort);
  const int i1 = min(m, i0 + kPerSort);
  long long sum = 0;
  for (int i = i0; i < i1; ++i) sum += tie[i];
  long long total;
  long long run = block_exclusive_scan<kSortThreads>(sum, total, red);
  for (int i = i0; i < i1; ++i) {
    run += tie[i];
    perm[base + i + run] = first + static_cast<unsigned>(s[i]);
  }
}

}  // namespace

// A round of n_win windows in n_batch digitize batches, n_rec records.
// `table` is one int64 array on the card: (n_batch, 4) [rec_data,
// rec_meta, first record, records] per batch in the round's order,
// (n_batch + 1) first window entry per batch, (n_win) the round window of
// each entry (each round window once).  `work` is int64: counts (n_win),
// first (n_win), base (n_win + 1), then 5 * n_win + 1 scratch words; perm
// (n_rec) int64, win (n_rec) int32.  `ctr`: one zeroed 32-bit word, left
// zero.  bits_c: the bits of the channel below the start.
extern "C" int wfsim_round_order(const void* table, int n_batch, int n_win,
                                 int bits_c, int n_rec, void* work, void* perm,
                                 void* win, void* ctr, void* stream) {
  if (n_batch <= 0 || n_win <= 0 || bits_c < 1 || bits_c > 31 || n_rec < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      round_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSortSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Round r;
  r.bt = static_cast<const long long*>(table);
  r.qoff = r.bt + kBatchWords * n_batch;
  r.wids = r.qoff + n_batch + 1;
  r.n_batch = n_batch;
  r.n_win = n_win;
  long long* wp = static_cast<long long*>(work);
  Work wk;
  wk.counts = wp;
  wk.first = wp + n_win;
  wk.base = wp + 2LL * n_win;
  wk.wbatch = wp + 3LL * n_win + 1;
  wk.wlocal = wp + 4LL * n_win + 1;
  wk.qlb = wp + 5LL * n_win + 1;
  wk.qbatch = wp + 6LL * n_win + 1;
  wk.xbase = wp + 7LL * n_win + 1;
  round_count_kernel<<<(n_win + kCountWarps - 1) / kCountWarps, kCountThreads,
                       0, st>>>(r, wk, static_cast<unsigned*>(ctr));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a block a window, and one for each chunk past a window's first: at
  // most one for every kCap records of the round
  round_sort_kernel<<<n_win + n_rec / kCap, kSortThreads, kSortSmemBytes,
                      st>>>(r, wk, bits_c, static_cast<long long*>(perm),
                            static_cast<int*>(win));
  return static_cast<int>(cudaGetLastError());
}
