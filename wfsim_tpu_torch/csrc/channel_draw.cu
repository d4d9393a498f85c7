// channel_draw: the inverse-CDF channel draw of every photon.
//
// Replaces: wfsim_tpu/ops/randsample.py:120 categorical_from_cdf and :99
// search_sorted_rows, as the S1 and S2 chains call them (wfsim_tpu
// models/s1.py:162-170, models/s2.py:355-374), together with the pattern
// cumsum in front of them.  Plain twin: ops/randsample.py channel_draw_ref.
//
// Two kernels on the caller's stream, one C entry:
//   (a) the CDF pass, one warp per instruction.  The warp reads its masked
//       pattern row (map lookup times live mask) 512 columns at a time,
//       coalesced, and broadcasts the columns in order by shuffle; every
//       lane runs the same sequential float64 sum, so all lanes hold the
//       same bits, and lane k keeps the prefix of column c0 + k.  The float32
//       CDF row goes to an (I, C) scratch the wrapper allocates (~1 MB at
//       512 x 494, which stays in L2).
//   (b) the photon pass, one thread per photon over the flat range, in
//       tiles of kTile photons per block.  A tile finds the instructions of
//       its first and last photon (a warp each, 32 edges a read); when they
//       span at most rows_cap rows (bench S2s have ~3,000 photons a row, a
//       tile of 1,024 spans one or two), the block stages those CDF rows and
//       edges in shared memory and every photon searches there, else it
//       searches the edges and its row in global memory.  Each photon draws
//       the smallest c with cdf[c] > u * cdf[C-1] (side 'right'), clamped to
//       C-1, or -1 where the row has no mass.
// The TPU form searched the (I, 494) CDF in device memory with a two-level
// block search.  Here neither pass gives an instruction's photons to one
// block: a batch with one S2 of ~10^6 photons (a high-energy deposit)
// spreads over the whole card like any other.
//
// What bounds it on the H100: reading the uniforms and writing the
// channels, 8 bytes a photon (~13 MB at the bench S2 batch of 1.57 M
// photons); the CDF pass is C dependent float64 adds per instruction, all
// instructions in parallel.
//
// A photon outside [edges[0], edges[I]) gets -1: the kernel writes the n
// channels [0, n) and nothing else, so the wrapper needs no read-back of
// edges[I] (it checks edges[I] == n only on the CPU).
//
// Numerics.  The CDF is the twin's rule: a sequential float64 accumulation,
// each entry rounded to float32 once (torch's CPU cumsum of float32 does
// exactly this); a parallel scan would give other last bits, and a photon
// whose target falls between the two versions would change channel.  The
// target u * total is one rounded float32 product, written __fmul_rn.  A
// float compare treats -0.0 and +0.0 as equal, as the twin's order keys
// (which map -0.0 to +0.0) do.
#include <cuda_runtime.h>

namespace {

constexpr int kCdfThreads = 128;         // 4 warps, 4 instructions a block
constexpr int kCdfChunks = 16;           // 32-column chunks loaded together
constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr int kMaxTileRows = 8;          // rows a tile stages at most
constexpr int kTileSmem = 48 * 1024;     // without opting in to more

__global__ void cdf_kernel(const float* __restrict__ pattern, int n_inst,
                           int C, float* __restrict__ cdf) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n_inst) return;                 // the whole warp leaves together
  const float* row = pattern + static_cast<long long>(i) * C;
  float* out = cdf + static_cast<long long>(i) * C;
  double acc = 0.0;
  for (int c0 = 0; c0 < C; c0 += 32 * kCdfChunks) {
    // the group's loads are all in flight before its first add
    float v[kCdfChunks];
#pragma unroll
    for (int q = 0; q < kCdfChunks; ++q) {
      const int c = c0 + 32 * q + lane;
      v[q] = c < C ? row[c] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kCdfChunks; ++q) {
      const int base = c0 + 32 * q;
      const int m = C - base;              // columns left; <= 0: none
      double mine = 0.0;
      if (m >= 32) {
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          acc = __dadd_rn(acc, static_cast<double>(
                                   __shfl_sync(0xffffffffu, v[q], k)));
          if (k == lane) mine = acc;
        }
      } else {
        for (int k = 0; k < m; ++k) {
          acc = __dadd_rn(acc, static_cast<double>(
                                   __shfl_sync(0xffffffffu, v[q], k)));
          if (k == lane) mine = acc;
        }
      }
      if (lane < m) out[base + lane] = __double2float_rn(mine);
    }
  }
}

// the last r in [0, hi] with e[r] <= j, or -1 if there is none; every lane
// of the warp calls it with the same j and gets the answer.  Each round
// reads 32 spaced entries at once (a ballot counts those <= j), so 513
// edges take two dependent reads instead of ten
__device__ __forceinline__ int warp_last_at_or_below(const long long* e,
                                                     int hi, long long j) {
  const int lane = threadIdx.x & 31;
  int lo = 0;                              // the answer lies in [lo - 1, hi]
  while (hi - lo + 1 > 32) {
    const int step = (hi - lo + 32) / 32;
    const int idx = lo + lane * step;
    const int cnt = __popc(__ballot_sync(0xffffffffu,
                                         idx <= hi && e[idx] <= j));
    if (cnt == 0) return lo - 1;
    lo += (cnt - 1) * step;                // e[lo] <= j from here on
    hi = lo + step - 1 < hi ? lo + step - 1 : hi;
  }
  const int cnt = __popc(__ballot_sync(0xffffffffu,
                                       lo + lane <= hi && e[lo + lane] <= j));
  return lo + cnt - 1;
}

// the last r in [lo, hi] with e[r] <= j, or lo - 1 if there is none
__device__ __forceinline__ int last_at_or_below(const long long* e, int lo,
                                                int hi, long long j) {
  int a = lo, b = hi + 1;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (e[mid] <= j) a = mid + 1; else b = mid;
  }
  return a - 1;
}

// the channel of uniform u in one CDF row (shared or global memory)
__device__ __forceinline__ int draw(const float* cdf, int C, float u) {
  const float total = cdf[C - 1];
  if (!(total > 0.0f)) return -1;
  const float target = __fmul_rn(u, total);
  int a = 0, b = C;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (cdf[mid] <= target) a = mid + 1; else b = mid;
  }
  return a < C - 1 ? a : C - 1;
}

__global__ void photon_kernel(const float* __restrict__ cdf, int n_inst,
                              int C, const long long* __restrict__ edges,
                              const float* __restrict__ u, int n,
                              int rows_cap, int* __restrict__ ch) {
  extern __shared__ long long smem[];
  long long* s_edges = smem;                                  // rows_cap + 1
  float* s_cdf = reinterpret_cast<float*>(smem + rows_cap + 1);
  __shared__ int s_first, s_last;
  const long long j0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long j1 = j0 + kTile < n ? j0 + kTile : n;
  if (threadIdx.x < 32) {
    const int r = warp_last_at_or_below(edges, n_inst, j0);
    if (threadIdx.x == 0) s_first = r;
  } else if (threadIdx.x < 64) {
    const int r = warp_last_at_or_below(edges, n_inst, j1 - 1);
    if (threadIdx.x == 32) s_last = r;
  }
  __syncthreads();
  // rows that can own a photon of the tile: [lo, hi] inside [0, I)
  const int lo = s_first > 0 ? s_first : 0;
  const int hi = s_last < n_inst - 1 ? s_last : n_inst - 1;
  const int nr = hi - lo + 1;
  if (nr >= 1 && nr <= rows_cap) {         // the same on every thread
    for (int k = threadIdx.x; k <= nr; k += blockDim.x)
      s_edges[k] = edges[lo + k];
    const float* src = cdf + static_cast<long long>(lo) * C;
    for (int k = threadIdx.x; k < nr * C; k += blockDim.x) s_cdf[k] = src[k];
    __syncthreads();
    for (int q = 0; q < kPerThread; ++q) {
      const long long j = j0 + q * kThreads + threadIdx.x;
      if (j >= j1) break;
      // local row in [-1, nr]; -1 and nr are photons outside the edges
      const int r = last_at_or_below(s_edges, 0, nr, j);
      ch[j] = (r >= 0 && r < nr)
                  ? draw(s_cdf + static_cast<long long>(r) * C, C, u[j])
                  : -1;
    }
  } else {
    for (int q = 0; q < kPerThread; ++q) {
      const long long j = j0 + q * kThreads + threadIdx.x;
      if (j >= j1) break;
      const int r = last_at_or_below(edges, 0, n_inst, j);
      ch[j] = (r >= 0 && r < n_inst)
                  ? draw(cdf + static_cast<long long>(r) * C, C, u[j])
                  : -1;
    }
  }
}

}  // namespace

extern "C" int wfsim_channel_draw(const void* pattern, int n_inst, int C,
                                  const void* edges, const void* u, int n,
                                  void* cdf, void* ch, void* stream) {
  if (n_inst <= 0 || C <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int warps = kCdfThreads / 32;
  cdf_kernel<<<(n_inst + warps - 1) / warps, kCdfThreads, 0, s>>>(
      static_cast<const float*>(pattern), n_inst, C, static_cast<float*>(cdf));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // rows a tile may stage: as many as fit the default 48 KB with their
  // edges (less the kernel's static 8 bytes and a margin), at most
  // kMaxTileRows; 0 (global memory only) past ~12 k channels
  const long long row_bytes = static_cast<long long>(C) * sizeof(float) +
                              sizeof(long long);
  long long cap = (kTileSmem - 64) / row_bytes;
  cap = cap < kMaxTileRows ? cap : kMaxTileRows;
  const size_t smem = static_cast<size_t>(
      (cap + 1) * sizeof(long long) + cap * C * sizeof(float));
  const long long blocks = (static_cast<long long>(n) + kTile - 1) / kTile;
  photon_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const float*>(cdf), n_inst, C,
      static_cast<const long long*>(edges), static_cast<const float*>(u), n,
      static_cast<int>(cap), static_cast<int*>(ch));
  return static_cast<int>(cudaGetLastError());
}
