// tiles: the segments that a fixed tile of elements meets, found once per
// tile.
//
// Used by the flat kernels of photon_times.cu (the S2 electron and photon
// times) and the garfield times, NEST delays and custom S1 delays of
// table_samplers.cu; the truth kernels of
// pmt_response.cu take its search and its ticket, the gas-gap sampler of
// table_samplers.cu its loads, stores and ticket.  A batch
// of n elements is cut into S segments by an edge array: segment s owns the
// elements [e(s), e(s+1)) with e(s) = min(edges[s], n), so a launch never
// reads or writes past n whatever the edges hold.  An element at or past
// e(S) belongs to no segment and gets S; one before e(0) gets -1.
//
// A block of kThreads threads takes a tile of kStep * R consecutive
// elements.  In step r < R thread t holds the four elements 4 (t + kThreads
// r) .. + 3 of the tile: one 16-byte load a field, a warp's 128 elements
// contiguous.  The tile's segments are found once: every warp finds the
// segments of the tile's first and last elements, s0 and s1, itself, by two
// 32-ary searches side by side (one ballot a step: 4 rounds of dependent
// loads over 90,000 edges, 3 over 513), so no shared-memory round is needed
// for them.  Where s0 < s1 and at most kRegEdges edges lie inside the
// tile, each warp loads them, a lane each, and an element's segment is s0
// plus the count of those at or before it (a shuffle an edge).  With more,
// every edge inside the tile, s in (s0, s1], marks its position in shared
// memory with s - s0 (atomicMax: edges that share a position, those of
// empty segments, keep the largest), and a max-scan of the marks in
// element order gives each element s0 plus the largest mark at or before
// it: its segment.  No element searches, and the work is the same whether
// a segment holds one element or the whole tile.
#pragma once

#include <cuda_runtime.h>

namespace tiles {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 4 * kThreads;   // elements a block covers in one step

__device__ __forceinline__ long long edge(const long long* e, long long s,
                                          long long n) {
  const long long v = __ldg(e + s);
  return v < n ? v : n;
}

// segment i is one of the S segments (-1 and S are none)
__device__ __forceinline__ bool in_range(long long i, long long S) {
  return i >= 0 && i < S;
}

// by a whole warp (the same in every lane): the number of s in [0, S] with
// edge(s) <= x, and the same for y; the segment of element x is that count
// minus one
__device__ inline void warp_counts(const long long* e, long long S,
                                   long long n, long long x, long long y,
                                   long long& cx, long long& cy) {
  const int lane = threadIdx.x & 31;
  long long lo[2] = {0, 0}, hi[2] = {S + 1, S + 1};
  const long long key[2] = {x, y};
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
    long long step[2];
    bool gt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      step[h] = (hi[h] - lo[h] + 31) >> 5;
      const long long idx = lo[h] + (lane + 1) * step[h] - 1;
      gt[h] = lo[h] >= hi[h] || idx >= hi[h] || edge(e, idx, n) > key[h];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (lo[h] >= hi[h]) continue;   // the same in every lane
      const unsigned b = __ballot_sync(kFull, gt[h]);
      if (b == 0) {                   // every probe <= key: the last is hi-1
        lo[h] = hi[h];
        continue;
      }
      const int f = __ffs(b) - 1;
      const long long top = lo[h] + (f + 1) * step[h] - 1;
      lo[h] += f * step[h];
      hi[h] = top < hi[h] ? top : hi[h];
    }
  }
  cx = lo[0];
  cy = lo[1];
}

// mark the edges s in (lo, hi] at their tile positions pos(s) - a with
// s - lo (lo >= -1) in the zeroed marks; the caller syncs before and after
template <class Pos>
__device__ __forceinline__ void mark_edges(unsigned* m, long long lo,
                                           long long hi, long long a,
                                           Pos pos) {
  for (long long s = lo + 1 + threadIdx.x; s <= hi; s += kThreads)
    atomicMax(m + (pos(s) - a), static_cast<unsigned>(s - lo));
}

// in place, over the kStep * R marks: m[p] = the largest of m[0..p], in
// element order; tot: R * kWarps words of shared memory.  Syncs the block
// (three times) and leaves the result visible to it.
template <int R>
__device__ void max_scan(unsigned* m, unsigned* tot) {
  constexpr int kParts = R * kWarps;   // warp-steps, in element order
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned excl[R];                    // the warp-exclusive prefix of a step
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint4 v = reinterpret_cast<const uint4*>(m)[threadIdx.x +
                                                      kThreads * r];
    unsigned x = max(max(v.x, v.y), max(v.z, v.w));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x = max(x, y);
    }
    const unsigned before = __shfl_up_sync(kFull, x, 1);
    excl[r] = lane == 0 ? 0u : before;
    if (lane == 31) tot[r * kWarps + w] = x;
  }
  __syncthreads();
  if (w == 0) {                        // exclusive max-scan of the parts
    unsigned carry = 0;
#pragma unroll
    for (int c = 0; c < kParts; c += 32) {
      const int idx = c + lane;
      unsigned x = idx < kParts ? tot[idx] : 0u;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x = max(x, y);
      }
      const unsigned before = __shfl_up_sync(kFull, x, 1);
      if (idx < kParts) tot[idx] = max(carry, lane == 0 ? 0u : before);
      carry = max(carry, __shfl_sync(kFull, x, 31));
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint4* p = reinterpret_cast<uint4*>(m) + threadIdx.x + kThreads * r;
    uint4 v = *p;
    const unsigned pre = max(tot[r * kWarps + w], excl[r]);
    v.x = max(pre, v.x);
    v.y = max(v.x, v.y);
    v.z = max(v.y, v.z);
    v.w = max(v.z, v.w);
    *p = v;
  }
  __syncthreads();
}

// at most this many edges inside a tile are found in registers
constexpr int kRegEdges = 8;

// The segments of a tile's elements, found once (find_ids) and read a step
// at a time.  A tile inside one segment (m = 0) needs nothing; one with at
// most kRegEdges edges inside holds them a lane each (their positions in
// `mine`) and counts those at or before an element (a shuffle an edge, no
// shared memory, no sync); any other has max-scanned its edges' marks in
// `marks` and reads them.
struct TileIds {
  long long s0;          // the segment of the tile's first element
  long long m;           // edges inside the tile
  int mine;              // this lane's edge position (m <= kRegEdges)
  const unsigned* marks;

  // rel[q]: the segment of the thread's element q of step r (tile position
  // 4 (t + kThreads r) + q) minus s0; called by every lane together
  __device__ __forceinline__ void step(int r, unsigned (&rel)[4]) const {
    const int p0 = 4 * (threadIdx.x + kThreads * r);
    if (m > kRegEdges) {
      const uint4 v = reinterpret_cast<const uint4*>(marks)[p0 >> 2];
      rel[0] = v.x;
      rel[1] = v.y;
      rel[2] = v.z;
      rel[3] = v.w;
      return;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) rel[q] = 0;
#pragma unroll
    for (int k = 0; k < kRegEdges; ++k) {
      if (k >= m) break;                  // the same in every lane
      const int pk = __shfl_sync(kFull, mine, k);
#pragma unroll
      for (int q = 0; q < 4; ++q) rel[q] += p0 + q >= pk;
    }
  }
};

// the segments of a tile [a, a + kStep R) whose first and last elements lie
// in segments s0 and s1, edge s at position pos(s); marks: kStep * R words
// of shared memory (used only where more than kRegEdges edges lie inside),
// tot: R * kWarps; the branch is the same in every thread of the block
template <int R, class Pos>
__device__ __forceinline__ TileIds find_ids(unsigned* marks, unsigned* tot,
                                            long long s0, long long s1,
                                            long long a, Pos pos) {
  TileIds ids{s0, s1 - s0, 0, marks};
  if (ids.m == 0) return ids;
  if (ids.m <= kRegEdges) {
    const int lane = threadIdx.x & 31;
    if (lane < ids.m) ids.mine = static_cast<int>(pos(s0 + 1 + lane) - a);
    return ids;
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    reinterpret_cast<uint4*>(marks)[threadIdx.x + kThreads * r] =
        make_uint4(0, 0, 0, 0);
  __syncthreads();
  mark_edges(marks, s0, s1, a, pos);
  __syncthreads();
  max_scan<R>(marks, tot);
  return ids;
}

// the four elements j0 .. j0+3 of a field: one 16-byte load where the
// field is aligned (vec) and all four lie before b, else one load each
// below b (0 past it)
template <class T, class T4>
__device__ __forceinline__ T4 load4(const T* x, long long j0, long long b,
                                    bool vec) {
  if (vec && j0 + 3 < b) return __ldg(reinterpret_cast<const T4*>(x + j0));
  T4 v{0, 0, 0, 0};
  if (j0 < b) v.x = __ldg(x + j0);
  if (j0 + 1 < b) v.y = __ldg(x + j0 + 1);
  if (j0 + 2 < b) v.z = __ldg(x + j0 + 2);
  if (j0 + 3 < b) v.w = __ldg(x + j0 + 3);
  return v;
}

__device__ __forceinline__ float4 load4f(const float* x, long long j0,
                                         long long b, bool vec) {
  return load4<float, float4>(x, j0, b, vec);
}

__device__ __forceinline__ int4 load4i(const int* x, long long j0,
                                       long long b, bool vec) {
  return load4<int, int4>(x, j0, b, vec);
}

// store the elements of j0 .. j0+3 whose bit is set in keep: one 16-byte
// store where all four are kept and the field is aligned
__device__ __forceinline__ void store4(int* x, long long j0, const int (&v)[4],
                                       unsigned keep, bool vec) {
  if (vec && keep == 0xf) {
    *reinterpret_cast<int4*>(x + j0) = make_int4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (keep >> q & 1) x[j0 + q] = v[q];
}

__device__ __forceinline__ void store4(float* x, long long j0,
                                       const float (&v)[4], unsigned keep,
                                       bool vec) {
  if (vec && keep == 0xf) {
    *reinterpret_cast<float4*>(x + j0) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (keep >> q & 1) x[j0 + q] = v[q];
}

__device__ __forceinline__ void store4(long long* x, long long j0,
                                       const long long (&v)[4], unsigned keep,
                                       bool vec) {
  if (vec && keep == 0xf) {
    longlong2* p = reinterpret_cast<longlong2*>(x + j0);
    p[0] = make_longlong2(v[0], v[1]);
    p[1] = make_longlong2(v[2], v[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (keep >> q & 1) x[j0 + q] = v[q];
}

// a pointer's 16-byte alignment
__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// an atomic add with release and acquire at device scope: what a block
// wrote (and fenced) before it is visible to whoever reads the count after
__device__ __forceinline__ unsigned ticket_add(unsigned* p) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
               : "=r"(old) : "l"(p) : "memory");
  return old;
}

// a release and acquire fence at device scope
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

}  // namespace tiles
