// table_samplers: per-photon samples of the tabulated and per-class timing
// distributions.
//
// Replaces: wfsim_tpu/models/s2.py:255 luminescence_garfield_gasgap (the
// garfield gas-gap luminescence times), wfsim_tpu/models/s1.py:108
// _nest_table_delays (the NEST S1 photon delays), wfsim_tpu/models/s1.py:56
// _custom_recoil_delays (the custom S1 delays by recoil class) and
// wfsim_tpu/models/s2.py:234 luminescence_garfield (the garfield
// wire-table luminescence times).  Plain twins: models/s2.py
// lumi_gasgap_times_ref and lumi_garfield_times_ref, models/s1.py
// nest_delays_ref and custom_delays_ref.  The per-instruction halves of the
// first two (the gas-gap rows and fraction, the recoil class and the field
// and energy grid positions) are torch at instruction width.
//
// wfsim_lumi_gasgap_times: T = lerp over the gas gap of the two table rows
// at quantile u * (M-2), lerped between floor and ceil (s2.py:271-286);
// each instruction's photons' T summed in int64 fixed point (2^-32 ns, each
// rounded half to even), so the sum is exact and its order free (the
// wrapper raises where a sum could pass int64: a host bound first,
// check_fixed_point_range where that fails); the mean is that sum over the
// count in float64, rounded to float32 once; t = trunc(T - mean).  Three
// launches, the work of each fixed by the host's sizes alone:
//   the instruction blocks  block i takes instruction i whole where its
//                 photons fit 8,192 (kBlockSpan, from its first photon
//                 rounded down to a multiple of four): 16-byte loads of u,
//                 its two rows lerped over the gas gap into shared memory,
//                 T, a block reduction of the fixed-point terms, the mean
//                 and t: u read once, t written once, no atomics.  A larger
//                 instruction ("tiled") is appended to a list instead;
//   the sum pass  (nothing where the list is empty) a grid of a block a
//                 4,096 photons strides over the listed instructions'
//                 tiles of 4,096 photons (each cut from its first photon
//                 rounded down to a multiple of four, so a tile lies inside
//                 one instruction and needs no search): a block reduction
//                 of the tile's fixed-point terms, added to the
//                 instruction's int64 sum by one atomic;
//   the apply pass (nothing where the list is empty) the same tiles read
//                 their instruction's sum, take its ticket (the tile that
//                 completes it clears the sum and the ticket) and write T,
//                 recomputed from u with the same bits, minus the mean; the
//                 last block to have read the list clears it.
// So an S2 of 10^6 photons spreads over every SM, and a batch of bench
// S2s (at most ~4,800 photons each) runs in one pass of u.  No per-photon
// scratch: 8 bytes a photon (12 for a tiled one, whose u is read twice);
// the sums, tickets and list live in a zeroed per-stream scratch that
// every call leaves zero.
//
// The NEST entry point runs one block per instruction walking the
// instruction's photons [edges[i], edges[i+1]):
//   wfsim_nest_delays        the (class, field, energy, quantile) table read
//                            at the 2 x 2 field/energy corners and the two
//                            quantiles around u * (M-1), summed in the
//                            twin's order (s1.py:124-129).
//
// The custom entry point runs one thread per photon, which finds its
// instruction by a binary search of the edges:
//   wfsim_s1_custom_delays   the delay of the instruction's recoil class
//                            only, from the class's draws: ER the primary
//                            singlet/triplet delay where u_prim <
//                            excfrac, else clip(reco_time * (-1 + 1/u),
//                            0, 1000) (u clamped to >= 1e-12) plus the
//                            secondary one; NR and alpha their
//                            singlet/triplet delay; LED u * led_length.  A
//                            singlet/triplet delay is trunc(exp *
//                            lifetime) as an int, then a float, as the
//                            twin (and JAX, s1.py:77-78) casts it.
//
// The garfield entry point is one launch over fixed tiles of 4,096 photons
// (tiles.cuh, as the S2 photon times of photon_times.cu):
//   wfsim_lumi_garfield_times
//                            a block finds its tile's instructions once
//                            (two 32-ary warp searches of the edges, the
//                            few edges inside the tile in registers, a
//                            max-scan of their marks where there are more
//                            than kRegEdges) and computes their table rows
//                            itself: a lane an instruction where at most
//                            kRegEdges edges lie inside the tile (read by
//                            a shuffle), else each thread as its photons'
//                            instruction changes.  The row: the wire
//                            distance d, the rotated y, x sin(tilt) + y
//                            cos(tilt), plus pitch/2, modulo the pitch
//                            with the divisor's sign (jnp.remainder:
//                            fmodf, then + pitch where the remainder is
//                            non-zero and its sign is not the pitch's),
//                            minus pitch/2; or, in the confine mode,
//                            max(-c, u * 2c - c) from the instruction's
//                            uniform; then argmin |d - x_r|, the lowest r
//                            on a tie (a strict < in index order).  The
//                            table (11 x 500 floats in the configurations
//                            here) is staged in shared memory where it
//                            fits kGarfieldStage floats; cols are read and
//                            t written four photons a thread as 16-byte
//                            vectors: t = int(table[row, col]) - avgt.  An
//                            instruction of 10^6 photons spans ~245 tiles,
//                            each with one instruction and one row, so no
//                            photon searches; the edges are clamped to the
//                            photons and nothing is read back.
//
// What bounds them on the H100: the uniforms they read and the times they
// write, 8 bytes a photon (+4 for a tiled gas-gap instruction's second
// read of u; 48 for the custom delays, which read the 11 draws of the
// photon's class only, 2-6 of them; 12 for the garfield times, its int64
// column and int32 time); the tables (40 KB gas-gap, 8 MB NEST, 22 KB
// garfield) stay in L2 and the reads of one instruction hit the same few
// rows.
//
// Numerics.  nvcc contracts a*b+c into an FMA by default; every product
// and sum the twin rounds separately is written with __fmul_rn /
// __fadd_rn / __fsub_rn: (hi - lo) * f + lo, (t2 - t1) * w + t1,
// a * (1 - kw) + b * kw, out + (fwgt * ewgt) * q.  Casts truncate toward
// zero as trunc + .to(int32) does.
#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

using tiles::kThreads;

// one instruction's gas-gap rows and fraction
struct GasGapRows {
  const float* lo;
  const float* hi;
  float f;
};

struct GasGapIn {
  const float* inv;
  int M;
  const long long* lower;
  const long long* upper;
  const float* frac;
  const long long* edges;   // (S+1,) photon edges of the instructions
  long long S;
  long long n;              // photons
  const float* u;
  bool vec;                 // u and t 16-byte aligned
};

constexpr int kTileSteps = 4;    // the tile passes: tiles of 4,096 photons
constexpr long long kTile = static_cast<long long>(tiles::kStep) * kTileSteps;
constexpr int kBlockSteps = 8;   // an instruction block: up to 8,192 photons
constexpr long long kBlockSpan =
    static_cast<long long>(tiles::kStep) * kBlockSteps;
constexpr int kRowCap = 2048;    // the sampled columns a block stages (M-1;
                                 // the synthetic table: 999)

__device__ __forceinline__ GasGapRows rows_of(const GasGapIn& g, long long i) {
  return {g.inv + __ldg(g.lower + i) * g.M, g.inv + __ldg(g.upper + i) * g.M,
          __ldg(g.frac + i)};
}

// whether the instruction of photons [lo, hi) goes to the tile passes: its
// photons, from lo rounded down to a multiple of four (the 16-byte loads),
// do not fit one instruction block
__device__ __forceinline__ bool tiled(long long lo, long long hi) {
  return hi > (lo & ~3LL) + kBlockSpan;
}

// column c of the rows lerped at f: (hi_c - lo_c) * f + lo_c, each product
// and sum rounded as gasgap_time rounds them
__device__ __forceinline__ float row_value(const GasGapRows& r, int c) {
  const float a = __ldg(r.lo + c);
  return __fadd_rn(__fmul_rn(__fsub_rn(__ldg(r.hi + c), a), r.f), a);
}

// T of one photon: the rows lerped at f, at the quantile u * (M-2) lerped
// between floor and ceil (s2.py:271-286), each product and sum rounded
__device__ __forceinline__ float gasgap_time(const GasGapRows& r, float u,
                                             float scale) {
  const float s = __fmul_rn(u, scale);
  const int i0 = static_cast<int>(floorf(s));
  const int i1 = static_cast<int>(ceilf(s));
  const float w = __fsub_rn(s, static_cast<float>(i0));
  const float t1 = row_value(r, i0), t2 = row_value(r, i1);
  return __fadd_rn(__fmul_rn(__fsub_rn(t2, t1), w), t1);
}

// T of one photon from its instruction's row as stage_row staged it: the
// same bits as gasgap_time
__device__ __forceinline__ float staged_time(const float* row, float u,
                                             float scale) {
  const float s = __fmul_rn(u, scale);
  const int i0 = static_cast<int>(floorf(s));
  const int i1 = static_cast<int>(ceilf(s));
  const float w = __fsub_rn(s, static_cast<float>(i0));
  const float t1 = row[i0], t2 = row[i1];
  return __fadd_rn(__fmul_rn(__fsub_rn(t2, t1), w), t1);
}

// An instruction's rows lerped over the gas gap (row_value) into row[c]
// for the sampled columns c < M-1, every column loaded before any is
// stored: a warp's photons read 32 random columns, from shared memory a
// few bank conflicts, from the table in L1 ~20-30 distinct lines a load.
// False where they do not fit kRowCap (T then comes from the table); the
// caller syncs before reading them.
__device__ __forceinline__ bool stage_row(const GasGapIn& g,
                                          const GasGapRows& rw, float* row) {
  constexpr int kCols = kRowCap / tiles::kThreads;
  const int W = g.M - 1;
  if (W > kRowCap) return false;
  float col[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int c = threadIdx.x + tiles::kThreads * k;
    if (c < W) col[k] = row_value(rw, c);
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int c = threadIdx.x + tiles::kThreads * k;
    if (c < W) row[c] = col[k];
  }
  return true;
}

__device__ __forceinline__ float time_of(const GasGapRows& rw,
                                         const float* row, bool staged,
                                         float u, float scale) {
  return staged ? staged_time(row, u, scale) : gasgap_time(rw, u, scale);
}

// T in fixed point: an int64 multiple of 2^-32 ns, rounded half to even
__device__ __forceinline__ unsigned long long fixed_of(float T) {
  return static_cast<unsigned long long>(
      __double2ll_rn(__dmul_rn(static_cast<double>(T), 0x1p32)));
}

// the mean of instruction i from its fixed-point sum: the sum over the
// count in float64, rounded to float32 once
__device__ __forceinline__ float mean_of(long long sum, long long count) {
  return __double2float_rn(__ddiv_rn(__dmul_rn(__ll2double_rn(sum), 0x1p-32),
                                     static_cast<double>(count)));
}

// a block's sum of the threads' parts (wsum: kWarps words of shared
// memory), valid in thread 0; syncs the block once
__device__ __forceinline__ unsigned long long block_sum(
    unsigned long long part, unsigned long long* wsum) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    part += __shfl_xor_sync(tiles::kFull, part, d);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = part;
  __syncthreads();
  unsigned long long total = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < tiles::kWarps; ++k) total += wsum[k];
  }
  return total;
}

// The instruction blocks: block i takes instruction i whole where it fits
// (tiled() false).  Every uniform of its span, from lo rounded down to a
// multiple of four, as 16-byte loads, and its row pair lerped over the gas
// gap are loaded at once and put in shared memory; then T in place of the
// uniforms (each thread its own four at a time), the fixed-point sum (a
// block reduction, exact), the mean, and t.  One that does not fit is
// appended to the tiled instructions' list instead (the order the atomics
// give is free: an instruction's sum is exact in any order).
__global__ void __launch_bounds__(tiles::kThreads, 4)
    gasgap_block_kernel(GasGapIn g, unsigned* list, unsigned* count,
                        int* __restrict__ t) {
  using namespace tiles;
  __shared__ __align__(16) float4 T4[kBlockSteps * kThreads];
  __shared__ __align__(16) float row[kRowCap];
  __shared__ unsigned long long wsum[kWarps];
  __shared__ float mean;
  const long long i = blockIdx.x;
  const GasGapRows rw = rows_of(g, i);   // issued with the edges
  const long long lo = edge(g.edges, i, g.n), hi = edge(g.edges, i + 1, g.n);
  if (hi <= lo) return;                  // the whole block
  if (tiled(lo, hi)) {
    if (threadIdx.x == 0) list[atomicAdd(count, 1u)] = static_cast<unsigned>(i);
    return;
  }
  const long long a = lo & ~3LL;
  float4 u[kBlockSteps];
#pragma unroll
  for (int k = 0; k < kBlockSteps; ++k) {
    const long long j0 = a + 4 * (threadIdx.x + kThreads * k);
    if (j0 < hi) u[k] = load4f(g.u, j0, hi, g.vec);
  }
  const bool staged = stage_row(g, rw, row);
#pragma unroll
  for (int k = 0; k < kBlockSteps; ++k)
    if (a + 4 * (threadIdx.x + kThreads * k) < hi)
      T4[threadIdx.x + kThreads * k] = u[k];
  __syncthreads();
  const float scale = static_cast<float>(g.M - 2);
  unsigned long long part = 0;
#pragma unroll
  for (int k = 0; k < kBlockSteps; ++k) {
    const int p = threadIdx.x + kThreads * k;
    const long long j0 = a + 4 * p;
    if (j0 >= hi) break;
    const float4 v = T4[p];
    float T[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (j0 + q < lo || j0 + q >= hi) continue;
      T[q] = time_of(rw, row, staged, T[q], scale);
      part += fixed_of(T[q]);
    }
    T4[p] = make_float4(T[0], T[1], T[2], T[3]);
  }
  const unsigned long long total = block_sum(part, wsum);
  if (threadIdx.x == 0) mean = mean_of(static_cast<long long>(total), hi - lo);
  __syncthreads();
  const float m = mean;
#pragma unroll
  for (int k = 0; k < kBlockSteps; ++k) {
    const int p = threadIdx.x + kThreads * k;
    const long long j0 = a + 4 * p;
    if (j0 >= hi) break;
    const float4 T = T4[p];
    const int v[4] = {static_cast<int>(__fsub_rn(T.x, m)),
                      static_cast<int>(__fsub_rn(T.y, m)),
                      static_cast<int>(__fsub_rn(T.z, m)),
                      static_cast<int>(__fsub_rn(T.w, m))};
    unsigned keep = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (j0 + q >= lo && j0 + q < hi) keep |= 1u << q;
    store4(t, j0, v, keep, g.vec);
  }
}

// A tile of the tiled instructions: instruction i, its photons [lo, hi),
// the tile's span [a, a + kTile) and the instruction's count of tiles n
struct TiledTile {
  long long i, lo, hi, a;
  unsigned n;
};

// Tile b of the tiled instructions: each cut into tiles of kTile photons
// from its first photon rounded down to a multiple of four, in list order;
// found by warp 0 (the list's L entries 32 at a time, a warp prefix of
// their tile counts) and written to *out, i = -1 past the last tile.
__device__ void find_tiled_tile(const GasGapIn& g, const unsigned* list,
                                unsigned L, long long b, TiledTile* out) {
  const int lane = threadIdx.x & 31;
  long long before = 0;
  for (unsigned c = 0; c < L; c += 32) {
    const unsigned k = c + lane;
    long long i = 0, lo = 0, hi = 0, n = 0;
    if (k < L) {
      i = list[k];
      lo = tiles::edge(g.edges, i, g.n);
      hi = tiles::edge(g.edges, i + 1, g.n);
      n = (hi - (lo & ~3LL) + kTile - 1) / kTile;
    }
    long long incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(tiles::kFull, incl, d);
      if (lane >= d) incl += y;
    }
    const long long excl = before + incl - n;
    const bool mine = k < L && b >= excl && b < excl + n;
    if (__ballot_sync(tiles::kFull, mine)) {
      if (mine)
        *out = {i, lo, hi, (lo & ~3LL) + (b - excl) * kTile,
                static_cast<unsigned>(n)};
      return;
    }
    before += __shfl_sync(tiles::kFull, incl, 31);
  }
  if (lane == 0) out->i = -1;
}

// The sum pass (nothing where no instruction is tiled): the grid strides
// over the tiled instructions' tiles; a tile's uniforms are loaded, its
// instruction's rows staged, and its photons' fixed-point times summed
// over the block and added to the instruction's int64 sum by one atomic
// (wrapping, so exact in any order: the wrapper keeps every instruction's
// true sum inside int64).
__global__ void __launch_bounds__(tiles::kThreads)
    gasgap_sum_kernel(GasGapIn g, unsigned long long* sums,
                      const unsigned* list, const unsigned* count) {
  using namespace tiles;
  constexpr int R = kTileSteps;
  __shared__ __align__(16) float row[kRowCap];
  __shared__ unsigned long long wsum[kWarps];
  __shared__ TiledTile tile;
  const unsigned L = __ldg(count);
  if (L == 0) return;                    // no instruction is tiled
  const float scale = static_cast<float>(g.M - 2);
  for (long long b = blockIdx.x;; b += gridDim.x) {
    if (threadIdx.x < 32) find_tiled_tile(g, list, L, b, &tile);
    __syncthreads();
    const TiledTile tl = tile;
    if (tl.i < 0) return;                // the whole block
    const long long end = tl.a + kTile < tl.hi ? tl.a + kTile : tl.hi;
    float u[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 v =
          load4f(g.u, tl.a + 4 * (threadIdx.x + kThreads * r), end, g.vec);
      u[r][0] = v.x, u[r][1] = v.y, u[r][2] = v.z, u[r][3] = v.w;
    }
    const GasGapRows rw = rows_of(g, tl.i);
    const bool staged = stage_row(g, rw, row);
    __syncthreads();
    unsigned long long part = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long j0 = tl.a + 4 * (threadIdx.x + kThreads * r);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j0 + q >= tl.lo && j0 + q < end)
          part += fixed_of(time_of(rw, row, staged, u[r][q], scale));
    }
    const unsigned long long total = block_sum(part, wsum);
    if (threadIdx.x == 0 && total != 0) atomicAdd(sums + tl.i, total);
    __syncthreads();                     // tile, row and wsum are reused
  }
}

// The apply pass (nothing where no instruction is tiled): the same tiles;
// thread 0 reads the instruction's sum into the mean and then takes its
// ticket, and the tile that completes the instruction clears its sum and
// ticket; every photon's T, recomputed from u with the same bits, minus
// the mean.  Every block then takes a ticket of the list's reads, and the
// last clears the list and its count, so the scratch is zero for the next
// call.
__global__ void __launch_bounds__(tiles::kThreads, 4)
    gasgap_apply_kernel(GasGapIn g, unsigned long long* sums,
                        unsigned* tickets, unsigned* list, unsigned* count,
                        int* __restrict__ t) {
  using namespace tiles;
  constexpr int R = kTileSteps;
  __shared__ __align__(16) float row[kRowCap];
  __shared__ TiledTile tile;
  __shared__ unsigned n_listed;
  __shared__ float mean;
  if (threadIdx.x == 0) n_listed = *reinterpret_cast<volatile unsigned*>(count);
  __syncthreads();
  const unsigned L = n_listed;
  if (L == 0) return;                    // no instruction is tiled
  const float scale = static_cast<float>(g.M - 2);
  for (long long b = blockIdx.x;; b += gridDim.x) {
    if (threadIdx.x < 32) find_tiled_tile(g, list, L, b, &tile);
    __syncthreads();
    const TiledTile tl = tile;
    if (tl.i < 0) break;                 // the whole block
    const long long end = tl.a + kTile < tl.hi ? tl.a + kTile : tl.hi;
    float u[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 v =
          load4f(g.u, tl.a + 4 * (threadIdx.x + kThreads * r), end, g.vec);
      u[r][0] = v.x, u[r][1] = v.y, u[r][2] = v.z, u[r][3] = v.w;
    }
    const GasGapRows rw = rows_of(g, tl.i);
    if (threadIdx.x == 0)
      mean = mean_of(static_cast<long long>(sums[tl.i]), tl.hi - tl.lo);
    const bool staged = stage_row(g, rw, row);
    __syncthreads();
    if (threadIdx.x == 0 && ticket_add(tickets + tl.i) == tl.n - 1) {
      sums[tl.i] = 0;
      tickets[tl.i] = 0;
    }
    const float m = mean;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long j0 = tl.a + 4 * (threadIdx.x + kThreads * r);
      int v[4];
      unsigned keep = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = 0;
        if (j0 + q < tl.lo || j0 + q >= end) continue;
        v[q] = static_cast<int>(
            __fsub_rn(time_of(rw, row, staged, u[r][q], scale), m));
        keep |= 1u << q;
      }
      store4(t, j0, v, keep, g.vec);
    }
    __syncthreads();                     // tile, row and mean are reused
  }
  if (threadIdx.x == 0 && ticket_add(count + 1) == gridDim.x - 1) {
    for (unsigned k = 0; k < L; ++k) list[k] = 0;
    count[0] = 0;
    count[1] = 0;
  }
}

__global__ void nest_delays_kernel(
    const float* __restrict__ table, int F, int En, int M,
    const long long* __restrict__ cls, const long long* __restrict__ fi0,
    const long long* __restrict__ fi1, const float* __restrict__ fw,
    const long long* __restrict__ ei0, const long long* __restrict__ ei1,
    const float* __restrict__ ew, const long long* __restrict__ edges,
    const float* __restrict__ u, float* __restrict__ out) {
  const int i = blockIdx.x;
  const long long lo = edges[i], hi = edges[i + 1];
  const long long fidx[2] = {fi0[i], fi1[i]};
  const long long eidx[2] = {ei0[i], ei1[i]};
  const float wf[2] = {__fsub_rn(1.0f, fw[i]), fw[i]};
  const float we[2] = {__fsub_rn(1.0f, ew[i]), ew[i]};
  const long long c = cls[i];
  const float scale = static_cast<float>(M - 1);
  for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    const float s = __fmul_rn(u[j], scale);
    const int k0 = static_cast<int>(floorf(s));
    const int k1 = k0 + 1 < M - 1 ? k0 + 1 : M - 1;
    const float kw = __fsub_rn(s, static_cast<float>(k0));
    const float omk = __fsub_rn(1.0f, kw);
    float acc = 0.0f;
    for (int a = 0; a < 2; ++a) {
      for (int b = 0; b < 2; ++b) {
        const float* row = table + ((c * F + fidx[a]) * En + eidx[b]) * M;
        const float q = __fadd_rn(__fmul_rn(row[k0], omk),
                                  __fmul_rn(row[k1], kw));
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wf[a], we[b]), q));
      }
    }
    out[j] = acc;
  }
}

__device__ __forceinline__ int instruction_of(const long long* edges,
                                              int n_inst, long long j) {
  // the largest i with edges[i] <= j: edges[0] = 0 <= j < edges[n_inst]
  int lo = 0, hi = n_inst;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (edges[mid] <= j) lo = mid; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float singlet_triplet(float u, float e,
                                                 float frac, float t1,
                                                 float t3) {
  return static_cast<float>(
      static_cast<int>(__fmul_rn(e, u < frac ? t1 : t3)));
}

struct CustomDraws {
  const float *u_prim, *u_st_prim, *exp_st_prim, *u_reco, *u_st_sec,
      *exp_st_sec, *u_nr, *exp_nr, *u_alpha, *exp_alpha, *u_led;
};

struct CustomConsts {
  float excfrac, reco_time, f_prim, f_sec, f_nr, f_alpha, t1, t3, led;
};

__global__ void custom_delays_kernel(const long long* __restrict__ cls,
                                     const long long* __restrict__ edges,
                                     int n_inst, int n, CustomDraws d,
                                     CustomConsts k,
                                     float* __restrict__ out) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    const long long c = cls[instruction_of(edges, n_inst, j)];
    float v;
    if (c == 1) {
      v = singlet_triplet(d.u_nr[j], d.exp_nr[j], k.f_nr, k.t1, k.t3);
    } else if (c == 2) {
      v = singlet_triplet(d.u_alpha[j], d.exp_alpha[j], k.f_alpha, k.t1,
                          k.t3);
    } else if (c == 3) {
      v = __fmul_rn(d.u_led[j], k.led);
    } else if (d.u_prim[j] < k.excfrac) {
      v = singlet_triplet(d.u_st_prim[j], d.exp_st_prim[j], k.f_prim, k.t1,
                          k.t3);
    } else {
      const float u = fmaxf(d.u_reco[j], 1e-12f);
      float reco = __fmul_rn(k.reco_time,
                             __fadd_rn(-1.0f, __fdiv_rn(1.0f, u)));
      reco = fminf(fmaxf(reco, 0.0f), 1000.0f);
      v = __fadd_rn(reco, singlet_triplet(d.u_st_sec[j], d.exp_st_sec[j],
                                          k.f_sec, k.t1, k.t3));
    }
    out[j] = v;
  }
}

struct GarfieldIn {
  const float* table;       // (R, M)
  int R, M;
  const float* x_axis;      // (R,)
  const float* xy;          // (S, 2), or unread in the confine mode
  const float* u_wire;      // (S,) in the confine mode, else null
  const long long* edges;   // (S+1,) photon edges of the instructions
  long long S;
  long long n;              // photons
  const long long* cols;    // (n,) in [0, M)
  float sin_t, cos_t, pitch, half_pitch, confine;
  int avgt;
  bool staged;              // the table fits kGarfieldStage floats
  bool vec;                 // cols and t 16-byte aligned
};

// the table row of instruction i: the wire distance d (the rotated y
// modulo the pitch, or the confine mode's uniform), then argmin |d - x_r|,
// the lowest r on a tie
__device__ __forceinline__ int garfield_row(const GarfieldIn& in,
                                            long long i) {
  float d;
  if (in.u_wire != nullptr) {
    d = fmaxf(-in.confine,
              __fadd_rn(__fmul_rn(__ldg(in.u_wire + i),
                                  __fadd_rn(in.confine, in.confine)),
                        -in.confine));
  } else {
    const float rot_y = __fadd_rn(__fmul_rn(__ldg(in.xy + 2 * i), in.sin_t),
                                  __fmul_rn(__ldg(in.xy + 2 * i + 1),
                                            in.cos_t));
    float r = fmodf(__fadd_rn(rot_y, in.half_pitch), in.pitch);
    if (r != 0.0f && ((r < 0.0f) != (in.pitch < 0.0f)))
      r = __fadd_rn(r, in.pitch);
    d = __fsub_rn(r, in.half_pitch);
  }
  int best_r = 0;
  float best = fabsf(__fsub_rn(d, __ldg(in.x_axis)));
  for (int r = 1; r < in.R; ++r) {
    const float diff = fabsf(__fsub_rn(d, __ldg(in.x_axis + r)));
    if (diff < best) {
      best = diff;
      best_r = r;
    }
  }
  return best_r;
}

// table floats staged in shared memory (with the tile's marks, within the
// 48 KB a block gets without opting in)
constexpr int kGarfieldStage = 8160;
constexpr int kGarfieldSteps = 4;   // tiles of 4,096 photons

// A block a tile of 4,096 photons: the tile's instructions found once
// (tiles.cuh), their rows computed by the block (a lane an instruction
// where at most kRegEdges edges lie inside the tile, else by each thread
// as its instruction changes), the table staged in shared memory, cols
// read and t written four photons a thread with 16-byte vectors.  Rows
// computed by each thread alone were measured 1.3x slower on an H100 (the
// lanes' 11-row loops then run in every thread before its first gather).
__global__ void __launch_bounds__(tiles::kThreads)
    garfield_times_kernel(GarfieldIn in, int* __restrict__ t) {
  using namespace tiles;
  constexpr int R = kGarfieldSteps;
  constexpr long long kTile = static_cast<long long>(kStep) * R;
  extern __shared__ float table_sh[];
  __shared__ __align__(16) unsigned marks[kTile];
  __shared__ unsigned tot[R * kWarps];
  const long long a = static_cast<long long>(blockIdx.x) * kTile;
  const long long b = a + kTile < in.n ? a + kTile : in.n;
  long long c0, c1;
  warp_counts(in.edges, in.S, in.n, a, b - 1, c0, c1);
  const long long s0 = c0 - 1, s1 = c1 - 1;
  if (s0 == s1 && !in_range(s0, in.S)) return;   // the whole block
  const int n_tab = in.R * in.M;
  if (in.staged) {
    for (int c = threadIdx.x; c < n_tab; c += kThreads)
      table_sh[c] = __ldg(in.table + c);
  }
  __syncthreads();
  const float* tab = in.staged ? table_sh : in.table;
  const TileIds ids = find_ids<R>(
      marks, tot, s0, s1, a,
      [&](long long s) { return edge(in.edges, s, in.n); });
  const bool few = ids.m <= kRegEdges;   // the same in every thread
  const int lane = threadIdx.x & 31;
  int lane_row = 0;                      // the row of instruction s0 + lane
  if (few && lane <= ids.m && in_range(s0 + lane, in.S))
    lane_row = garfield_row(in, s0 + lane);
  long long cur = -1;
  int row = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long j0 = a + 4 * (threadIdx.x + kThreads * r);
    long long col[4] = {0, 0, 0, 0};
    if (in.vec && j0 + 3 < b) {
      const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(
          in.cols + j0));
      const longlong2 y = __ldg(reinterpret_cast<const longlong2*>(
          in.cols + j0 + 2));
      col[0] = x.x, col[1] = x.y, col[2] = y.x, col[3] = y.y;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j0 + q < b) col[q] = __ldg(in.cols + j0 + q);
    }
    unsigned rel[4];
    ids.step(r, rel);
    int tt[4];
    unsigned keep = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long id = s0 + rel[q];
      int rq = 0;
      if (few) rq = __shfl_sync(kFull, lane_row, static_cast<int>(rel[q]));
      tt[q] = 0;
      if (j0 + q < b && in_range(id, in.S)) {
        if (!few) {
          if (id != cur) {
            cur = id;
            row = garfield_row(in, id);
          }
          rq = row;
        }
        tt[q] = static_cast<int>(tab[rq * in.M + col[q]]) - in.avgt;
        keep |= 1u << q;
      }
    }
    store4(t, j0, tt, keep, in.vec);
  }
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 132 * 32 ? blocks : 132 * 32);
}

}  // namespace

// n photons of n_inst instructions; acc: n_inst zero int64 sums, then
// 2 n_inst + 2 zero uint32 words (the tickets, the tiled instructions'
// list, its count and the count of its reads), left zero (one buffer per
// stream: two launches sharing it must not overlap)
extern "C" int wfsim_lumi_gasgap_times(const void* inv, int G, int M,
                                       const void* lower, const void* upper,
                                       const void* frac, int n_inst,
                                       const void* edges, const void* u,
                                       int n, void* acc, void* t,
                                       void* stream) {
  if (n_inst <= 0 || G < 1 || M < 3 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  GasGapIn g;
  g.inv = static_cast<const float*>(inv);
  g.M = M;
  g.lower = static_cast<const long long*>(lower);
  g.upper = static_cast<const long long*>(upper);
  g.frac = static_cast<const float*>(frac);
  g.edges = static_cast<const long long*>(edges);
  g.S = n_inst;
  g.n = n;
  g.u = static_cast<const float*>(u);
  g.vec = tiles::aligned16(u) && tiles::aligned16(t);
  auto* sums = static_cast<unsigned long long*>(acc);
  auto* tickets = reinterpret_cast<unsigned*>(sums + n_inst);
  unsigned* list = tickets + n_inst;
  unsigned* count = list + n_inst;
  auto* out = static_cast<int*>(t);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a block a tile of the photons: the tiled instructions' tiles are at
  // most ~1.5 times as many, and the grid strides over them
  const unsigned grid = static_cast<unsigned>((n + kTile - 1) / kTile);
  gasgap_block_kernel<<<n_inst, kThreads, 0, st>>>(g, list, count, out);
  gasgap_sum_kernel<<<grid, kThreads, 0, st>>>(g, sums, list, count);
  gasgap_apply_kernel<<<grid, kThreads, 0, st>>>(g, sums, tickets, list,
                                                 count, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wfsim_nest_delays(const void* table, int n_cls, int F, int En,
                                 int M, const void* cls, const void* fi0,
                                 const void* fi1, const void* fw,
                                 const void* ei0, const void* ei1,
                                 const void* ew, int n_inst,
                                 const void* edges, const void* u, void* out,
                                 void* stream) {
  if (n_inst <= 0 || n_cls < 1 || F < 2 || En < 2 || M < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  nest_delays_kernel<<<n_inst, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), F, En, M,
      static_cast<const long long*>(cls), static_cast<const long long*>(fi0),
      static_cast<const long long*>(fi1), static_cast<const float*>(fw),
      static_cast<const long long*>(ei0), static_cast<const long long*>(ei1),
      static_cast<const float*>(ew), static_cast<const long long*>(edges),
      static_cast<const float*>(u), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wfsim_s1_custom_delays(
    const void* cls, const void* edges, int n_inst, int n,
    const void* u_prim, const void* u_st_prim, const void* exp_st_prim,
    const void* u_reco, const void* u_st_sec, const void* exp_st_sec,
    const void* u_nr, const void* exp_nr, const void* u_alpha,
    const void* exp_alpha, const void* u_led, float excfrac,
    float reco_time, float f_prim, float f_sec, float f_nr, float f_alpha,
    float t1, float t3, float led, void* out, void* stream) {
  if (n_inst <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const CustomDraws d{
      static_cast<const float*>(u_prim), static_cast<const float*>(u_st_prim),
      static_cast<const float*>(exp_st_prim),
      static_cast<const float*>(u_reco), static_cast<const float*>(u_st_sec),
      static_cast<const float*>(exp_st_sec), static_cast<const float*>(u_nr),
      static_cast<const float*>(exp_nr), static_cast<const float*>(u_alpha),
      static_cast<const float*>(exp_alpha), static_cast<const float*>(u_led)};
  const CustomConsts k{excfrac, reco_time, f_prim, f_sec, f_nr, f_alpha,
                       t1, t3, led};
  custom_delays_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(cls),
      static_cast<const long long*>(edges), n_inst, n, d, k,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// n photons of n_inst instructions in tiles of 4,096; t (n,) int32, each
// photon below the clamped last edge written
extern "C" int wfsim_lumi_garfield_times(
    const void* table, int R, int M, const void* x_axis, const void* xy,
    const void* u_wire, int n_inst, const void* edges, const void* cols,
    int n, float sin_t, float cos_t, float pitch, float half_pitch,
    float confine, int avgt, void* t, void* stream) {
  if (n_inst <= 0 || n < 0 || R < 1 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  GarfieldIn in;
  in.table = static_cast<const float*>(table);
  in.R = R;
  in.M = M;
  in.x_axis = static_cast<const float*>(x_axis);
  in.xy = static_cast<const float*>(xy);
  in.u_wire = static_cast<const float*>(u_wire);
  in.edges = static_cast<const long long*>(edges);
  in.S = n_inst;
  in.n = n;
  in.cols = static_cast<const long long*>(cols);
  in.sin_t = sin_t;
  in.cos_t = cos_t;
  in.pitch = pitch;
  in.half_pitch = half_pitch;
  in.confine = confine;
  in.avgt = avgt;
  in.staged = static_cast<long long>(R) * M <= kGarfieldStage;
  in.vec = tiles::aligned16(cols) && tiles::aligned16(t);
  constexpr long long kTile =
      static_cast<long long>(tiles::kStep) * kGarfieldSteps;
  const size_t smem = in.staged ? static_cast<size_t>(R) * M * sizeof(float)
                                : 0;
  garfield_times_kernel<<<static_cast<unsigned>((n + kTile - 1) / kTile),
                          tiles::kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<int*>(t));
  return static_cast<int>(cudaGetLastError());
}
