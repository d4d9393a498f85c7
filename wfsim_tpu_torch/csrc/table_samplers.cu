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
// The NEST and custom entry points are one launch each over fixed tiles of
// 512 photons (blocks of 128 threads, four photons a thread: a bench S1
// batch of ~7,000 photons is 14 blocks, an S1 of 10^5 photons ~200): a
// block stages a window of the edges and what its photons need of the
// instructions between them in shared memory, computed once a tile: every
// edge and instruction where the batch has fewer than kDelayStage (1,024)
// instructions, with no search, else its tile's (32-ary warp searches of
// the edges, tiles.cuh); a warp finds its photons' instructions in the
// window by a ballot search and the few edges inside its photons, a lane
// each; u or the draws are read and the delays written four photons a
// thread as 16-byte vectors; the edges are clamped to the photons and
// nothing is read back.  Each phase's global loads are issued together.
//   wfsim_nest_delays        a staged instruction: its four (class, field,
//                            energy) row offsets and weight products
//                            wf[a] * we[b] (the twin's float32 operands,
//                            so the same bits); a photon reads the four
//                            rows at the two quantiles around u * (M-1)
//                            (k1 clamped to M-1), eight loads issued
//                            together, summed in the twin's order
//                            (s1.py:124-129): (lower, lower), (lower,
//                            upper), (upper, lower), (upper, upper).
//   wfsim_s1_custom_delays   a staged instruction: its recoil class; a
//                            thread loads the draws of its photons'
//                            classes only, together (ER: the primary
//                            uniform, both singlet/triplet pairs and the
//                            recombination uniform, with no second round
//                            after u_prim): ER the primary
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
// read of u; 8-20 for the custom delays, which need the draws of the
// photon's class only, 1-4 of them; 12 for the garfield times, its int64
// column and int32 time); the tables (40 KB gas-gap, 8 MB NEST, 22 KB
// garfield) stay in L2 and the reads of one instruction hit the same few
// rows.  At an S1 batch's few thousand photons the bytes take ~30 ns,
// below what a launch costs: the S1 delays are bound by their chain of
// dependent loads (the staged window, then the draws or the table), and
// the NEST delays also by the L1 requests of their scattered table reads
// (eight a photon), which tiles of 512 spread over 14 SMs on a bench batch.
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

// The S1 delays: blocks of 128 threads, tiles of 512 photons (four a
// thread), so a bench S1 batch of ~7,000 photons spreads over 14 SMs and
// an S1 of 10^5 photons over ~200 blocks.  A block stages a window of the
// edges (int32, clamped to the photons) and what its photons need of the
// instructions between them in shared memory, computed once a tile: every
// edge and instruction where the batch has fewer than kDelayStage
// instructions (the main path's S1 batches: no search), else the edges of
// its tile's instructions s0 .. s1 found by the warps' searches of the
// global edges.  A warp then finds its 128 photons' instructions in the
// window itself: a 32-ary ballot search for the last edge at or before its
// first photon, the edges inside its photons a lane each, counted for each
// photon by shuffles (no block sync past the staging); past 31 edges
// inside a warp's photons (runs of nearly empty instructions) a search of
// the staged edges a photon, and past the staged edges (a tile that meets
// more than kDelayStage) one of the global edges, the instruction then
// computed by the photon's thread.  At these sizes the time goes to the
// rounds of dependent loads and the block's serial steps (in-kernel clock
// stamps on an H100), so the loads of each phase are issued together,
// without branches between them: a conditional load behind a branch makes
// the loads after it wait for it.
constexpr int kDelayThreads = 128;
constexpr long long kDelayTile = 4 * kDelayThreads;
constexpr int kDelayStage = 1024;
constexpr int kDelayItems = kDelayStage / kDelayThreads;

// one tile of the S1 delays: its photons [a, b) and the window of edges
// w0 .. w0 + cnt - 1, min(cnt, kDelayStage) of them staged
struct DelayTile {
  long long a, b;   // b = 0: the tile holds no photon of an instruction
  long long w0, cnt;
  int staged;
};

__device__ __forceinline__ DelayTile delay_tile(const long long* edges,
                                                long long S, long long n) {
  using namespace tiles;
  DelayTile t{};
  t.a = static_cast<long long>(blockIdx.x) * kDelayTile;
  t.b = t.a + kDelayTile < n ? t.a + kDelayTile : n;
  if (S < kDelayStage) {                 // every edge
    t.cnt = S + 1;
  } else {                               // the tile's (the same in every
    long long c0, c1;                    // thread)
    warp_counts(edges, S, n, t.a, t.b - 1, c0, c1);
    const long long s0 = c0 - 1, s1 = c1 - 1;
    if (s0 == s1 && !in_range(s0, S)) {
      t.b = 0;
      return t;
    }
    t.w0 = s0 > 0 ? s0 : 0;
    t.cnt = s1 - t.w0 + 1;
  }
  t.staged = static_cast<int>(t.cnt < kDelayStage ? t.cnt : kDelayStage);
  return t;
}

// the window's staged edges and instructions, sh_e[k] = e(w0 + k) and sh[k]
// = make(w0 + k) (of instruction S - 1 past the last), every load issued
// before any store (indices clamped, no branch); the caller syncs
template <class T, class Make>
__device__ __forceinline__ void stage_window(const DelayTile& t,
                                             const long long* edges,
                                             long long S, long long n,
                                             int* sh_e, T* sh, Make make) {
  int e[kDelayItems];
  T v[kDelayItems];
#pragma unroll
  for (int i = 0; i < kDelayItems; ++i) {
    const int k = threadIdx.x + kDelayThreads * i;
    const long long s = t.w0 + (k < t.staged ? k : t.staged - 1);
    e[i] = static_cast<int>(tiles::edge(edges, s, n));
    v[i] = make(s < S ? s : S - 1);
  }
#pragma unroll
  for (int i = 0; i < kDelayItems; ++i) {
    const int k = threadIdx.x + kDelayThreads * i;
    if (k < t.staged) {
      sh_e[k] = e[i];
      sh[k] = v[i];
    }
  }
}

// the count of staged edges at or before j, by one thread (at most 10
// shared-memory steps)
__device__ __forceinline__ int staged_count(const DelayTile& t,
                                            const int* sh_e, long long j) {
  int lo = 0, hi = t.staged;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sh_e[mid] <= j) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the last window edge at or before j from e(lo) <= j, past the staged
// edges: a search of the global edges, kept out of line
__device__ __noinline__ long long global_search(const long long* edges,
                                                long long n, long long lo,
                                                long long hi, long long j) {
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if (tiles::edge(edges, mid, n) <= j) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// the instructions of the thread's photons j0 + q (w0 - 1 before the first
// edge, S past the last) and their staged indices (clamped to the staged
// ones); keep: the photons of an instruction; past: those whose
// instruction is not staged
struct PhotonIds {
  long long id[4];
  int idx[4];
  unsigned keep, past;
};

// by the whole warp: the warp's 128 photons from wa = j0 - 4 lane find the
// last staged edge at or before wa by a 32-ary ballot search, load the
// staged edges after it a lane each, and count those inside the warp's
// photons at or before each of theirs (a shuffle an edge)
__device__ __forceinline__ PhotonIds photon_ids(const DelayTile& t,
                                                const int* sh_e,
                                                const long long* edges,
                                                long long S, long long n,
                                                long long j0) {
  const int lane = threadIdx.x & 31;
  const long long wa = j0 - 4 * lane;
  int lo = 0, hi = t.staged;             // the count of staged edges <= wa
  while (lo < hi) {                      // the same in every lane
    const int step = (hi - lo + 31) >> 5;
    const int probe = lo + (lane + 1) * step - 1;
    const unsigned gt =
        __ballot_sync(tiles::kFull, probe >= hi || sh_e[probe] > wa);
    if (gt == 0) {
      lo = hi;
      break;
    }
    const int f = __ffs(gt) - 1;
    const int top = lo + (f + 1) * step - 1;
    lo += f * step;
    hi = top < hi ? top : hi;
  }
  const int kb = lo - 1;                 // the last staged edge <= wa
  const int kl = kb + 1 + lane;
  const int el = kl < t.staged ? sh_e[kl] : 0x7fffffff;
  const int m = __popc(__ballot_sync(tiles::kFull, el < wa + 4 * 32));
  int k[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) k[q] = kb;
  if (m < 32) {                          // the same in every lane
    for (int i = 0; i < m; ++i) {
      const int ei = __shfl_sync(tiles::kFull, el, i);
#pragma unroll
      for (int q = 0; q < 4; ++q) k[q] += ei <= j0 + q;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) k[q] = staged_count(t, sh_e, j0 + q) - 1;
  }
  PhotonIds p;
  p.keep = p.past = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    p.id[q] = t.w0 + k[q];
    p.idx[q] = k[q] < 0 ? 0 : k[q];
  }
  if (t.staged < t.cnt) {                // past the staged edges
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (j0 + q < t.b && k[q] == t.staged - 1)
        p.id[q] = global_search(edges, n, t.w0 + t.staged - 1,
                                t.w0 + t.cnt - 1, j0 + q);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (j0 + q < t.b && tiles::in_range(p.id[q], S)) {
      p.keep |= 1u << q;
      if (p.id[q] - t.w0 >= t.staged) p.past |= 1u << q;
    }
  }
  return p;
}

struct NestIn {
  const float* table;       // (4, F, En, M)
  int F, En, M;
  const long long *cls, *fi0, *fi1, *ei0, *ei1;   // (S,)
  const float *fw, *ew;                            // (S,)
  const long long* edges;   // (S+1,) photon edges of the instructions
  long long S;
  long long n;              // photons
  const float* u;
  bool vec;                 // u and out 16-byte aligned
};

// one instruction's four table rows (offsets of (c, fi, ei, 0)) and their
// weight products, in the twin's order: (field lower, energy lower),
// (lower, upper), (upper, lower), (upper, upper)
struct NestRows {
  int4 row;
  float4 w;
};

__device__ __forceinline__ NestRows nest_rows(const NestIn& in, long long i) {
  const long long c = __ldg(in.cls + i);
  const long long f[2] = {__ldg(in.fi0 + i), __ldg(in.fi1 + i)};
  const long long e[2] = {__ldg(in.ei0 + i), __ldg(in.ei1 + i)};
  const float fw = __ldg(in.fw + i), ew = __ldg(in.ew + i);
  const float wf[2] = {__fsub_rn(1.0f, fw), fw};
  const float we[2] = {__fsub_rn(1.0f, ew), ew};
  int row[4];
  float w[4];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      row[2 * p + q] =
          static_cast<int>(((c * in.F + f[p]) * in.En + e[q]) * in.M);
      w[2 * p + q] = __fmul_rn(wf[p], we[q]);
    }
  }
  return {make_int4(row[0], row[1], row[2], row[3]),
          make_float4(w[0], w[1], w[2], w[3])};
}

// the delay of one photon at uniform u: its instruction's four rows read at
// the two quantiles around u * (M-1) (k1 clamped to M-1), eight loads issued
// before any sum, summed in the twin's order
__device__ __forceinline__ float nest_delay(const NestIn& in,
                                            const NestRows& r, float u,
                                            float scale) {
  const float s = __fmul_rn(u, scale);
  const int k0 = static_cast<int>(floorf(s));
  const int k1 = k0 + 1 < in.M - 1 ? k0 + 1 : in.M - 1;
  const float kw = __fsub_rn(s, static_cast<float>(k0));
  const float omk = __fsub_rn(1.0f, kw);
  const int row[4] = {r.row.x, r.row.y, r.row.z, r.row.w};
  const float w[4] = {r.w.x, r.w.y, r.w.z, r.w.w};
  float lo[4], hi[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    lo[c] = __ldg(in.table + row[c] + k0);
    hi[c] = __ldg(in.table + row[c] + k1);
  }
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float q = __fadd_rn(__fmul_rn(lo[c], omk), __fmul_rn(hi[c], kw));
    acc = __fadd_rn(acc, __fmul_rn(w[c], q));
  }
  return acc;
}

// A block a tile of 512 photons (see delay_tile): the window and its
// instructions' rows and weights staged with u (16-byte vectors), each
// warp's photons' instructions found, then every photon's eight table
// loads issued together (a photon of no instruction reads row 0) and the
// delays written as 16-byte vectors.
__global__ void __launch_bounds__(kDelayThreads)
    nest_delays_kernel(NestIn in, float* __restrict__ out) {
  __shared__ int sh_e[kDelayStage];
  __shared__ NestRows rows_sh[kDelayStage];
  const DelayTile t = delay_tile(in.edges, in.S, in.n);
  if (t.b == 0) return;                  // the whole block
  stage_window(t, in.edges, in.S, in.n, sh_e, rows_sh,
               [&](long long s) { return nest_rows(in, s); });
  const long long j0 = t.a + 4 * threadIdx.x;
  const float4 u4 = tiles::load4f(in.u, j0, t.b, in.vec);
  __syncthreads();
  const PhotonIds p = photon_ids(t, sh_e, in.edges, in.S, in.n, j0);
  NestRows r[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    r[q] = rows_sh[p.idx[q]];
    if (!(p.keep >> q & 1)) r[q] = NestRows{};
  }
  if (p.past) {                          // not staged: by this thread
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (p.past >> q & 1) r[q] = nest_rows(in, p.id[q]);
  }
  const float u[4] = {u4.x, u4.y, u4.z, u4.w};
  const float scale = static_cast<float>(in.M - 1);
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = nest_delay(in, r[q], u[q], scale);
  tiles::store4(out, j0, v, p.keep, in.vec);
}

__device__ __forceinline__ float singlet_triplet(float u, float e,
                                                 float frac, float t1,
                                                 float t3) {
  return static_cast<float>(
      static_cast<int>(__fmul_rn(e, u < frac ? t1 : t3)));
}

// the custom model's draws, in CUSTOM_DRAWS order (models/s1.py)
enum CustomDraw {
  kUPrim, kUStPrim, kExpStPrim, kUReco, kUStSec, kExpStSec, kUNr, kExpNr,
  kUAlpha, kExpAlpha, kULed, kCustomDraws
};

struct CustomIn {
  const long long* cls;     // (S,) recoil class
  const long long* edges;   // (S+1,) photon edges of the instructions
  long long S;
  long long n;              // photons
  const float* d[kCustomDraws];
  float excfrac, reco_time, f_prim, f_sec, f_nr, f_alpha, t1, t3, led;
  bool vec;                 // every draw and out 16-byte aligned
};

// the draws the delay of class c reads, a bit each: NR and alpha their
// pair, LED its uniform, ER (0, or any other class, as the twin's where
// selects) the primary uniform with both pairs and the recombination
// uniform, loaded together (no second round after u_prim)
__device__ __forceinline__ unsigned draws_of(int c) {
  return c == 1   ? (1u << kUNr) | (1u << kExpNr)
         : c == 2 ? (1u << kUAlpha) | (1u << kExpAlpha)
         : c == 3 ? 1u << kULed
                  : (1u << kUPrim) | (1u << kUStPrim) | (1u << kExpStPrim) |
                        (1u << kUReco) | (1u << kUStSec) | (1u << kExpStSec);
}

// the delay of a photon of class c from its draws x: every class's delay
// computed (a draw not loaded is 0) and one selected, as the twin's where
// selects, so a warp of mixed classes runs no branches
__device__ __forceinline__ float custom_delay(const CustomIn& k, int c,
                                              const float (&x)[kCustomDraws]) {
  const float nr = singlet_triplet(x[kUNr], x[kExpNr], k.f_nr, k.t1, k.t3);
  const float alpha =
      singlet_triplet(x[kUAlpha], x[kExpAlpha], k.f_alpha, k.t1, k.t3);
  const float led = __fmul_rn(x[kULed], k.led);
  const float prim =
      singlet_triplet(x[kUStPrim], x[kExpStPrim], k.f_prim, k.t1, k.t3);
  const float u = fmaxf(x[kUReco], 1e-12f);
  float reco = __fmul_rn(k.reco_time, __fadd_rn(-1.0f, __fdiv_rn(1.0f, u)));
  reco = fminf(fmaxf(reco, 0.0f), 1000.0f);
  const float sec = __fadd_rn(
      reco, singlet_triplet(x[kUStSec], x[kExpStSec], k.f_sec, k.t1, k.t3));
  const float er = x[kUPrim] < k.excfrac ? prim : sec;
  return c == 1 ? nr : c == 2 ? alpha : c == 3 ? led : er;
}

// A block a tile of 512 photons (see delay_tile): the window and its
// instructions' classes staged, each warp's photons' instructions found,
// then the draws the thread's four photons' classes read, as 16-byte
// vectors issued together (each a predicated load), and the delays
// written as one.
__global__ void __launch_bounds__(kDelayThreads)
    custom_delays_kernel(CustomIn in, float* __restrict__ out) {
  __shared__ int sh_e[kDelayStage];
  __shared__ int cls_sh[kDelayStage];
  const DelayTile t = delay_tile(in.edges, in.S, in.n);
  if (t.b == 0) return;                  // the whole block
  stage_window(t, in.edges, in.S, in.n, sh_e, cls_sh, [&](long long s) {
    return static_cast<int>(__ldg(in.cls + s));
  });
  __syncthreads();
  const long long j0 = t.a + 4 * threadIdx.x;
  const PhotonIds p = photon_ids(t, sh_e, in.edges, in.S, in.n, j0);
  int c[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] = cls_sh[p.idx[q]];
  if (p.past) {                          // not staged: by this thread
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (p.past >> q & 1) c[q] = static_cast<int>(__ldg(in.cls + p.id[q]));
  }
  unsigned need = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (p.keep >> q & 1) need |= draws_of(c[q]);
  float x[kCustomDraws][4];
  if (in.vec && j0 + 3 < t.b) {
#pragma unroll
    for (int g = 0; g < kCustomDraws; ++g) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (need >> g & 1)
        v = __ldg(reinterpret_cast<const float4*>(in.d[g] + j0));
      x[g][0] = v.x, x[g][1] = v.y, x[g][2] = v.z, x[g][3] = v.w;
    }
  } else {
#pragma unroll
    for (int g = 0; g < kCustomDraws; ++g) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[g][q] = 0.0f;
        if ((need >> g & 1) && j0 + q < t.b)
          x[g][q] = __ldg(in.d[g] + j0 + q);
      }
    }
  }
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float xq[kCustomDraws];
#pragma unroll
    for (int g = 0; g < kCustomDraws; ++g) xq[g] = x[g][q];
    v[q] = custom_delay(in, c[q], xq);
  }
  tiles::store4(out, j0, v, p.keep, in.vec);
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

// the blocks of the S1 delays: a tile of 512 photons each
unsigned delay_grid(long long n) {
  return static_cast<unsigned>((n + kDelayTile - 1) / kDelayTile);
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

// n photons of n_inst instructions in tiles of 512; out (n,) float32,
// each photon below the clamped last edge written
extern "C" int wfsim_nest_delays(const void* table, int n_cls, int F, int En,
                                 int M, const void* cls, const void* fi0,
                                 const void* fi1, const void* fw,
                                 const void* ei0, const void* ei1,
                                 const void* ew, int n_inst,
                                 const void* edges, const void* u, int n,
                                 void* out, void* stream) {
  if (n_inst <= 0 || n < 0 || n_cls < 1 || F < 2 || En < 2 || M < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  NestIn in;
  in.table = static_cast<const float*>(table);
  in.F = F;
  in.En = En;
  in.M = M;
  in.cls = static_cast<const long long*>(cls);
  in.fi0 = static_cast<const long long*>(fi0);
  in.fi1 = static_cast<const long long*>(fi1);
  in.ei0 = static_cast<const long long*>(ei0);
  in.ei1 = static_cast<const long long*>(ei1);
  in.fw = static_cast<const float*>(fw);
  in.ew = static_cast<const float*>(ew);
  in.edges = static_cast<const long long*>(edges);
  in.S = n_inst;
  in.n = n;
  in.u = static_cast<const float*>(u);
  in.vec = tiles::aligned16(u) && tiles::aligned16(out);
  nest_delays_kernel<<<delay_grid(n), kDelayThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// n photons (the draws' length) of n_inst instructions in tiles of 512;
// out (n,) float32, each photon below the clamped last edge written
extern "C" int wfsim_s1_custom_delays(
    const void* cls, const void* edges, int n_inst, int n,
    const void* u_prim, const void* u_st_prim, const void* exp_st_prim,
    const void* u_reco, const void* u_st_sec, const void* exp_st_sec,
    const void* u_nr, const void* exp_nr, const void* u_alpha,
    const void* exp_alpha, const void* u_led, float excfrac,
    float reco_time, float f_prim, float f_sec, float f_nr, float f_alpha,
    float t1, float t3, float led, void* out, void* stream) {
  if (n_inst <= 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const void* draws[kCustomDraws] = {u_prim, u_st_prim, exp_st_prim, u_reco,
                                     u_st_sec, exp_st_sec, u_nr, exp_nr,
                                     u_alpha, exp_alpha, u_led};
  CustomIn in;
  in.cls = static_cast<const long long*>(cls);
  in.edges = static_cast<const long long*>(edges);
  in.S = n_inst;
  in.n = n;
  in.vec = tiles::aligned16(out);
  for (int k = 0; k < kCustomDraws; ++k) {
    in.d[k] = static_cast<const float*>(draws[k]);
    in.vec = in.vec && tiles::aligned16(draws[k]);
  }
  in.excfrac = excfrac;
  in.reco_time = reco_time;
  in.f_prim = f_prim;
  in.f_sec = f_sec;
  in.f_nr = f_nr;
  in.f_alpha = f_alpha;
  in.t1 = t1;
  in.t3 = t3;
  in.led = led;
  custom_delays_kernel<<<delay_grid(n), kDelayThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<float*>(out));
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
