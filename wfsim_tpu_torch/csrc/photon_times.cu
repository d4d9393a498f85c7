// photon_times: the S1 and S2 electron and photon time passes.
//
// Replaces: wfsim_tpu/models/s1.py:143 simulate_s1 (the photon axis and the
// simple-model times, lines 168-188), models/s2.py:381 _s2_electron_stage
// (electron arrival times, lines 412-417) and :441 simulate_s2 (the photon
// axis and photon times, lines 462-518: the lerp of luminescence_simple's
// per-photon half, the singlet/triplet delay, the s2_time_spread and the
// electron arrival), with ops/segment.py's segment_ids_from_counts and
// expand_rows as the chains use them.  Plain twins: models/s1.py
// s1_photon_times_ref, models/s2.py s2_electron_times_ref and
// s2_photon_times_ref.
//
// Three entry points.  The S1 one writes the times and the broadcast truth
// row of each photon (no segment id: no caller reads it), which takes the
// place of repeat_interleave on the path; a block an instruction writes
// the instruction's first kS1Head (256) photons [edges[i], edges[i+1])
// with no search, and tiles of kS1Tile (256) photons over the batch write
// what lies past them, each from one warp search for the segment of its
// first photon (an instruction of 10^5 photons spreads over ~390 blocks);
// which inputs are given selects one of eight instantiations, so no load
// waits behind a branch:
//   wfsim_s1_photon_times    t = time[i] + trunc(exp * s1_decay_time)
//                                + trunc(normal * s1_decay_spread) (simple
//                                model, skipped where exp is null)
//                                + trunc(custom) (custom model) and
//                                + trunc(nest) (NEST model), in that order,
//                                where the delays of table_samplers.cu are
//                                given.
// The two S2 ones are cut by elements, not instructions (tiles.cuh): a
// block takes a fixed tile of elements, finds the tile's segments once
// (two 32-ary warp searches, then the few edges inside the tile in
// registers, or a max-scan of the edges' marks in shared memory where there
// are more) and handles four elements a thread a step with 16-byte loads
// and stores, so an S2 of 10^6 photons spreads over every SM and no
// element searches.  Where a tile holds a few instructions whose inverse
// CDFs fit a tile's words of shared memory, they are copied there: a
// photon's two reads at random columns then cost a few bank conflicts, not
// ~20-30 L1 lines a warp:
//   wfsim_s2_electron_times  e_t = time[i] + trunc(exp * trapping
//                                + (normal * spread[i] + mean[i])) and the
//                                truth row of the electron's instruction
//                                (the electron-time statistics read it);
//                                tiles of 1,024 electrons;
//   wfsim_s2_photon_times    t = trunc(lerp of the instruction's inverse
//                                CDF), or the given gas-gap luminescence
//                                time t_lum, + trunc(exp * singlet or triplet
//                                lifetime) + trunc(normal * s2_time_spread)
//                                + e_t[electron], and the photon's truth
//                                row; a tile's electrons come from the
//                                electrons' photon edges inside it, its
//                                instructions from their first photons,
//                                e_ph_edges[e_edges[i]], inside it (a
//                                photon of electron k is in instruction i
//                                exactly when e_edges[i] <= k, so counting
//                                either edge gives the same instruction;
//                                electrons without photons and instructions
//                                without electrons share an edge and are
//                                skipped).  Neither writes the element's
//                                segment id: no caller reads it.
//
// What bounds them on the H100: the draws they read and the times and rows
// they write, 20 bytes an electron and 28 a photon (~44 MB for the bench
// S2 photon pass; the S1 pass 20 with the simple model's draws); the
// luminescence table rows (4 KB each) and the electron times stay in
// L1/L2.  The search of a tile's first and last segments is a few
// dependent loads, which the other resident blocks cover; at the bench
// S1's ~7,000 photons a call is a chain of such rounds, not bytes, so
// the S1 blocks of short instructions search nothing.
//
// Numerics.  nvcc contracts a*b+c into an FMA by default, which rounds
// once where the twin rounds twice: every product and sum is written with
// __fmul_rn / __fadd_rn / __fsub_rn, in the twin's order (normal*spread +
// mean, then the exponential term added; y0*(1-w) + y1*w).  float -> int
// casts truncate toward zero in C as torch's trunc + .to(int32) does; the
// normal draws make negative offsets, so the sign matters (a floor would
// move every negative offset by 1 ns).  The lower table index is clamped
// to Q-2 (ROADMAP F2).  The float constants are the float32 values torch
// rounds the twin's Python floats to.  Edges are clamped to the elements
// (an element past the last edge is not written), so a launch reads
// nothing back and never reads past its arrays.
#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

// The S1 cut: a block an instruction writes its first kS1Head photons with
// no search; the photons past them (an instruction of more than kS1Head,
// an alpha S1 of 10^5) go to tiles of kS1Tile over the whole batch.  As
// kS1Tile <= kS1Head, a photon at offset kS1Head or more in its instruction
// has its instruction's first photon before the tile's, so the tile's only
// such photons are those of the segment of its first element: one warp
// search finds it, and a tile without such photons exits after it.
constexpr int kS1Threads = 64;
constexpr long long kS1Head = 256;    // the photons an instruction block writes
constexpr long long kS1Tile = 256;    // the photons of an overflow tile
static_assert(kS1Tile <= kS1Head, "a tile's long photons are of one segment");
static_assert(kS1Tile == 4 * kS1Threads, "four photons a thread a tile");
static_assert(kS1Head % kS1Threads == 0, "whole steps of an instruction");

struct S1In {
  const int* time;
  const long long* edges;       // (I+1,)
  const long long* truth_row;
  const float* ex;              // the simple model's draws
  const float* nrm;
  const float* custom;          // the delays, where given
  const float* nest;
  long long I;
  long long n;                  // photons
  long long tiles;              // overflow tiles, blocks [0, tiles)
  float decay_time, decay_spread;
  bool vec;                     // every photon field 16-byte aligned
};

// the time of a photon of an instruction at time ti, from its draws and
// delays; which are given is known at compile time, so no load waits on a
// branch
template <bool kSimple, bool kCustom, bool kNest>
__device__ __forceinline__ int s1_time(const S1In& in, int ti, float e,
                                       float z, float c, float ne) {
  int tt = ti;
  if constexpr (kSimple)
    tt += static_cast<int>(__fmul_rn(e, in.decay_time)) +
          static_cast<int>(__fmul_rn(z, in.decay_spread));
  if constexpr (kCustom) tt += static_cast<int>(c);
  if constexpr (kNest) tt += static_cast<int>(ne);
  return tt;
}

template <bool kSimple, bool kCustom, bool kNest>
__global__ void __launch_bounds__(kS1Threads)
    s1_photon_times_kernel(S1In in, int* __restrict__ t,
                           long long* __restrict__ ph_row) {
  using namespace tiles;
  if (blockIdx.x >= in.tiles) {            // instruction i's first photons
    const long long i = blockIdx.x - in.tiles;
    const long long lo = edge(in.edges, i, in.n);
    const long long end = edge(in.edges, i + 1, in.n);
    const int ti = __ldg(in.time + i);
    const long long row = __ldg(in.truth_row + i);
    const long long hi = end < lo + kS1Head ? end : lo + kS1Head;
    if (lo >= hi) return;
    constexpr int R = kS1Head / kS1Threads;
    float e[R], z[R], c[R], ne[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long j = lo + threadIdx.x + kS1Threads * r;
      const bool ok = j < hi;
      e[r] = kSimple && ok ? __ldg(in.ex + j) : 0.0f;
      z[r] = kSimple && ok ? __ldg(in.nrm + j) : 0.0f;
      c[r] = kCustom && ok ? __ldg(in.custom + j) : 0.0f;
      ne[r] = kNest && ok ? __ldg(in.nest + j) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long j = lo + threadIdx.x + kS1Threads * r;
      if (j < hi) {
        t[j] = s1_time<kSimple, kCustom, kNest>(in, ti, e[r], z[r], c[r],
                                                ne[r]);
        ph_row[j] = row;
      }
    }
    return;
  }
  // an overflow tile [a, a + kS1Tile): the photons of the segment s of its
  // first element from offset kS1Head on
  const long long a = static_cast<long long>(blockIdx.x) * kS1Tile;
  long long c0, c1;
  warp_counts(in.edges, in.I, in.n, a, a, c0, c1);
  const long long s = c0 - 1;
  if (!in_range(s, in.I)) return;
  const long long first = edge(in.edges, s, in.n) + kS1Head;
  const long long end = edge(in.edges, s + 1, in.n);
  const int ti = __ldg(in.time + s);
  const long long row = __ldg(in.truth_row + s);
  const long long lo = first > a ? first : a;
  const long long hi = end < a + kS1Tile ? end : a + kS1Tile;
  const long long j0 = a + 4 * threadIdx.x;
  unsigned keep = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) keep |= (j0 + q >= lo && j0 + q < hi) << q;
  if (keep == 0) return;
  // the four loads of a field may start below lo: inside the tile, so
  // inside the photons
  float4 e4{0, 0, 0, 0}, z4{0, 0, 0, 0}, c4{0, 0, 0, 0}, n4{0, 0, 0, 0};
  if constexpr (kSimple) {
    e4 = load4f(in.ex, j0, hi, in.vec);
    z4 = load4f(in.nrm, j0, hi, in.vec);
  }
  if constexpr (kCustom) c4 = load4f(in.custom, j0, hi, in.vec);
  if constexpr (kNest) n4 = load4f(in.nest, j0, hi, in.vec);
  const float e[4] = {e4.x, e4.y, e4.z, e4.w}, z[4] = {z4.x, z4.y, z4.z, z4.w};
  const float c[4] = {c4.x, c4.y, c4.z, c4.w}, ne[4] = {n4.x, n4.y, n4.z, n4.w};
  int tt[4];
  long long rr[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    tt[q] = s1_time<kSimple, kCustom, kNest>(in, ti, e[q], z[q], c[q], ne[q]);
    rr[q] = row;
  }
  store4(t, j0, tt, keep, in.vec);
  store4(ph_row, j0, rr, keep, in.vec);
}

template <bool kSimple, bool kCustom, bool kNest>
int launch_s1(const S1In& in, unsigned grid, int* t, long long* ph_row,
              cudaStream_t stream) {
  s1_photon_times_kernel<kSimple, kCustom, kNest>
      <<<grid, kS1Threads, 0, stream>>>(in, t, ph_row);
  return static_cast<int>(cudaGetLastError());
}

struct ElectronIn {
  const int* time;
  const long long* e_edges;     // (I+1,) electron edges of the instructions
  long long I;
  long long n;                  // electrons
  const float* mean;
  const float* spread;
  const float* ex;
  const float* nrm;
  const long long* truth_row;
  float trapping;
  bool vec;                     // ex, nrm, e_t and e_row 16-byte aligned
};

constexpr int kElectronSteps = 1;   // tiles of 1,024 electrons

__global__ void __launch_bounds__(tiles::kThreads)
    s2_electron_times_kernel(ElectronIn in, int* __restrict__ e_t,
                             long long* __restrict__ e_row) {
  using namespace tiles;
  constexpr int R = kElectronSteps;
  constexpr long long kTile = static_cast<long long>(kStep) * R;
  __shared__ __align__(16) unsigned marks[kTile];
  __shared__ unsigned tot[R * kWarps];
  const long long a = static_cast<long long>(blockIdx.x) * kTile;
  const long long b = a + kTile < in.n ? a + kTile : in.n;
  long long c0, c1;
  warp_counts(in.e_edges, in.I, in.n, a, b - 1, c0, c1);
  const long long s0 = c0 - 1, s1 = c1 - 1;
  if (s0 == s1 && !in_range(s0, in.I)) return;   // the whole block
  const TileIds ids = find_ids<R>(
      marks, tot, s0, s1, a,
      [&](long long s) { return edge(in.e_edges, s, in.n); });
  long long cur = -1;
  int ti = 0;
  float mi = 0.0f, si = 0.0f;
  long long row = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long j0 = a + 4 * (threadIdx.x + kThreads * r);
    const float4 e4 = load4f(in.ex, j0, b, in.vec);
    const float4 n4 = load4f(in.nrm, j0, b, in.vec);
    const float ex[4] = {e4.x, e4.y, e4.z, e4.w};
    const float nr[4] = {n4.x, n4.y, n4.z, n4.w};
    unsigned rel[4];
    ids.step(r, rel);
    int et[4];
    long long er[4];
    unsigned keep = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long id = s0 + rel[q];
      et[q] = 0;
      er[q] = 0;
      if (j0 + q < b && in_range(id, in.I)) {
        if (id != cur) {
          cur = id;
          ti = __ldg(in.time + cur);
          mi = __ldg(in.mean + cur);
          si = __ldg(in.spread + cur);
          row = __ldg(in.truth_row + cur);
        }
        const float timing = __fadd_rn(__fmul_rn(ex[q], in.trapping),
                                       __fadd_rn(__fmul_rn(nr[q], si), mi));
        et[q] = ti + static_cast<int>(timing);
        er[q] = row;
        keep |= 1u << q;
      }
    }
    store4(e_t, j0, et, keep, in.vec);
    store4(e_row, j0, er, keep, in.vec);
  }
}

struct PhotonIn {
  const float* inv;             // (I, Q) inverse CDFs, or null with t_lum
  int Q;
  const long long* e_edges;     // (I+1,)
  long long I;
  const long long* e_ph_edges;  // (E+1,)
  long long E;
  long long n;                  // photons
  const int* e_t;
  const long long* truth_row;
  const float* u_lum;
  const int* t_lum;
  const float* u_st;
  const float* ex_st;
  const float* nrm_ts;
  float singlet_fraction, t_singlet, t_triplet, time_spread;
  bool vec;                     // every photon field 16-byte aligned
};

// the first photon of instruction i (clamped), through its first electron
__device__ __forceinline__ long long first_photon(const PhotonIn& in,
                                                  long long i) {
  return tiles::edge(in.e_ph_edges, tiles::edge(in.e_edges, i, in.E), in.n);
}

// the tile's instructions' inverse CDFs (Q floats each) copied to `rows`
// where they are all in range, their edges found in registers (so `rows`,
// the instructions' marks' buffer, is free) and they fit its `cap` words: a
// warp's photons read 32 random columns, a few bank conflicts from shared
// memory against ~20-30 distinct L1 lines from the table; the block syncs
__device__ __forceinline__ bool stage_inv(const PhotonIn& in, float* rows,
                                          long long i0, long long i1,
                                          long long cap) {
  const long long n = (i1 - i0 + 1) * in.Q;
  if (in.t_lum != nullptr || i0 < 0 || i1 >= in.I ||
      i1 - i0 > tiles::kRegEdges || n > cap)
    return false;
  const float* src = in.inv + i0 * in.Q;
  for (long long c = threadIdx.x; c < n; c += tiles::kThreads)
    rows[c] = __ldg(src + c);
  __syncthreads();
  return true;
}

constexpr int kPhotonSteps = 4;     // tiles of 4,096 photons

__global__ void __launch_bounds__(tiles::kThreads)
    s2_photon_times_kernel(PhotonIn in, int* __restrict__ t,
                           long long* __restrict__ ph_row) {
  using namespace tiles;
  constexpr int R = kPhotonSteps;
  constexpr long long kTile = static_cast<long long>(kStep) * R;
  // the electrons' marks, then the instructions' marks or staged rows
  __shared__ __align__(16) unsigned marks[2 * kTile];
  __shared__ unsigned tot[R * kWarps];
  const long long a = static_cast<long long>(blockIdx.x) * kTile;
  const long long b = a + kTile < in.n ? a + kTile : in.n;
  long long c0, c1, d0, d1;
  warp_counts(in.e_ph_edges, in.E, in.n, a, b - 1, c0, c1);
  const long long k0 = c0 - 1, k1 = c1 - 1;   // electrons
  warp_counts(in.e_edges, in.I, in.E, k0, k1, d0, d1);
  const long long i0 = d0 - 1, i1 = d1 - 1;   // instructions
  if (k0 == k1 && !(in_range(k0, in.E) && in_range(i0, in.I))) return;
  const TileIds e_ids = find_ids<R>(
      marks, tot, k0, k1, a,
      [&](long long s) { return edge(in.e_ph_edges, s, in.n); });
  const TileIds i_ids = find_ids<R>(
      marks + kTile, tot, i0, i1, a,
      [&](long long i) { return first_photon(in, i); });
  float* staged = reinterpret_cast<float*>(marks + kTile);
  const bool from_shared = stage_inv(in, staged, i0, i1, kTile);
  const float qm1 = static_cast<float>(in.Q - 1);
  long long cur_e = -1, cur_i = -1;
  int et = 0;
  long long row = 0;
  const float* row_inv = nullptr;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long j0 = a + 4 * (threadIdx.x + kThreads * r);
    int lum[4] = {0, 0, 0, 0};
    float ul[4] = {0.0f, 0.0f, 0.0f, 0.0f}, nr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (in.t_lum != nullptr) {
      const int4 v = load4i(in.t_lum, j0, b, in.vec);
      lum[0] = v.x, lum[1] = v.y, lum[2] = v.z, lum[3] = v.w;
    } else {
      const float4 v = load4f(in.u_lum, j0, b, in.vec);
      ul[0] = v.x, ul[1] = v.y, ul[2] = v.z, ul[3] = v.w;
    }
    const float4 s4 = load4f(in.u_st, j0, b, in.vec);
    const float4 e4 = load4f(in.ex_st, j0, b, in.vec);
    if (in.nrm_ts != nullptr) {
      const float4 v = load4f(in.nrm_ts, j0, b, in.vec);
      nr[0] = v.x, nr[1] = v.y, nr[2] = v.z, nr[3] = v.w;
    }
    const float us[4] = {s4.x, s4.y, s4.z, s4.w};
    const float ex[4] = {e4.x, e4.y, e4.z, e4.w};
    int tt[4];
    long long rr[4];
    unsigned keep = 0;
    unsigned ke[4], ki[4];
    e_ids.step(r, ke);
    i_ids.step(r, ki);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long k = k0 + ke[q], i = i0 + ki[q];
      tt[q] = 0;
      rr[q] = 0;
      if (j0 + q < b && in_range(k, in.E) && in_range(i, in.I)) {
        if (k != cur_e) {
          cur_e = k;
          et = __ldg(in.e_t + k);
        }
        if (i != cur_i) {
          cur_i = i;
          row = __ldg(in.truth_row + i);
          row_inv = from_shared ? staged + (i - i0) * in.Q : in.inv + i * in.Q;
        }
        int v = lum[q];
        if (in.t_lum == nullptr) {
          const float uq = __fmul_rn(ul[q], qm1);
          long long lo = static_cast<long long>(floorf(uq));
          lo = lo < in.Q - 2 ? lo : in.Q - 2;
          const float w = __fsub_rn(uq, static_cast<float>(lo));
          v = static_cast<int>(
              __fadd_rn(__fmul_rn(row_inv[lo], __fsub_rn(1.0f, w)),
                        __fmul_rn(row_inv[lo + 1], w)));
        }
        const float life =
            us[q] < in.singlet_fraction ? in.t_singlet : in.t_triplet;
        v += static_cast<int>(__fmul_rn(ex[q], life));
        if (in.nrm_ts != nullptr)
          v += static_cast<int>(__fmul_rn(nr[q], in.time_spread));
        tt[q] = v + et;
        rr[q] = row;
        keep |= 1u << q;
      }
    }
    store4(t, j0, tt, keep, in.vec);
    store4(ph_row, j0, rr, keep, in.vec);
  }
}

}  // namespace

// n photons: kS1Head a block per instruction plus tiles of kS1Tile; t (n,)
// int32 and ph_row (n,) int64, each photon below the clamped last edge
// written; ex and nrm both given (the simple model) or both null, custom
// and nest each given or null
extern "C" int wfsim_s1_photon_times(const void* time, const void* edges,
                                     const void* truth_row, int n_inst, int n,
                                     const void* ex, const void* nrm,
                                     const void* nest, const void* custom,
                                     float decay_time, float decay_spread,
                                     void* t, void* ph_row, void* stream) {
  if (n_inst <= 0 || n < 0 || (ex == nullptr) != (nrm == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  S1In in;
  in.time = static_cast<const int*>(time);
  in.edges = static_cast<const long long*>(edges);
  in.truth_row = static_cast<const long long*>(truth_row);
  in.ex = static_cast<const float*>(ex);
  in.nrm = static_cast<const float*>(nrm);
  in.custom = static_cast<const float*>(custom);
  in.nest = static_cast<const float*>(nest);
  in.I = n_inst;
  in.n = n;
  in.tiles = (n + kS1Tile - 1) / kS1Tile;
  in.decay_time = decay_time;
  in.decay_spread = decay_spread;
  in.vec = tiles::aligned16(ex) && tiles::aligned16(nrm) &&
           tiles::aligned16(custom) && tiles::aligned16(nest) &&
           tiles::aligned16(t) && tiles::aligned16(ph_row);
  const long long grid = in.tiles + n_inst;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int* tp = static_cast<int*>(t);
  long long* rp = static_cast<long long*>(ph_row);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid);
  switch ((ex != nullptr) << 2 | (custom != nullptr) << 1 |
          (nest != nullptr)) {
    case 0: return launch_s1<false, false, false>(in, g, tp, rp, st);
    case 1: return launch_s1<false, false, true>(in, g, tp, rp, st);
    case 2: return launch_s1<false, true, false>(in, g, tp, rp, st);
    case 3: return launch_s1<false, true, true>(in, g, tp, rp, st);
    case 4: return launch_s1<true, false, false>(in, g, tp, rp, st);
    case 5: return launch_s1<true, false, true>(in, g, tp, rp, st);
    case 6: return launch_s1<true, true, false>(in, g, tp, rp, st);
    default: return launch_s1<true, true, true>(in, g, tp, rp, st);
  }
}

// n electrons; e_t (n,) int32 and e_row (n,) int64, each element below
// the clamped last edge written
extern "C" int wfsim_s2_electron_times(const void* time, const void* e_edges,
                                       int n_inst, int n, const void* mean,
                                       const void* spread, const void* ex,
                                       const void* nrm, const void* truth_row,
                                       float trapping, void* e_t,
                                       void* e_row, void* stream) {
  if (n_inst <= 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  ElectronIn in;
  in.time = static_cast<const int*>(time);
  in.e_edges = static_cast<const long long*>(e_edges);
  in.I = n_inst;
  in.n = n;
  in.mean = static_cast<const float*>(mean);
  in.spread = static_cast<const float*>(spread);
  in.ex = static_cast<const float*>(ex);
  in.nrm = static_cast<const float*>(nrm);
  in.truth_row = static_cast<const long long*>(truth_row);
  in.trapping = trapping;
  in.vec = tiles::aligned16(ex) && tiles::aligned16(nrm) &&
           tiles::aligned16(e_t) && tiles::aligned16(e_row);
  constexpr long long kTile =
      static_cast<long long>(tiles::kStep) * kElectronSteps;
  s2_electron_times_kernel<<<static_cast<unsigned>((n + kTile - 1) / kTile),
                             tiles::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<int*>(e_t), static_cast<long long*>(e_row));
  return static_cast<int>(cudaGetLastError());
}

// n photons of n_e electrons in tiles of 4,096; t (n,) int32 and ph_row
// (n,) int64, each photon below the clamped last edges written
extern "C" int wfsim_s2_photon_times(
    const void* inv, int Q, const void* e_edges, int n_inst,
    const void* e_ph_edges, int n_e, int n, const void* e_t,
    const void* truth_row, const void* u_lum, const void* t_lum,
    const void* u_st, const void* ex_st, const void* nrm_ts,
    float singlet_fraction, float t_singlet, float t_triplet,
    float time_spread, void* t, void* ph_row, void* stream) {
  if (n_inst <= 0 || n_e < 0 || n < 0 ||
      (t_lum == nullptr && (Q < 2 || inv == nullptr || u_lum == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  PhotonIn in;
  in.inv = static_cast<const float*>(inv);
  in.Q = Q;
  in.e_edges = static_cast<const long long*>(e_edges);
  in.I = n_inst;
  in.e_ph_edges = static_cast<const long long*>(e_ph_edges);
  in.E = n_e;
  in.n = n;
  in.e_t = static_cast<const int*>(e_t);
  in.truth_row = static_cast<const long long*>(truth_row);
  in.u_lum = static_cast<const float*>(u_lum);
  in.t_lum = static_cast<const int*>(t_lum);
  in.u_st = static_cast<const float*>(u_st);
  in.ex_st = static_cast<const float*>(ex_st);
  in.nrm_ts = static_cast<const float*>(nrm_ts);
  in.singlet_fraction = singlet_fraction;
  in.t_singlet = t_singlet;
  in.t_triplet = t_triplet;
  in.time_spread = time_spread;
  in.vec = tiles::aligned16(u_lum) && tiles::aligned16(t_lum) &&
           tiles::aligned16(u_st) && tiles::aligned16(ex_st) &&
           tiles::aligned16(nrm_ts) && tiles::aligned16(t) &&
           tiles::aligned16(ph_row);
  constexpr long long kTile = static_cast<long long>(tiles::kStep) *
                              kPhotonSteps;
  s2_photon_times_kernel<<<static_cast<unsigned>((n + kTile - 1) / kTile),
                           tiles::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<int*>(t), static_cast<long long*>(ph_row));
  return static_cast<int>(cudaGetLastError());
}
