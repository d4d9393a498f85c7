// superpose_adc: photons -> SPE current superposition -> ADC int16 grid.
//
// Replaces: wfsim_tpu/ops/waveform.py:68 photons_to_waveform (phase
// histogram + :146 _conv_templates_mxu banded matmul) together with the
// slim-grid epilogue of wfsim_tpu/pipeline/digitize.py:299-319 (ADC
// conversion, noise overlay, baseline inside the channel window, clip at 0,
// int16 cast), and the noise-bank read of digitize.py:67 _noise_gather
// (with ops/gather.py:53 gather_spans).  The second entry point,
// wfsim_superpose_adc_full, replaces the full-grid branch of
// wfsim_tpu/pipeline/digitize.py:341-435 (and the one-window
// digitize_window of :96): the whole XENONnT digitizer, 801 rows a window,
// or in its mode without HE rows the XENON1T grid.
//
// What bounds it on the H100: writing the int16 grid (B*494 rows x T
// samples, 2 bytes each; B*801 rows on the full grid) plus the noise
// reads.  The TPU form built a float32 (rows, 10, T) histogram in HBM and
// contracted it on the MXU; here no float grid reaches device memory.
//
// Design (both entries).  A warp owns a tile of kSpan = 1024 samples of
// one row (two warps a row at 2048 samples): blocks of kWarps warps, a 1-d
// grid over (row, tile), so a warp finds its row, tile, window and channel
// with one division each.  A row's tiles start at its first 16-byte
// boundary in the output.  The warp accumulates its tile in shared memory
// (float32, 4 KB).  The scatter: the warp reads its row's photons 32 at a
// time, a lane each (the next 32's loads issued before this 32's adds; s =
// t / dt and r = t - s * dt, with dt = 10 and the template length 22 as
// template arguments), ballots those whose taps reach the tile, and walks
// them in row order.  Lane l adds the tap that lands on a sample u = lo + l
// mod 32: a sample is only ever added to by one lane, so it sees its
// photons in row order by that lane's program order, with no sync between
// photons, and a photon's 22 taps go to 22 lanes (each lane on its own
// shared-memory bank).  A step forms the products of kPerStep = 4 photons
// (shuffles and template reads overlapped), then adds them in order: the
// chain a photon is one shared-memory add.  A sample costs ~22 products a
// photon that touches it, where a thread a sample (the earlier design)
// tested every photon of its row for every sample; a
// row of thousands of photons (one S2 of 10^6 photons in a window) is
// split between its tiles' warps.  The epilogue reads the tile back 8
// samples a lane (two float4 loads) and stores 16-byte int16 vectors: a
// warp writes 512 contiguous bytes a store.  A sample before the row
// start or past its end is skipped, and a group that is not 16-byte
// aligned in its output row (an HE row at a row length that is not a
// multiple of 8) is stored sample by sample.  The noise index is one
// modulo a group of 8, then a step with wrap.  The 10 x 22 template bank
// is loaded once a block (dynamic shared memory).
//
// Numerics: each sample sums gain*T[t%10][u - t/10] over its row's photons
// in their sorted order with __fmul_rn/__fadd_rn from 0.0f (no FMA
// contraction and no atomics), so the result is deterministic and bitwise
// equal to the plain twin superpose_adc_ref, which adds the same products
// in the same order (photon i of every row at step i).  The JAX package
// sums per histogram bin first and then contracts, so an ADC value within
// an f32 ulp of a .5 tie may round the other way; the tests count such
// tie samples and require 0 at their seeds.
//
// Noise (realistic config): row (w, c) of the batch, for c < Cn, adds at
// in-window sample u the bank value bank[c, (noise_ix[w] + u - left) % L]
// (reference rawdata.py:407-431).  The TPU read one contiguous span per
// row from a wrap-extended copy of the bank; here the lane that owns u
// reads one int16 of the plain channel-major bank (Cn, L).  The index is
// formed only in the window, where u >= left, in unsigned arithmetic: it
// cannot wrap while 0 <= noise_ix < 2^30 and L < 2^30, and it stays inside
// the bank even where noise_ix is out of range (the kernel flags that).
// Integer adds are associative, so adc + noise + baseline is bitwise the
// twin's sum in any order.  With no bank (bank == nullptr) the kernel is
// the noise-free one.
//
// Full grid (wfsim_superpose_adc_full).  Rows of window w: the TPC
// channels 0..C-1; the high-energy copies of the n_top top-array channels
// on he_lo..he_lo+n_top-1 (adc * deamp with TPC row c's window, noise from
// bank column he_lo + c, baseline, clip); the bottom-array sum on sum_ch
// (the sum over c >= n_top of adc * deamp, unmasked: no noise, no
// baseline, no clip); every other row 0.  The JAX package concatenates
// int32 (B, rows, T) blocks and takes elementwise passes over the whole
// int32 grid.  Here the warp of TPC row c computes the superposition once
// and writes both TPC row c and, for c < n_top, HE row he_lo + c; for
// c >= n_top it adds adc * deamp into the window's int32 sum row by
// integer atomics (skipped where it is 0).  Integer addition is
// associative modulo 2^32, so the sum is bitwise the twin's in any order.
// Further warps of the same launch zero the gap rows; one small follow-on
// launch casts the sum rows to int16 once every atomic has landed, so no
// int32 (B, 801, T) grid ever reaches device memory: only the (B, T) int32
// sum scratch.  Integer semantics are XLA's: adc * deamp and the adds wrap
// modulo 2^32 (done in unsigned arithmetic, where C++ defines the wrap)
// and the int16 stores keep the low 16 bits, as astype(int16) does.
// wfsim_tpu runs ZLE on the int32 grid; the port's ZLE reads the int16
// grid with in-window negatives taken as never below threshold
// (zle_intervals.cu), which is exact while every in-window value is below
// 2^16.  A value at or above 2^16 sets a bit of the status word.
//
// Full grid without HE rows (wfsim_tpu digitize.py:346-391 with he_on
// false: XENON1T, 248 TPC rows in an 801-row window).  The same entry with
// n_he = 0 copies, he_lo = n_ch and no sum row (sum_ch = -1, no sum
// scratch): one launch writes the TPC rows and zeroes rows
// n_ch..n_all-1.  Those rows have no window, so they get no noise even
// where the bank is wider than the TPC (digitize.py:399-403).
//
// The status word.  Every entry clears one int32 word and the kernel ORs
// into it: kNegativeTime where a photon time is < 0 (C's / and % truncate
// where jnp's floor; such a photon adds nothing), kBadNoiseIx where a
// window's noise_ix lies outside [0, 2^30), kOverflow as above.  The
// wrapper reads the word back once a call and raises.
//
// Channel block of the multi-device step (wfsim_superpose_block, K14).
// Replaces the per-shard digitization of wfsim_tpu/parallel/sharding.py:
// 101-117 make_sharded_step: photons_to_waveform of the shard's PMT block,
// adc = -round(W * current_2_adc) as int32, and the block's bottom-array
// partial sum that the psum over 'channels' completes.  No window, no
// noise, no baseline, no clip, no int16 storage.  What bounds it on the
// H100: writing the int32 grid, 4 bytes a (row, sample), 129.5 MB at 494
// rows x 2^16 samples (0.039 ms), nearly all of it zeros; the collective
// itself (all_reduce of the (B, T) sum rows) is NCCL's or gloo's, as the
// JAX package left the psum to XLA.  The design is the row kernels' above,
// cut to what the step needs.  A warp owns a tile of kSpan samples of one
// row (row-major over (row, tile), so a block's four warps share a row's
// photons in L1); a row's tiles start at its first 16-byte boundary.  The
// scan: 128 photons a step, four a lane (lane l photons base + l + 32 q),
// the next step's times loaded before this step's tests, one ballot per
// 32; a step without a hit costs a few instructions a photon and no
// shared memory.  Photons within a row are in row order, not time order,
// so every tile of a row scans the whole row: a row of ~200 photons (the
// bench shard) costs 64 tiles two steps each, a row of 10^5 photons 782
// steps in each of its tiles, side by side on as many SMs.  At the first
// hit the warp zeroes its tile in shared memory; hits add their taps by
// add_taps, in row order (F4: bitwise the twin superpose_block_ref), the
// gain read only by the lane that holds the photon.  The epilogue stores
// -rint(acc * c2a) four samples a lane as one 16-byte vector, a warp's
// 512 bytes contiguous; a tile without a hit stores zeros without
// touching shared memory.  A row of a bottom-array channel (n_top <=
// ch_block + c < n_tpc) adds its non-zero samples into the instruction
// block's int32 sum row by integer atomics (exact in any order); padding
// rows past n_tpc have no photons and no part in the sum.  The entry
// clears the sum rows and the status word behind them (kNegativeTime
// where a photon time is < 0: the wrapper reads it back once a call).
//
// What was measured (device time on an H100, chip_smoke.py's step shard,
// 494 rows x 2^16 samples, and its copy whose row 300 holds 10^5 photons
// spread over the shard's events; PERF.md has the calls): warps of 2,048
// or 4,096 samples lost on both; a row-range skip would spare 15 % of the
// shard's tiles and none of the copy's; a block of four tiles scanning the
// row once into hit lists in shared memory took the copy from 1.29 to
// 0.38 ms but the shard from 0.056 to 0.062 ms (registers and 33 KB of
// shared memory a block).  The step's rows hold ~200 photons each; the
// 10^5-photon row is a stress case that no workload of the repo makes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTemplate = 1024;

constexpr int kWarps = 4;             // warps a block of the row kernels
constexpr int kSpan = 1024;           // samples a warp: 4 groups of 8 a lane
constexpr int kPerStep = 4;           // photons a step of the scatter
constexpr unsigned kAll = 0xffffffffu;

// bits of the status word (ops/waveform.py reads them)
constexpr int kOverflow = 1;
constexpr int kNegativeTime = 2;
constexpr int kBadNoiseIx = 4;

__device__ __forceinline__ void load_templates(float* tmpl,
                                               const float* templates, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) tmpl[i] = templates[i];
  __syncthreads();
}

// int32 add and multiply that wrap modulo 2^32, as XLA's do
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// what both row kernels read: the photons sorted by row, the windows, the
// epilogue constants, the bank, and (full grid) the layout
struct RowArgs {
  const int* t;
  const float* gain;
  const int* row_ptr;
  int n_rows;                 // rows with photons (B * n_ch on the full grid)
  int n_photons;
  int n_samples;
  const float* templates;
  int dt, tlen;
  const int* ch_left;
  const int* ch_right;
  const unsigned char* has;
  float c2a;
  int baseline;
  const short* bank;          // (bank_ch, bank_len) int16, or null
  int bank_len, bank_ch;
  const int* noise_ix;        // (B,), with a bank
  int n_ch;                   // rows a window (0: slim grid without a bank)
  int n_seg;                  // kSpan-sample tiles a row
  int n_all, n_top, n_he, he_lo, sum_ch, deamp;
  int n_zero;                 // zero rows a window the main launch writes
  int* sum32;                 // (B, n_samples) or null
  int* status;
  short* out;
};

// samples from the row start to its first 16-byte boundary in memory, as
// a negative origin: sample u is aligned where (u - origin) % 8 == 0
__device__ __forceinline__ int row_origin(const short* row) {
  return -static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 1) & 7);
}

// samples u0..u0+7 of a row of n: one 16-byte store where the group lies
// inside the row on a 16-byte boundary, else the samples inside the row
__device__ __forceinline__ void store8(short* row, int u0, const int (&v)[8],
                                       int n) {
  if (u0 >= 0 && u0 + 8 <= n &&
      (reinterpret_cast<uintptr_t>(row + u0) & 15) == 0) {
    unsigned q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = (static_cast<unsigned>(v[2 * j]) & 0xffffu) |
             (static_cast<unsigned>(v[2 * j + 1]) << 16);
    *reinterpret_cast<uint4*>(row + u0) = make_uint4(q[0], q[1], q[2], q[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (u0 + j >= 0 && u0 + j < n) row[u0 + j] = static_cast<short>(v[j]);
}

__device__ __forceinline__ void zero_row(short* row, int n, int lane) {
  const int zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int u0 = row_origin(row) + 8 * lane; u0 < n; u0 += 256)
    store8(row, u0, zero, n);
}

// photon times < 0 flag the status word; a photon outside every row
// ([0, row_ptr[0]) and [row_ptr[n_rows], n)) is checked by the first warp
__device__ __forceinline__ int stray_negative_times(const int* t,
                                                    const int* row_ptr,
                                                    int n_rows, int n,
                                                    int lane) {
  int bad = 0;
  for (int p = lane; p < row_ptr[0]; p += 32)
    if (t[p] < 0) bad = kNegativeTime;
  for (int p = row_ptr[n_rows] + lane; p < n; p += 32)
    if (t[p] < 0) bad = kNegativeTime;
  return bad;
}

// The taps of the photons of `todo` (lane j holds photon j's s = t / dt,
// r = t - s * dt and gain g) added into the tile of samples [lo, hi),
// photon by photon in lane order.  Lane l adds the taps that land on
// samples u = lo + l mod 32, so each sample sees its photons in that order
// by the lane's program order; with TL <= 32 a step forms the products of
// kPerStep photons, then adds them in order.
template <int TL>
__device__ __forceinline__ void add_taps(float* tile, unsigned todo, int s,
                                         int r, float g, int lo, int hi,
                                         const float* tmpl, int tlen,
                                         int lane) {
  if constexpr (TL > 0 && TL <= 32) {
    while (todo) {                  // one tap a lane at most
      int ux[kPerStep];
      float qx[kPerStep];
      bool ok[kPerStep];
#pragma unroll
      for (int m = 0; m < kPerStep; ++m) {
        const bool have = todo != 0;
        const int j = have ? __ffs(todo) - 1 : 0;
        if (have) todo &= todo - 1;
        const int sj = __shfl_sync(kAll, s, j);
        const int rj = __shfl_sync(kAll, r, j);
        const float gj = __shfl_sync(kAll, g, j);
        const int k = (lo + lane - sj) & 31;
        ux[m] = sj + k - lo;
        ok[m] = have && k < TL && ux[m] >= 0 && sj + k < hi;
        qx[m] = ok[m] ? __fmul_rn(gj, tmpl[rj * TL + k]) : 0.0f;
      }
#pragma unroll
      for (int m = 0; m < kPerStep; ++m)
        if (ok[m]) tile[ux[m]] = __fadd_rn(tile[ux[m]], qx[m]);
    }
  } else {
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int sj = __shfl_sync(kAll, s, j);
      const int rj = __shfl_sync(kAll, r, j);
      const float gj = __shfl_sync(kAll, g, j);
      for (int k = (lo + lane - sj) & 31; k < tlen; k += 32) {
        const int u = sj + k;
        if (u >= lo && u < hi)
          tile[u - lo] = __fadd_rn(tile[u - lo],
                                   __fmul_rn(gj, tmpl[rj * tlen + k]));
      }
    }
  }
}

// A warp a tile of kSpan samples of a row (see the file header); warps
// past the rows' tiles (full grid) zero the gap rows, n_zero a window, the
// sum row skipped (the follow-on launch writes it).
template <int DT, int TL, bool FULL>
__global__ void __launch_bounds__(kWarps * 32)
    superpose_rows_kernel(const RowArgs a) {
  extern __shared__ float tmpl[];
  __shared__ __align__(16) float tiles[kWarps * kSpan];
  const int dt = DT > 0 ? DT : a.dt;
  const int tlen = TL > 0 ? TL : a.tlen;
  load_templates(tmpl, a.templates, dt * tlen);

  const int lane = threadIdx.x & 31;
  float* tile = tiles + (threadIdx.x >> 5) * kSpan;
  float4* tile4 = reinterpret_cast<float4*>(tile);
  const long long gw = static_cast<long long>(blockIdx.x) * kWarps +
                       (threadIdx.x >> 5);
  const int T = a.n_samples;
  const long long n_items = static_cast<long long>(a.n_rows) * a.n_seg;
  if (gw >= n_items) {
    const long long j = gw - n_items;
    if (!FULL || j >= static_cast<long long>(a.n_rows / a.n_ch) * a.n_zero)
      return;                          // the last block's spare warps
    const int w = static_cast<int>(j / a.n_zero);
    const int k = static_cast<int>(j - static_cast<long long>(w) * a.n_zero);
    const int gap1 = a.he_lo - a.n_ch;
    int r = k < gap1 ? a.n_ch + k : a.he_lo + a.n_he + (k - gap1);
    if (a.sum_ch >= 0 && r >= a.sum_ch) ++r;
    if (r < a.n_all)
      zero_row(a.out + (static_cast<long long>(w) * a.n_all + r) * T, T,
               lane);
    return;
  }
  const int row = static_cast<int>(gw / a.n_seg);
  const int seg = static_cast<int>(gw - static_cast<long long>(row) * a.n_seg);
  const int w = a.n_ch > 0 ? row / a.n_ch : 0;
  const int c = row - w * a.n_ch;
  short* out_row = a.out + (FULL ? static_cast<long long>(w) * a.n_all + c
                                 : static_cast<long long>(row)) * T;
  // the tile's samples [lo, hi), lo on a 16-byte boundary of out_row
  const int lo = row_origin(out_row) + seg * kSpan;
  if (lo >= T) return;                 // a row that starts on a boundary
  const int hi = min(lo + kSpan, T);
  short* he_row = FULL && c < a.n_he
      ? a.out + (static_cast<long long>(w) * a.n_all + a.he_lo + c) * T
      : nullptr;
  int* sum_row = FULL && a.sum32 != nullptr && c >= a.n_top
      ? a.sum32 + static_cast<long long>(w) * T : nullptr;
  const int p0 = a.row_ptr[row];
  const int p1 = a.row_ptr[row + 1];
  const int left = a.ch_left[row];
  const int right = a.ch_right[row];
  const bool has = a.has[row] != 0;
  const short* bank_tpc = a.bank != nullptr && c < a.bank_ch
      ? a.bank + static_cast<long long>(c) * a.bank_len : nullptr;
  const short* bank_he = a.bank != nullptr && he_row != nullptr &&
                         a.he_lo + c < a.bank_ch
      ? a.bank + static_cast<long long>(a.he_lo + c) * a.bank_len : nullptr;
  const unsigned L = static_cast<unsigned>(a.bank_len);
  const bool any = p1 > p0;

  int bad = gw == 0 ? stray_negative_times(a.t, a.row_ptr, a.n_rows,
                                           a.n_photons, lane)
                    : 0;
  unsigned nix = 0;
  if (a.noise_ix != nullptr) {
    const int x = a.noise_ix[w];
    if (x < 0 || x >= (1 << 30)) bad |= kBadNoiseIx;
    nix = static_cast<unsigned>(x);
  }

  // the scatter: photons in row order, each photon's taps in [lo, hi)
  if (any) {
    for (int i = lane; i < kSpan / 4; i += 32)
      tile4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncwarp();
    // the next 32 photons' loads are issued before this 32's adds
    int t_next = p0 + lane < p1 ? a.t[p0 + lane] : 0;
    float g_next = p0 + lane < p1 ? a.gain[p0 + lane] : 0.0f;
    for (int base = p0; base < p1; base += 32) {
      const int tt = t_next;
      const float g = g_next;
      if (base + 32 + lane < p1) {
        t_next = a.t[base + 32 + lane];
        g_next = a.gain[base + 32 + lane];
      }
      int s = 0, r = 0;
      bool hit = false;
      if (base + lane < p1) {
        if (tt < 0) {
          bad |= kNegativeTime;
        } else {
          s = tt / dt;
          r = tt - s * dt;
          hit = s + tlen > lo && s < hi;
        }
      }
      add_taps<TL>(tile, __ballot_sync(kAll, hit), s, r, g, lo, hi, tmpl,
                   tlen, lane);
    }
    __syncwarp();
  }

  // the epilogue: groups of 8 samples, u0..u0+7, a lane at a time
  for (int grp = lane; 8 * grp < hi - lo; grp += 32) {
    const int u0 = lo + 8 * grp;
    float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (any) {
      const float4 x0 = tile4[2 * grp];
      const float4 x1 = tile4[2 * grp + 1];
      acc[0] = x0.x; acc[1] = x0.y; acc[2] = x0.z; acc[3] = x0.w;
      acc[4] = x1.x; acc[5] = x1.y; acc[6] = x1.z; acc[7] = x1.w;
    }
    // the group's in-window samples ua..ub and the bank index of ua
    const int ua = max(u0, left);
    const int ub = min(u0 + 7, right);
    const bool any_in = has && ua <= ub;
    unsigned m = 0;
    if (any_in && a.bank != nullptr)
      m = (nix + static_cast<unsigned>(ua - left)) % L;
    int v[8], h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int u = u0 + j;
      const int adc = -__float2int_rn(__fmul_rn(acc[j], a.c2a));
      const bool in = any_in && u >= ua && u <= ub;
      int x = adc;
      if (in) {
        if (bank_tpc != nullptr) x += bank_tpc[m];
        x += a.baseline;
        x = x < 0 ? 0 : x;
        if (FULL && x >= 65536) bad |= kOverflow;
      }
      v[j] = x;
      if (FULL) {
        const int he = wrap_mul(adc, a.deamp);
        h[j] = he;
        if (he_row != nullptr) {
          if (in) {
            int y = he;
            if (bank_he != nullptr) y = wrap_add(y, bank_he[m]);
            y = wrap_add(y, a.baseline);
            y = y < 0 ? 0 : y;
            if (y >= 65536) bad |= kOverflow;
            h[j] = y;
          }
        } else if (sum_row != nullptr && he != 0 && u >= 0 && u < T) {
          atomicAdd(sum_row + u, he);
        }
      }
      if (in && a.bank != nullptr) m = m + 1 == L ? 0u : m + 1;
    }
    store8(out_row, u0, v, T);
    if (FULL && he_row != nullptr) store8(he_row, u0, h, T);
  }

  const unsigned st = __reduce_or_sync(kAll, static_cast<unsigned>(bad));
  if (lane == 0 && st != 0) atomicOr(a.status, static_cast<int>(st));
}

// the sum rows of the full grid: int32 sums, low 16 bits, a thread a
// group of 8 samples (n_grp a window)
__global__ void __launch_bounds__(kWarps * 32)
    sum_rows_kernel(int n_win, int n_samples, int n_all, int sum_ch,
                    int n_grp, const int* __restrict__ sum32,
                    short* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(n_win) * n_grp) return;
  const int w = static_cast<int>(i / n_grp);
  const int g = static_cast<int>(i - static_cast<long long>(w) * n_grp);
  const int T = n_samples;
  short* row = out + (static_cast<long long>(w) * n_all + sum_ch) * T;
  const int* src = sum32 + static_cast<long long>(w) * T;
  const int u0 = row_origin(row) + 8 * g;
  int v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = u0 + j >= 0 && u0 + j < T ? src[u0 + j] : 0;
  store8(row, u0, v, T);
}

// the rows' tiles: kSpan samples each from the row's first 16-byte
// boundary in out (one more where a row does not start on one)
int tiles_a_row(int n_samples, const void* out) {
  const bool aligned = n_samples % 8 == 0 &&
                       (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  return (n_samples + (aligned ? 0 : 7) + kSpan - 1) / kSpan;
}

template <bool FULL>
cudaError_t launch_rows(const RowArgs& a, long long warps, cudaStream_t s) {
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(a.dt) * a.tlen * sizeof(float);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (a.dt == 10 && a.tlen == 22)
    superpose_rows_kernel<10, 22, FULL><<<grid, kWarps * 32, smem, s>>>(a);
  else
    superpose_rows_kernel<0, 0, FULL><<<grid, kWarps * 32, smem, s>>>(a);
  return cudaGetLastError();
}

// what the channel-block kernel reads and writes (K14)
struct BlockArgs {
  const int* t;
  const float* gain;
  const int* row_ptr;
  int n_rows;                 // B * n_ch
  int n_photons;
  int n_samples;
  const float* templates;
  int dt, tlen;
  float c2a;
  int n_ch, ch_block, n_top, n_tpc;
  int n_seg;                  // kSpan-sample tiles a row
  int* adc;                   // (n_rows, n_samples)
  int* sums;                  // (B, n_samples)
  int* status;
};

// samples from an int32 row's start to its first 16-byte boundary in
// memory, as a negative origin
__device__ __forceinline__ int row_origin32(const int* row) {
  return -static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
}

constexpr int kScan = 4;              // photons a lane loads a scan step

// A warp a tile of kSpan samples of a row of the channel block (see the
// file header): the scan, the taps, the int32 epilogue and the sum row.
template <int DT, int TL>
__global__ void __launch_bounds__(kWarps * 32)
    superpose_block_kernel(const BlockArgs a) {
  extern __shared__ float tmpl[];
  __shared__ __align__(16) float tiles[kWarps * kSpan];
  const int dt = DT > 0 ? DT : a.dt;
  const int tlen = TL > 0 ? TL : a.tlen;
  load_templates(tmpl, a.templates, dt * tlen);

  const int lane = threadIdx.x & 31;
  float* tile = tiles + (threadIdx.x >> 5) * kSpan;
  float4* tile4 = reinterpret_cast<float4*>(tile);
  const long long gw = static_cast<long long>(blockIdx.x) * kWarps +
                       (threadIdx.x >> 5);
  if (gw >= static_cast<long long>(a.n_rows) * a.n_seg) return;
  const int row = static_cast<int>(gw / a.n_seg);
  const int seg = static_cast<int>(gw - static_cast<long long>(row) * a.n_seg);
  const int T = a.n_samples;
  int* out_row = a.adc + static_cast<long long>(row) * T;
  // the tile's samples [lo, hi), lo on a 16-byte boundary of out_row
  const int lo = row_origin32(out_row) + seg * kSpan;
  if (lo >= T) return;                 // a row that starts on a boundary
  const int hi = min(lo + kSpan, T);
  const int b = row / a.n_ch;
  const int ch = a.ch_block + (row - b * a.n_ch);
  int* sum_row = ch >= a.n_top && ch < a.n_tpc
      ? a.sums + static_cast<long long>(b) * T : nullptr;
  const int p0 = a.row_ptr[row];
  const int p1 = a.row_ptr[row + 1];
  int bad = gw == 0 ? stray_negative_times(a.t, a.row_ptr, a.n_rows,
                                           a.n_photons, lane)
                    : 0;

  // the scan: kScan * 32 photons a step, lane l holding photons base + l +
  // 32 q (row order is q, then lane), the next step's times loaded before
  // this step's tests; the tile is zeroed at its first hit and the gains
  // are read only by lanes with a hit
  bool any = false;
  int t_next[kScan];
#pragma unroll
  for (int q = 0; q < kScan; ++q) {
    const int p = p0 + 32 * q + lane;
    t_next[q] = p < p1 ? __ldg(a.t + p) : 0;
  }
  for (int base = p0; base < p1; base += 32 * kScan) {
    int s[kScan], r[kScan];
    unsigned hits[kScan];
    unsigned all = 0;
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      const int p = base + 32 * q + lane;
      const int tt = t_next[q];
      const int pn = p + 32 * kScan;
      t_next[q] = pn < p1 ? __ldg(a.t + pn) : 0;
      s[q] = 0;
      r[q] = 0;
      bool hit = false;
      if (p < p1) {
        if (tt < 0) {
          bad |= kNegativeTime;
        } else {
          s[q] = tt / dt;
          r[q] = tt - s[q] * dt;
          hit = s[q] + tlen > lo && s[q] < hi;
        }
      }
      hits[q] = __ballot_sync(kAll, hit);
      all |= hits[q];
    }
    if (all == 0) continue;            // the same in every lane
    if (!any) {
      for (int i = lane; i < kSpan / 4; i += 32)
        tile4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      __syncwarp();
      any = true;
    }
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      if (hits[q] == 0) continue;
      const int p = base + 32 * q + lane;
      const float g = hits[q] >> lane & 1 ? __ldg(a.gain + p) : 0.0f;
      add_taps<TL>(tile, hits[q], s[q], r[q], g, lo, hi, tmpl, tlen, lane);
    }
  }
  if (any) __syncwarp();

  // the epilogue: four samples a lane a step, a warp's 512 bytes
  // contiguous; an all-zero tile stores zeros without reading the tile
  for (int i = lane; 4 * i < hi - lo; i += 32) {
    const int u0 = lo + 4 * i;
    int v[4] = {0, 0, 0, 0};
    if (any) {
      const float4 x = tile4[i];
      v[0] = -__float2int_rn(__fmul_rn(x.x, a.c2a));
      v[1] = -__float2int_rn(__fmul_rn(x.y, a.c2a));
      v[2] = -__float2int_rn(__fmul_rn(x.z, a.c2a));
      v[3] = -__float2int_rn(__fmul_rn(x.w, a.c2a));
    }
    if (u0 >= 0 && u0 + 4 <= T) {
      *reinterpret_cast<int4*>(out_row + u0) = make_int4(v[0], v[1], v[2],
                                                         v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (u0 + j >= 0 && u0 + j < T) out_row[u0 + j] = v[j];
    }
    if (any && sum_row != nullptr) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (v[j] != 0 && u0 + j >= 0 && u0 + j < T)
          atomicAdd(sum_row + u0 + j, v[j]);
    }
  }

  const unsigned st = __reduce_or_sync(kAll, static_cast<unsigned>(bad));
  if (lane == 0 && st != 0) atomicOr(a.status, static_cast<int>(st));
}

RowArgs row_args(const void* t, const void* gain, const void* row_ptr,
                 int n_rows, int n_photons, int n_samples,
                 const void* templates, int dt, int tlen, const void* ch_left,
                 const void* ch_right, const void* has, float current_2_adc,
                 int baseline, const void* bank, int bank_len, int bank_ch,
                 const void* noise_ix, int n_ch, void* out) {
  RowArgs a{};
  a.t = static_cast<const int*>(t);
  a.gain = static_cast<const float*>(gain);
  a.row_ptr = static_cast<const int*>(row_ptr);
  a.n_rows = n_rows;
  a.n_photons = n_photons;
  a.n_samples = n_samples;
  a.templates = static_cast<const float*>(templates);
  a.dt = dt;
  a.tlen = tlen;
  a.ch_left = static_cast<const int*>(ch_left);
  a.ch_right = static_cast<const int*>(ch_right);
  a.has = static_cast<const unsigned char*>(has);
  a.c2a = current_2_adc;
  a.baseline = baseline;
  a.bank = static_cast<const short*>(bank);
  a.bank_len = bank_len;
  a.bank_ch = bank_ch;
  a.noise_ix = static_cast<const int*>(noise_ix);
  a.n_ch = n_ch;
  a.out = static_cast<short*>(out);
  return a;
}

}  // namespace

extern "C" const char* wfsim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// n_rows rows of n_samples into out (n_rows, n_samples) int16; status is
// one int32 word, cleared here (see the file header)
extern "C" int wfsim_superpose_adc(
    const void* t, const void* gain, const void* row_ptr, int n_rows,
    int n_photons, int n_samples, const void* templates, int dt, int tlen,
    const void* ch_left, const void* ch_right, const void* has,
    float current_2_adc, int baseline, const void* bank, int bank_len,
    int bank_ch, const void* noise_ix, int n_ch, void* status, void* out,
    void* stream) {
  if (dt <= 0 || tlen <= 0 || dt * tlen > kMaxTemplate)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bank != nullptr && (bank_len <= 0 || n_ch <= 0 || noise_ix == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0 || n_samples <= 0 || n_photons < 0 || n_ch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  RowArgs a = row_args(t, gain, row_ptr, n_rows, n_photons, n_samples,
                       templates, dt, tlen, ch_left, ch_right, has,
                       current_2_adc, baseline, bank, bank_len, bank_ch,
                       noise_ix, n_ch, out);
  a.status = static_cast<int*>(status);
  a.n_seg = tiles_a_row(n_samples, out);
  cudaError_t err = cudaMemsetAsync(status, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_rows<false>(a, static_cast<long long>(n_rows) * a.n_seg, s));
}

// n_rows = B * n_ch TPC rows in; out (B, n_all, n_samples) int16.  Grid
// layout: n_he = n_top HE copies on he_lo.. and the sum row sum_ch, or
// (without HE rows) n_he = 0, he_lo = n_ch and sum_ch = -1.  scratch is
// zeroed here: with a sum row the (B, n_samples) int32 sum rows, then the
// status word
extern "C" int wfsim_superpose_adc_full(
    const void* t, const void* gain, const void* row_ptr, int n_rows,
    int n_photons, int n_samples, const void* templates, int dt, int tlen,
    const void* ch_left, const void* ch_right, const void* has,
    float current_2_adc, int baseline, const void* bank, int bank_len,
    int bank_ch, const void* noise_ix, int n_ch, int n_all, int n_top,
    int n_he, int he_lo, int sum_ch, int deamp, void* scratch, void* out,
    void* stream) {
  if (dt <= 0 || tlen <= 0 || dt * tlen > kMaxTemplate)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bank != nullptr &&
      (bank_len <= 0 || noise_ix == nullptr || bank_ch > n_all))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool sum_row = sum_ch >= 0;
  if (n_ch <= 0 || n_rows <= 0 || n_rows % n_ch != 0 || n_top < 0 ||
      n_top > n_ch || he_lo < n_ch || he_lo + n_he > n_all ||
      n_samples <= 0 || n_photons < 0 ||
      (sum_row ? n_he != n_top || he_lo + n_he > sum_ch || sum_ch >= n_all
               : n_he != 0 || he_lo != n_ch || sum_ch != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_win = n_rows / n_ch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_sum = sum_row ? static_cast<long long>(n_win) * n_samples
                                  : 0;
  RowArgs a = row_args(t, gain, row_ptr, n_rows, n_photons, n_samples,
                       templates, dt, tlen, ch_left, ch_right, has,
                       current_2_adc, baseline, bank, bank_len, bank_ch,
                       noise_ix, n_ch, out);
  a.n_all = n_all;
  a.n_top = n_top;
  a.n_he = n_he;
  a.he_lo = he_lo;
  a.sum_ch = sum_ch;
  a.deamp = deamp;
  a.n_zero = n_all - n_ch - n_he - (sum_row ? 1 : 0);
  a.sum32 = sum_row ? static_cast<int*>(scratch) : nullptr;
  a.status = static_cast<int*>(scratch) + n_sum;
  a.n_seg = tiles_a_row(n_samples, out);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (static_cast<size_t>(n_sum) + 1) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_rows<true>(a, static_cast<long long>(n_rows) * a.n_seg +
                                 static_cast<long long>(n_win) * a.n_zero,
                          s);
  if (err != cudaSuccess || !sum_row) return static_cast<int>(err);
  const int n_grp = (n_samples + 14) / 8;         // from the row's origin
  const long long sum_blocks =
      (static_cast<long long>(n_win) * n_grp + kWarps * 32 - 1) /
      (kWarps * 32);
  if (sum_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  sum_rows_kernel<<<static_cast<unsigned>(sum_blocks), kWarps * 32, 0, s>>>(
      n_win, n_samples, n_all, sum_ch, n_grp, a.sum32,
      static_cast<short*>(out));
  return static_cast<int>(cudaGetLastError());
}

// n_rows = B * n_ch rows in; adc (n_rows, n_samples) int32; sums: the (B,
// n_samples) int32 sum rows, then the status word, cleared here
extern "C" int wfsim_superpose_block(
    const void* t, const void* gain, const void* row_ptr, int n_rows,
    int n_photons, int n_samples, const void* templates, int dt, int tlen,
    float current_2_adc, int n_ch, int ch_block, int n_top, int n_tpc,
    void* adc, void* sums, void* stream) {
  if (dt <= 0 || tlen <= 0 || dt * tlen > kMaxTemplate)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_ch <= 0 || n_rows <= 0 || n_rows % n_ch != 0 || ch_block < 0 ||
      n_samples <= 0 || n_photons < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BlockArgs a{};
  a.t = static_cast<const int*>(t);
  a.gain = static_cast<const float*>(gain);
  a.row_ptr = static_cast<const int*>(row_ptr);
  a.n_rows = n_rows;
  a.n_photons = n_photons;
  a.n_samples = n_samples;
  a.templates = static_cast<const float*>(templates);
  a.dt = dt;
  a.tlen = tlen;
  a.c2a = current_2_adc;
  a.n_ch = n_ch;
  a.ch_block = ch_block;
  a.n_top = n_top;
  a.n_tpc = n_tpc;
  // a row's tiles from its origin (up to 3 samples before its start)
  const bool aligned = n_samples % 4 == 0 &&
                       (reinterpret_cast<uintptr_t>(adc) & 15) == 0;
  a.n_seg = (n_samples + (aligned ? 0 : 3) + kSpan - 1) / kSpan;
  a.adc = static_cast<int*>(adc);
  const long long n_sum = static_cast<long long>(n_rows / n_ch) * n_samples;
  a.sums = static_cast<int*>(sums);
  a.status = a.sums + n_sum;
  const long long blocks =
      (static_cast<long long>(n_rows) * a.n_seg + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      sums, 0, (static_cast<size_t>(n_sum) + 1) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(dt) * tlen * sizeof(float);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (dt == 10 && tlen == 22)
    superpose_block_kernel<10, 22><<<grid, kWarps * 32, smem, s>>>(a);
  else
    superpose_block_kernel<0, 0><<<grid, kWarps * 32, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
