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
// samples, 2 bytes each; B*801 rows on the full grid) and, per output
// sample, one pass over its row's photons.  The TPU form built a float32
// (rows, 10, T) histogram in HBM and contracted it on the MXU; here no
// float grid ever reaches device memory: each thread owns one output
// sample, keeps its sum in a register and stores the final int16 once.
// Photons arrive sorted by row with row offsets, so a block reads only its
// own row's photons (the same address for every thread of the block: a
// broadcast load).  The 10 x 22 template bank sits in shared memory.
//
// Numerics: each sample sums gain*T[t%10][u - t/10] over its row's photons
// in their sorted order with __fmul_rn/__fadd_rn (no FMA contraction and
// no atomics), so the result is deterministic and bitwise equal to the
// plain twin superpose_adc_ref, which adds the same products in the same
// order.  The JAX package sums per histogram bin first and then contracts,
// so an ADC value within an f32 ulp of a .5 tie may round the other way;
// the tests count such tie samples and require 0 at their seeds.
//
// Noise (realistic config): row (w, c) of the batch, for c < Cn, adds at
// in-window sample u the bank value bank[c, (noise_ix[w] + u - left) % L]
// (reference rawdata.py:407-431).  The TPU read one contiguous span per
// row from a wrap-extended copy of the bank; here the thread that owns u
// reads one int16 of the plain channel-major bank (Cn, L) at a modular
// index.  The index is formed only in the window, where u >= left and
// noise_ix >= 0 (checked by the wrapper), so it is never negative and C's
// % agrees with the twin's floor-mod.  Integer adds are associative, so
// adc + noise + baseline is bitwise the twin's sum in any order.  With no
// bank (bank == nullptr) the kernel is the noise-free one.
//
// Full grid (wfsim_superpose_adc_full).  Rows of window w: the TPC
// channels 0..C-1; the high-energy copies of the n_top top-array channels
// on he_lo..he_lo+n_top-1 (adc * deamp with TPC row c's window, noise from
// bank column he_lo + c, baseline, clip); the bottom-array sum on sum_ch
// (the sum over c >= n_top of adc * deamp, unmasked: no noise, no
// baseline, no clip); every other row 0.  The JAX package concatenates
// int32 (B, rows, T) blocks and takes elementwise passes over the whole
// int32 grid.  Here the thread that owns TPC sample (w, c, u) computes the
// superposition once and writes both TPC row c and, for c < n_top, HE row
// he_lo + c; for c >= n_top it adds adc * deamp into the window's int32
// sum row by integer atomics (skipped where it is 0).  Integer addition is
// associative modulo 2^32, so the sum is bitwise the twin's in any order.
// One small follow-on launch casts the sum row to int16 and zeroes the
// gap rows, so no int32 (B, 801, T) grid ever reaches device memory: only
// the (B, T) int32 sum scratch.  Integer semantics are XLA's: adc * deamp
// and the adds wrap modulo 2^32 (done in unsigned arithmetic, where C++
// defines the wrap) and the int16 stores keep the low 16 bits, as
// astype(int16) does.  What bounds it: the 801 int16 rows a window (1.6x
// the slim grid) plus the noise reads of both the TPC and the HE rows.
// wfsim_tpu runs ZLE on the int32 grid; the port's ZLE reads the int16
// grid with in-window negatives taken as never below threshold
// (zle_intervals.cu), which is exact while every in-window value is below
// 2^16.  A value at or above 2^16 sets the overflow word of the scratch,
// and the wrapper raises.
//
// Full grid without HE rows (wfsim_tpu digitize.py:346-391 with he_on
// false: XENON1T, 248 TPC rows in an 801-row window).  The same entry with
// n_he = 0 copies, he_lo = n_ch and no sum row (sum_ch = -1, no sum
// scratch): the main kernel writes the TPC rows only, and the follow-on
// launch zeroes rows n_ch..n_all-1.  Those rows have no window, so they get
// no noise even where the bank is wider than the TPC (digitize.py:399-403).
//
// Window-relative photon times are >= 0 (the window starts margin_l
// samples before its first photon); the wrapper checks it, because C's / and
// % truncate where jnp's floor.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kMaxTemplate = 1024;

__device__ __forceinline__ void load_templates(float* tmpl,
                                               const float* templates, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) tmpl[i] = templates[i];
  __syncthreads();
}

// -round_half_even(W * current_2_adc) of sample u, as digitize.py:299, W
// summed over photons p0..p1-1 in their order
__device__ __forceinline__ int superposed_adc(
    const int* __restrict__ t, const float* __restrict__ gain, int p0, int p1,
    int u, int dt, int tlen, const float* tmpl, float current_2_adc) {
  float acc = 0.0f;
  for (int p = p0; p < p1; ++p) {
    const int tt = t[p];
    const int s = tt / dt;
    const int k = u - s;
    if (k >= 0 && k < tlen) {
      const int r = tt - s * dt;
      acc = __fadd_rn(acc, __fmul_rn(gain[p], tmpl[r * tlen + k]));
    }
  }
  return -static_cast<int>(rintf(__fmul_rn(acc, current_2_adc)));
}

// bank[col, x % L]; 0 <= noise_ix < 2^30 and L < 2^30 (wrapper), so the
// 32-bit unsigned index x cannot have wrapped
__device__ __forceinline__ int bank_at(const short* __restrict__ bank,
                                       int bank_len, int col, unsigned x) {
  return bank[static_cast<long long>(col) * bank_len +
              x % static_cast<unsigned>(bank_len)];
}

// int32 add and multiply that wrap modulo 2^32, as XLA's do
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

__global__ void superpose_adc_kernel(
    const int* __restrict__ t, const float* __restrict__ gain,
    const int* __restrict__ row_ptr, int n_rows, int n_samples,
    const float* __restrict__ templates, int dt, int tlen,
    const int* __restrict__ ch_left, const int* __restrict__ ch_right,
    const unsigned char* __restrict__ has, float current_2_adc, int baseline,
    const short* __restrict__ bank, int bank_len, int bank_ch,
    const int* __restrict__ noise_ix, int n_ch, short* __restrict__ out) {
  __shared__ float tmpl[kMaxTemplate];
  load_templates(tmpl, templates, dt * tlen);

  const int tiles = (n_samples + kTile - 1) / kTile;
  const long long bid = blockIdx.x;
  const int row = static_cast<int>(bid / tiles);
  const int u = static_cast<int>(bid % tiles) * kTile + threadIdx.x;
  if (row >= n_rows || u >= n_samples) return;

  int v = superposed_adc(t, gain, row_ptr[row], row_ptr[row + 1], u, dt, tlen,
                         tmpl, current_2_adc);
  const int left = ch_left[row];
  if (has[row] && u >= left && u <= ch_right[row]) {
    if (bank != nullptr) {
      const int w = row / n_ch;
      const int c = row - w * n_ch;
      if (c < bank_ch)
        v += bank_at(bank, bank_len, c,
                     static_cast<unsigned>(noise_ix[w]) +
                         static_cast<unsigned>(u - left));
    }
    v += baseline;
    v = v < 0 ? 0 : v;
  }
  out[static_cast<long long>(row) * n_samples + u] = static_cast<short>(v);
}

// one thread per TPC sample (w, c, u): TPC row c, HE row he_lo + c (c <
// n_he) or the atomic bottom sum (c >= n_top, with a sum row: sum32 not
// null); out is (B, n_all, T)
__global__ void superpose_adc_full_kernel(
    const int* __restrict__ t, const float* __restrict__ gain,
    const int* __restrict__ row_ptr, int n_rows, int n_samples,
    const float* __restrict__ templates, int dt, int tlen,
    const int* __restrict__ ch_left, const int* __restrict__ ch_right,
    const unsigned char* __restrict__ has, float current_2_adc, int baseline,
    const short* __restrict__ bank, int bank_len, int bank_ch,
    const int* __restrict__ noise_ix, int n_ch, int n_all, int n_top,
    int n_he, int he_lo, int deamp, int* __restrict__ sum32,
    int* __restrict__ overflow, short* __restrict__ out) {
  __shared__ float tmpl[kMaxTemplate];
  load_templates(tmpl, templates, dt * tlen);

  const int tiles = (n_samples + kTile - 1) / kTile;
  const long long bid = blockIdx.x;
  const int row = static_cast<int>(bid / tiles);
  const int u = static_cast<int>(bid % tiles) * kTile + threadIdx.x;
  if (row >= n_rows || u >= n_samples) return;
  const int w = row / n_ch;
  const int c = row - w * n_ch;

  const int adc = superposed_adc(t, gain, row_ptr[row], row_ptr[row + 1], u,
                                 dt, tlen, tmpl, current_2_adc);
  const int left = ch_left[row];
  const bool in_win = has[row] && u >= left && u <= ch_right[row];
  const unsigned x = in_win ? static_cast<unsigned>(noise_ix == nullptr
                                                        ? 0 : noise_ix[w]) +
                                  static_cast<unsigned>(u - left)
                            : 0u;
  const long long win_row = static_cast<long long>(w) * n_all;

  int v = adc;
  if (in_win) {
    if (bank != nullptr && c < bank_ch) v += bank_at(bank, bank_len, c, x);
    v += baseline;
    v = v < 0 ? 0 : v;
    if (v >= 65536) atomicOr(overflow, 1);
  }
  out[(win_row + c) * n_samples + u] = static_cast<short>(v);

  const int he = wrap_mul(adc, deamp);
  if (c < n_he) {
    int h = he;
    if (in_win) {
      if (bank != nullptr && he_lo + c < bank_ch)
        h = wrap_add(h, bank_at(bank, bank_len, he_lo + c, x));
      h = wrap_add(h, baseline);
      h = h < 0 ? 0 : h;
      if (h >= 65536) atomicOr(overflow, 1);
    }
    out[(win_row + he_lo + c) * n_samples + u] = static_cast<short>(h);
  } else if (sum32 != nullptr && c >= n_top && he != 0) {
    atomicAdd(sum32 + static_cast<long long>(w) * n_samples + u, he);
  }
}

// the rows the main kernel does not write: the gap rows (0) and the sum
// row (its int32 sum, low 16 bits; sum_ch < 0: none)
__global__ void full_grid_rest_kernel(int n_win, int n_samples, int n_ch,
                                      int n_all, int n_he, int he_lo,
                                      int sum_ch, const int* __restrict__ sum32,
                                      short* __restrict__ out) {
  const int gap1 = he_lo - n_ch;
  const int n_rest = gap1 + (n_all - he_lo - n_he);
  const int tiles = (n_samples + kTile - 1) / kTile;
  const long long bid = blockIdx.x;
  const long long wj = bid / tiles;
  const int w = static_cast<int>(wj / n_rest);
  const int j = static_cast<int>(wj - static_cast<long long>(w) * n_rest);
  const int u = static_cast<int>(bid % tiles) * kTile + threadIdx.x;
  if (w >= n_win || u >= n_samples) return;
  const int row = j < gap1 ? n_ch + j : he_lo + n_he + (j - gap1);
  const short v = row == sum_ch
      ? static_cast<short>(sum32[static_cast<long long>(w) * n_samples + u])
      : static_cast<short>(0);
  out[(static_cast<long long>(w) * n_all + row) * n_samples + u] = v;
}

}  // namespace

extern "C" const char* wfsim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int wfsim_superpose_adc(
    const void* t, const void* gain, const void* row_ptr, int n_rows,
    int n_samples, const void* templates, int dt, int tlen,
    const void* ch_left, const void* ch_right, const void* has,
    float current_2_adc, int baseline, const void* bank, int bank_len,
    int bank_ch, const void* noise_ix, int n_ch, void* out, void* stream) {
  if (dt * tlen > kMaxTemplate) return static_cast<int>(cudaErrorInvalidValue);
  if (bank != nullptr && (bank_len <= 0 || n_ch <= 0 || noise_ix == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n_samples + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(n_rows) * tiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  superpose_adc_kernel<<<static_cast<unsigned>(blocks), kTile, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(t), static_cast<const float*>(gain),
      static_cast<const int*>(row_ptr), n_rows, n_samples,
      static_cast<const float*>(templates), dt, tlen,
      static_cast<const int*>(ch_left), static_cast<const int*>(ch_right),
      static_cast<const unsigned char*>(has), current_2_adc, baseline,
      static_cast<const short*>(bank), bank_len, bank_ch,
      static_cast<const int*>(noise_ix), n_ch, static_cast<short*>(out));
  return static_cast<int>(cudaGetLastError());
}

// n_rows = B * n_ch TPC rows in; out (B, n_all, n_samples) int16.  Grid
// layout: n_he = n_top HE copies on he_lo.. and the sum row sum_ch, or
// (without HE rows) n_he = 0, he_lo = n_ch and sum_ch = -1.  scratch is
// zeroed here: with a sum row the (B, n_samples) int32 sum rows, then the
// overflow word (non-zero where an in-window value reached 2^16)
extern "C" int wfsim_superpose_adc_full(
    const void* t, const void* gain, const void* row_ptr, int n_rows,
    int n_samples, const void* templates, int dt, int tlen,
    const void* ch_left, const void* ch_right, const void* has,
    float current_2_adc, int baseline, const void* bank, int bank_len,
    int bank_ch, const void* noise_ix, int n_ch, int n_all, int n_top,
    int n_he, int he_lo, int sum_ch, int deamp, void* scratch, void* out,
    void* stream) {
  if (dt * tlen > kMaxTemplate) return static_cast<int>(cudaErrorInvalidValue);
  if (bank != nullptr && (bank_len <= 0 || noise_ix == nullptr || bank_ch > n_all))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool sum_row = sum_ch >= 0;
  if (n_ch <= 0 || n_rows % n_ch != 0 || n_top < 0 || n_top > n_ch ||
      he_lo < n_ch || he_lo + n_he > n_all ||
      (sum_row ? n_he != n_top || he_lo + n_he > sum_ch || sum_ch >= n_all
               : n_he != 0 || he_lo != n_ch || sum_ch != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_win = n_rows / n_ch;
  const int n_rest = n_all - n_ch - n_he;
  const int tiles = (n_samples + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(n_rows) * tiles;
  const long long rest_blocks = static_cast<long long>(n_win) * n_rest * tiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL || rest_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_sum = sum_row ? static_cast<long long>(n_win) * n_samples
                                  : 0;
  int* sum32 = sum_row ? static_cast<int*>(scratch) : nullptr;
  int* overflow = static_cast<int*>(scratch) + n_sum;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (static_cast<size_t>(n_sum) + 1) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  superpose_adc_full_kernel<<<static_cast<unsigned>(blocks), kTile, 0, s>>>(
      static_cast<const int*>(t), static_cast<const float*>(gain),
      static_cast<const int*>(row_ptr), n_rows, n_samples,
      static_cast<const float*>(templates), dt, tlen,
      static_cast<const int*>(ch_left), static_cast<const int*>(ch_right),
      static_cast<const unsigned char*>(has), current_2_adc, baseline,
      static_cast<const short*>(bank), bank_len, bank_ch,
      static_cast<const int*>(noise_ix), n_ch, n_all, n_top, n_he, he_lo,
      deamp, sum32, overflow, static_cast<short*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess || rest_blocks == 0) return static_cast<int>(err);
  full_grid_rest_kernel<<<static_cast<unsigned>(rest_blocks), kTile, 0, s>>>(
      n_win, n_samples, n_ch, n_all, n_he, he_lo, sum_ch, sum32,
      static_cast<short*>(out));
  return static_cast<int>(cudaGetLastError());
}
