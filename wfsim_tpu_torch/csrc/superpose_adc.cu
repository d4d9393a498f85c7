// superpose_adc: photons -> SPE current superposition -> ADC int16 grid.
//
// Replaces: wfsim_tpu/ops/waveform.py:68 photons_to_waveform (phase
// histogram + :146 _conv_templates_mxu banded matmul) together with the
// slim-grid epilogue of wfsim_tpu/pipeline/digitize.py:299-319 (ADC
// conversion, baseline inside the channel window, clip at 0, int16 cast).
//
// What bounds it on the H100: writing the int16 grid (B*494 rows x T
// samples, 2 bytes each) and, per output sample, one pass over its row's
// photons.  The TPU form built a float32 (rows, 10, T) histogram in HBM and
// contracted it on the MXU; here no float grid ever reaches device memory:
// each thread owns one output sample, keeps its sum in a register and
// stores the final int16 once.  Photons arrive sorted by row with row
// offsets, so a block reads only its own row's photons (the same address
// for every thread of the block: a broadcast load).  The 10 x 22 template
// bank sits in shared memory.
//
// Numerics: each sample sums gain*T[t%10][u - t/10] over its row's photons
// in their sorted order with __fmul_rn/__fadd_rn (no FMA contraction and
// no atomics), so the result is deterministic and bitwise equal to the
// plain twin superpose_adc_ref, which adds the same products in the same
// order.  The JAX package sums per histogram bin first and then contracts,
// so an ADC value within an f32 ulp of a .5 tie may round the other way;
// the tests count such tie samples and require 0 at their seeds.
//
// Window-relative photon times are >= 0 (the window starts margin_l
// samples before its first photon); the wrapper checks it, because C's / and
// % truncate where jnp's floor.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kMaxTemplate = 1024;

__global__ void superpose_adc_kernel(
    const int* __restrict__ t, const float* __restrict__ gain,
    const int* __restrict__ row_ptr, int n_rows, int n_samples,
    const float* __restrict__ templates, int dt, int tlen,
    const int* __restrict__ ch_left, const int* __restrict__ ch_right,
    const unsigned char* __restrict__ has, float current_2_adc, int baseline,
    short* __restrict__ out) {
  __shared__ float tmpl[kMaxTemplate];
  for (int i = threadIdx.x; i < dt * tlen; i += blockDim.x) tmpl[i] = templates[i];
  __syncthreads();

  const int tiles = (n_samples + kTile - 1) / kTile;
  const long long bid = blockIdx.x;
  const int row = static_cast<int>(bid / tiles);
  const int u = static_cast<int>(bid % tiles) * kTile + threadIdx.x;
  if (row >= n_rows || u >= n_samples) return;

  const int p0 = row_ptr[row];
  const int p1 = row_ptr[row + 1];
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
  // -round_half_even(W * current_2_adc), as digitize.py:299
  int v = -static_cast<int>(rintf(__fmul_rn(acc, current_2_adc)));
  if (has[row] && u >= ch_left[row] && u <= ch_right[row]) {
    v += baseline;
    v = v < 0 ? 0 : v;
  }
  out[static_cast<long long>(row) * n_samples + u] = static_cast<short>(v);
}

}  // namespace

extern "C" const char* wfsim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int wfsim_superpose_adc(
    const void* t, const void* gain, const void* row_ptr, int n_rows,
    int n_samples, const void* templates, int dt, int tlen,
    const void* ch_left, const void* ch_right, const void* has,
    float current_2_adc, int baseline, void* out, void* stream) {
  if (dt * tlen > kMaxTemplate) return static_cast<int>(cudaErrorInvalidValue);
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
      static_cast<short*>(out));
  return static_cast<int>(cudaGetLastError());
}
