// pmt_afterpulse: PMT afterpulse photons and the electron-afterpulse
// photon summaries.
//
// Replaces: wfsim_tpu/models/afterpulse.py:56 pmt_afterpulse_photons
// (selection over every (element, photon) slot, then the delay and
// amplitude CDF inversions of the compacted slots) and :184
// photon_summaries (time-zero candidates per instruction).
//
// Three entry points, each with a plain twin in
// wfsim_tpu_torch/models/afterpulse.py:
//   wfsim_pmt_ap_select        one thread per (element, photon) slot;
//                              writes the selection flag;
//   wfsim_pmt_ap_emit          one thread per selected slot (flat
//                              element-major indices from torch.nonzero);
//                              inverts the delay and amplitude rows and
//                              writes t, ch, gain and truth row;
//   wfsim_ap_photon_summaries  one thread per (instruction, candidate);
//                              gathers the candidate photon time.
//
// What bounds them on the H100: memory traffic.  Select reads three
// uniforms and one float of the channel's delay-CDF row per slot (the
// tables, 2 x 494 x 4000 floats, stay in L2), ~16 bytes a slot; at the
// bench S2 batch (2 x 1.57 M slots) that is ~50 MB.  The TPU form kept
// the inversions off the full slot axis because each binary-search step was
// a gather; here emit runs only on the ~2.5 % selected slots, and each
// thread binary-searches its own 4000-float row (12 steps of cached loads),
// so emit is cheap next to select.  Select recomputes nothing emit needs:
// emit recomputes rU0 and the auxiliary draw from the same uniforms with
// the same operations, which is cheaper than storing them.
//
// Numerics.  nvcc contracts a*b+c into an FMA by default (--fmad=true),
// which rounds once where the twin rounds twice.  Every product, sum and
// quotient the twin rounds separately is written with __fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn, so kernel and twin agree bitwise:
//   (lo0 + aux*(hi0-lo0)) * delay_bin,  didx*delay_bin - t_modifier,
//   gains[ch]*amp,  (1-u0)/modifier,  rU0/2,  u*max(count,1).
// float -> int casts truncate toward zero in C as in astype and torch's
// .to(int32); afterpulse delays go down to -pmt_ap_t_modifier, so the sign
// matters and truncation (not floor) is what the reference does.
// The CDF rows are edge-padded, so they have plateaus; the lower-bound
// search and the "|v0-r| <= |v1-r| picks the lower index" rule settle
// the index on a plateau exactly as the twin's searchsorted does.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// rU0 = (1 - u0) / modifier, halved for a double-PE photon
// (wfsim_tpu afterpulse.py:88-90)
__device__ __forceinline__ float select_draw(float u0, float modifier,
                                             bool dpe) {
  float r0 = __fdiv_rn(__fsub_rn(1.0f, u0), modifier);
  return dpe ? __fdiv_rn(r0, 2.0f) : r0;
}

// index minimizing |row[i] - r| on a non-decreasing row, the lower index
// on a tie: the first index at or above r (lower bound, clamped to R-1)
// and its predecessor are the only candidates (afterpulse.py:29-52)
__device__ __forceinline__ int argmin_abs_monotone(const float* row, int R,
                                                   float r) {
  int lo = 0, hi = R;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < r) lo = mid + 1; else hi = mid;
  }
  const int i1 = lo < R - 1 ? lo : R - 1;
  const int i0 = i1 > 0 ? i1 - 1 : 0;
  return fabsf(__fsub_rn(row[i0], r)) <= fabsf(__fsub_rn(row[i1], r)) ? i0
                                                                      : i1;
}

__global__ void ap_select_kernel(
    const float* __restrict__ u0, const float* __restrict__ u2,
    const int* __restrict__ ch, const unsigned char* __restrict__ is_dpe,
    const unsigned char* __restrict__ valid, int n, int n_elements,
    const float* __restrict__ delay, int C, int Td,
    const float* __restrict__ amp, int Ta,
    const unsigned char* __restrict__ uniform_e,
    const float* __restrict__ amp_bin, float modifier,
    unsigned char* __restrict__ sel) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (k >= static_cast<long long>(n_elements) * n) return;
  const int e = static_cast<int>(k / n);
  const int i = static_cast<int>(k - static_cast<long long>(e) * n);
  const int c = clampi(ch[i], 0, C - 1);
  const long long row = static_cast<long long>(e) * C + c;
  const float r0 = select_draw(u0[k], modifier, is_dpe[i] != 0);
  bool s = valid[i] != 0 && r0 <= delay[row * Td + Td - 1];
  if (!uniform_e[e]) {
    const float aux = __fsub_rn(1.0f, u2[k]);
    const float* arow = amp + row * Ta;
    // argmin index 0 (amplitude 0) holds iff aux <= the midpoint of the
    // row's first two values
    const bool amp_pos = Ta >= 2 &&
        __fmul_rn(2.0f, aux) > __fadd_rn(arow[0], arow[1]);
    s = s && amp_pos && amp_bin[e] > 0.0f;
  }
  sel[k] = s ? 1 : 0;
}

__global__ void ap_emit_kernel(
    const long long* __restrict__ take, int m,
    const float* __restrict__ u0, const float* __restrict__ u1,
    const float* __restrict__ u2, const int* __restrict__ t,
    const int* __restrict__ ch, const unsigned char* __restrict__ is_dpe,
    const long long* __restrict__ truth_row, int n,
    const float* __restrict__ delay, int C, int Td,
    const float* __restrict__ amp, int Ta, const float* __restrict__ gains,
    float modifier, float t_modifier,
    const unsigned char* __restrict__ uniform_e,
    const float* __restrict__ delay_bin, const float* __restrict__ amp_bin,
    int* __restrict__ out_t, int* __restrict__ out_ch,
    float* __restrict__ out_gain, long long* __restrict__ out_row) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= m) return;
  const long long k = take[s];
  const int e = static_cast<int>(k / n);
  const int i = static_cast<int>(k - static_cast<long long>(e) * n);
  const int c = clampi(ch[i], 0, C - 1);
  const long long row = static_cast<long long>(e) * C + c;
  const float* drow = delay + row * Td;
  const float* arow = amp + row * Ta;
  float ap_delay, ap_amp;
  if (uniform_e[e]) {
    const float aux = u1[k];
    const float lo = drow[0], hi = drow[1];
    ap_delay = __fmul_rn(__fadd_rn(lo, __fmul_rn(aux, __fsub_rn(hi, lo))),
                         delay_bin[e]);
    ap_amp = 1.0f;
  } else {
    const float aux = __fsub_rn(1.0f, u2[k]);
    const float r0 = select_draw(u0[k], modifier, is_dpe[i] != 0);
    const int didx = argmin_abs_monotone(drow, Td, r0);
    ap_delay = __fsub_rn(__fmul_rn(static_cast<float>(didx), delay_bin[e]),
                         t_modifier);
    const int aidx = argmin_abs_monotone(arow, Ta, aux);
    ap_amp = __fmul_rn(static_cast<float>(aidx), amp_bin[e]);
  }
  out_t[s] = t[i] + static_cast<int>(ap_delay);   // truncates toward zero
  out_ch[s] = ch[i];
  out_gain[s] = __fmul_rn(gains[c], ap_amp);
  out_row[s] = truth_row[i];
}

__global__ void ap_summaries_kernel(
    const int* __restrict__ t, const int* __restrict__ counts,
    const int* __restrict__ offsets, int n_inst, int K,
    const float* __restrict__ u, int n_photons, int* __restrict__ out) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (k >= static_cast<long long>(n_inst) * K) return;
  const int i = static_cast<int>(k / K);
  const int cnt = counts[i] > 1 ? counts[i] : 1;
  // slot = offset + trunc(u * max(count, 1)), clipped to the array
  long long slot = static_cast<long long>(offsets[i]) +
                   static_cast<int>(__fmul_rn(u[k], static_cast<float>(cnt)));
  slot = slot < 0 ? 0 : (slot > n_photons - 1 ? n_photons - 1 : slot);
  out[k] = t[slot];
}

unsigned grid_of(long long work) {
  return static_cast<unsigned>((work + kBlock - 1) / kBlock);
}

}  // namespace

extern "C" int wfsim_pmt_ap_select(
    const void* u0, const void* u1, const void* u2, const void* ch,
    const void* is_dpe, const void* valid, int n, int n_elements,
    const void* delay, int C, int Td, const void* amp, int Ta,
    const void* uniform_e, const void* amp_bin, float modifier, void* sel,
    void* stream) {
  (void)u1;   // the auxiliary draw of a uniform element plays no part here
  const long long work = static_cast<long long>(n) * n_elements;
  if (work <= 0 || C <= 0 || Td <= 0 || Ta <= 0 ||
      grid_of(work) > 0x7fffffffu)
    return static_cast<int>(cudaErrorInvalidValue);
  ap_select_kernel<<<grid_of(work), kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u0), static_cast<const float*>(u2),
      static_cast<const int*>(ch), static_cast<const unsigned char*>(is_dpe),
      static_cast<const unsigned char*>(valid), n, n_elements,
      static_cast<const float*>(delay), C, Td,
      static_cast<const float*>(amp), Ta,
      static_cast<const unsigned char*>(uniform_e),
      static_cast<const float*>(amp_bin), modifier,
      static_cast<unsigned char*>(sel));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wfsim_pmt_ap_emit(
    const void* take, int m, const void* u0, const void* u1, const void* u2,
    const void* t, const void* ch, const void* is_dpe, const void* truth_row,
    int n, int n_elements, const void* delay, int C, int Td, const void* amp,
    int Ta, const void* gains, float modifier, float t_modifier,
    const void* uniform_e, const void* delay_bin, const void* amp_bin,
    void* out_t, void* out_ch, void* out_gain, void* out_row, void* stream) {
  (void)n_elements;
  // a uniform element reads drow[1]: the wrapper checks Td >= 2 for it
  if (m <= 0 || n <= 0 || C <= 0 || Td <= 0 || Ta <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ap_emit_kernel<<<grid_of(m), kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(take), m,
      static_cast<const float*>(u0), static_cast<const float*>(u1),
      static_cast<const float*>(u2), static_cast<const int*>(t),
      static_cast<const int*>(ch), static_cast<const unsigned char*>(is_dpe),
      static_cast<const long long*>(truth_row), n,
      static_cast<const float*>(delay), C, Td,
      static_cast<const float*>(amp), Ta, static_cast<const float*>(gains),
      modifier, t_modifier, static_cast<const unsigned char*>(uniform_e),
      static_cast<const float*>(delay_bin),
      static_cast<const float*>(amp_bin), static_cast<int*>(out_t),
      static_cast<int*>(out_ch), static_cast<float*>(out_gain),
      static_cast<long long*>(out_row));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wfsim_ap_photon_summaries(
    const void* t, const void* counts, const void* offsets, int n_inst,
    int K, const void* u, int n_photons, void* out, void* stream) {
  const long long work = static_cast<long long>(n_inst) * K;
  if (work <= 0 || n_photons <= 0 || grid_of(work) > 0x7fffffffu)
    return static_cast<int>(cudaErrorInvalidValue);
  ap_summaries_kernel<<<grid_of(work), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(t), static_cast<const int*>(counts),
      static_cast<const int*>(offsets), n_inst, K,
      static_cast<const float*>(u), n_photons, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
