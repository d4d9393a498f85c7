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
// Three entry points, each one block per instruction that walks the
// instruction's elements [edges[i], edges[i+1]) and writes, besides the
// times, the segment id and the broadcast truth row of each element; that
// takes the place of repeat_interleave on the path:
//   wfsim_s1_photon_times    t = time[i] + trunc(exp * s1_decay_time)
//                                + trunc(normal * s1_decay_spread) (simple
//                                model, skipped where exp is null)
//                                + trunc(custom) (custom model) and
//                                + trunc(nest) (NEST model), in that order,
//                                where the delays of table_samplers.cu are
//                                given;
//   wfsim_s2_electron_times  e_t = time[i] + trunc(exp * trapping
//                                + (normal * spread[i] + mean[i]));
//                                the truth rows feed the electron-time
//                                statistics;
//   wfsim_s2_photon_times    t = trunc(lerp of the instruction's inverse
//                                CDF), or the given gas-gap luminescence
//                                time t_lum, + trunc(exp * singlet or triplet
//                                lifetime) + trunc(normal * s2_time_spread)
//                                + e_t[electron]; a photon finds its electron
//                                by a binary search of the photon edges of
//                                the instruction's electrons.
//
// What bounds them on the H100: the draws they read and the times, ids and
// rows they write, 16-40 bytes an element (~50 MB for the bench S2 photon
// pass); the luminescence table rows (4 KB each) stay in L1/L2.
//
// Numerics.  nvcc contracts a*b+c into an FMA by default, which rounds
// once where the twin rounds twice: every product and sum is written with
// __fmul_rn / __fadd_rn / __fsub_rn, in the twin's order (normal*spread +
// mean, then the exponential term added; y0*(1-w) + y1*w).  float -> int
// casts truncate toward zero in C as torch's trunc + .to(int32) does; the
// normal draws make negative offsets, so the sign matters (a floor would
// move every negative offset by 1 ns).  The lower table index is clamped
// to Q-2 (ROADMAP F2).  The float constants are the float32 values torch
// rounds the twin's Python floats to.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void s1_photon_times_kernel(
    const int* __restrict__ time, const long long* __restrict__ edges,
    const long long* __restrict__ truth_row, const float* __restrict__ ex,
    const float* __restrict__ nrm, const float* __restrict__ nest,
    const float* __restrict__ custom,
    float decay_time, float decay_spread, int* __restrict__ t,
    long long* __restrict__ ph_inst, long long* __restrict__ ph_row) {
  const int i = blockIdx.x;
  const long long lo = edges[i], hi = edges[i + 1];
  const int ti = time[i];
  const long long row = truth_row[i];
  for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    int tt = ti;
    if (ex != nullptr)
      tt += static_cast<int>(__fmul_rn(ex[j], decay_time)) +
            static_cast<int>(__fmul_rn(nrm[j], decay_spread));
    if (custom != nullptr) tt += static_cast<int>(custom[j]);
    if (nest != nullptr) tt += static_cast<int>(nest[j]);
    t[j] = tt;
    ph_inst[j] = i;
    ph_row[j] = row;
  }
}

__global__ void s2_electron_times_kernel(
    const int* __restrict__ time, const long long* __restrict__ e_edges,
    const float* __restrict__ mean, const float* __restrict__ spread,
    const float* __restrict__ ex, const float* __restrict__ nrm,
    const long long* __restrict__ truth_row, float trapping,
    int* __restrict__ e_t, long long* __restrict__ e_inst,
    long long* __restrict__ e_row) {
  const int i = blockIdx.x;
  const long long lo = e_edges[i], hi = e_edges[i + 1];
  const int ti = time[i];
  const float mi = mean[i], si = spread[i];
  const long long row = truth_row[i];
  for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    const float timing = __fadd_rn(__fmul_rn(ex[j], trapping),
                                   __fadd_rn(__fmul_rn(nrm[j], si), mi));
    e_t[j] = ti + static_cast<int>(timing);
    e_inst[j] = i;
    e_row[j] = row;
  }
}

__global__ void s2_photon_times_kernel(
    const float* __restrict__ inv, int Q,
    const long long* __restrict__ e_edges,
    const long long* __restrict__ e_ph_edges, const int* __restrict__ e_t,
    const long long* __restrict__ truth_row, const float* __restrict__ u_lum,
    const int* __restrict__ t_lum, const float* __restrict__ u_st,
    const float* __restrict__ ex_st,
    const float* __restrict__ nrm_ts, float singlet_fraction,
    float t_singlet, float t_triplet, float time_spread,
    int* __restrict__ t, long long* __restrict__ ph_inst,
    long long* __restrict__ ph_row) {
  const int i = blockIdx.x;
  const long long e_lo = e_edges[i], e_hi = e_edges[i + 1];
  const long long lo = e_ph_edges[e_lo], hi = e_ph_edges[e_hi];
  const float* row_inv = inv + static_cast<long long>(i) * Q;
  const long long row = truth_row[i];
  for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    // the electron of photon j: the last k in [e_lo, e_hi) whose first
    // photon is at or before j (electrons without photons share an edge)
    long long a = e_lo, b = e_hi;
    while (a < b) {
      const long long mid = (a + b) >> 1;
      if (e_ph_edges[mid] <= j) a = mid + 1; else b = mid;
    }
    const long long k = a - 1;
    int tt;
    if (t_lum != nullptr) {
      tt = t_lum[j];
    } else {
      const float uq = __fmul_rn(u_lum[j], static_cast<float>(Q - 1));
      long long i0 = static_cast<long long>(floorf(uq));
      i0 = i0 < Q - 2 ? i0 : Q - 2;
      const float w = __fsub_rn(uq, static_cast<float>(i0));
      tt = static_cast<int>(
          __fadd_rn(__fmul_rn(row_inv[i0], __fsub_rn(1.0f, w)),
                    __fmul_rn(row_inv[i0 + 1], w)));
    }
    const float life = u_st[j] < singlet_fraction ? t_singlet : t_triplet;
    tt += static_cast<int>(__fmul_rn(ex_st[j], life));
    if (nrm_ts != nullptr)
      tt += static_cast<int>(__fmul_rn(nrm_ts[j], time_spread));
    t[j] = tt + e_t[k];
    ph_inst[j] = i;
    ph_row[j] = row;
  }
}

}  // namespace

extern "C" int wfsim_s1_photon_times(const void* time, const void* edges,
                                     const void* truth_row, int n_inst,
                                     const void* ex, const void* nrm,
                                     const void* nest, const void* custom,
                                     float decay_time,
                                     float decay_spread, void* t,
                                     void* ph_inst, void* ph_row,
                                     void* stream) {
  if (n_inst <= 0 || (ex == nullptr) != (nrm == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  s1_photon_times_kernel<<<n_inst, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(time), static_cast<const long long*>(edges),
      static_cast<const long long*>(truth_row),
      static_cast<const float*>(ex), static_cast<const float*>(nrm),
      static_cast<const float*>(nest), static_cast<const float*>(custom),
      decay_time, decay_spread,
      static_cast<int*>(t),
      static_cast<long long*>(ph_inst), static_cast<long long*>(ph_row));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wfsim_s2_electron_times(const void* time, const void* e_edges,
                                       int n_inst, const void* mean,
                                       const void* spread, const void* ex,
                                       const void* nrm, const void* truth_row,
                                       float trapping, void* e_t,
                                       void* e_inst, void* e_row,
                                       void* stream) {
  if (n_inst <= 0) return static_cast<int>(cudaErrorInvalidValue);
  s2_electron_times_kernel<<<n_inst, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(time), static_cast<const long long*>(e_edges),
      static_cast<const float*>(mean), static_cast<const float*>(spread),
      static_cast<const float*>(ex), static_cast<const float*>(nrm),
      static_cast<const long long*>(truth_row), trapping,
      static_cast<int*>(e_t), static_cast<long long*>(e_inst),
      static_cast<long long*>(e_row));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wfsim_s2_photon_times(
    const void* inv, int Q, const void* e_edges, int n_inst,
    const void* e_ph_edges, const void* e_t, const void* truth_row,
    const void* u_lum, const void* t_lum, const void* u_st,
    const void* ex_st, const void* nrm_ts, float singlet_fraction,
    float t_singlet, float t_triplet, float time_spread, void* t,
    void* ph_inst, void* ph_row, void* stream) {
  if (n_inst <= 0 || (t_lum == nullptr && (Q < 2 || inv == nullptr ||
                                           u_lum == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  s2_photon_times_kernel<<<n_inst, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inv), Q,
      static_cast<const long long*>(e_edges),
      static_cast<const long long*>(e_ph_edges),
      static_cast<const int*>(e_t), static_cast<const long long*>(truth_row),
      static_cast<const float*>(u_lum), static_cast<const int*>(t_lum),
      static_cast<const float*>(u_st),
      static_cast<const float*>(ex_st), static_cast<const float*>(nrm_ts),
      singlet_fraction, t_singlet, t_triplet, time_spread,
      static_cast<int*>(t), static_cast<long long*>(ph_inst),
      static_cast<long long*>(ph_row));
  return static_cast<int>(cudaGetLastError());
}
