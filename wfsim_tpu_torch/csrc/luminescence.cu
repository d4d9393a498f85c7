// luminescence: the per-instruction inverse CDFs of the single-electron
// luminescence time (the table half of the simple luminescence model).
//
// Replaces: wfsim_tpu/models/s2.py:167 luminescence_simple (lines 176-219,
// the anode-field integration and the resampling) and :141 _interp_rows.
// The per-photon lerp into the table is part of photon_times.cu.  Plain
// twin: models/s2.py luminescence_tables_ref.
//
// One block per instruction, the row in shared memory (2 R floats, R the
// radius grid, 4,883 points at the default geometry: 39 KB):
//   1. every thread fills dt(r) and dy(r) on its share of the grid, masked
//      to the instruction's gas gap (r <= dG);
//   2. thread 0 integrates both in one sequential float64 pass, rounding
//      each cumulative value to float32 in place, and accumulates the
//      light-weighted time sum(t_cum * dy) in float64 in the same order;
//      avgt = sum(t_cum * dy) / sum(dy) in float64, cast to float32 once;
//   3. every thread centres t_cum on avgt and resamples the inverse CDF on
//      its share of the Q quantiles: a lower-bound search of q * y_last in
//      y_cum, then the lerp with _interp_rows' clamps.
//
// What bounds it on the H100: step 2, ~R dependent double adds per block
// (~30 us); the blocks of a batch run side by side (five fit on an SM).
// The TPU form computed the same thing as (I, R) arrays in device memory;
// here nothing but the (I, Q) output leaves the SM.
//
// Numerics.  The twin's rule is the sequential float64 accumulation that
// torch's CPU cumsum performs; the kernel reproduces it bit for bit.  At
// the default geometry every partial sum is exact in float64 (checked),
// so any order gives the same bits there, and the twin run on the card
// (which scans in parallel) agrees as well.  nvcc contracts a*b+c into an
// FMA by default; every product and sum the twin rounds separately is
// written with the _rn intrinsics (float and double), including the lerp
// y0*(1-w) + y1*w.  1e-4 / x is torch's reciprocal(x) * 1e-4: a correctly
// rounded reciprocal, then a float32 product.  The float32 constants
// (alpha, the field unit, 0.8 * pressure) are the values torch rounds the
// twin's Python floats to.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void lumi_tables_kernel(
    const float* __restrict__ r, const float* __restrict__ rr, int R,
    const float* __restrict__ qs, int Q, const float* __restrict__ dG,
    const float* __restrict__ E0, float alpha, float field_unit,
    float dy_offset, float* __restrict__ inv) {
  extern __shared__ float sh[];
  float* t_cum = sh;        // dt, then its cumulative sum, then centred
  float* y_cum = sh + R;    // dy, then its cumulative sum
  __shared__ float sh_avgt;
  const int i = blockIdx.x;
  const float dg = dG[i], e0 = E0[i];
  const float ae0 = __fmul_rn(alpha, e0);
  for (int k = threadIdx.x; k < R; k += blockDim.x) {
    const bool in_gap = r[k] <= dg;
    const float dt = __fmul_rn(__fdiv_rn(1.0f, __fmul_rn(ae0, rr[k])), 1e-4f);
    const float dy = __fsub_rn(__fdiv_rn(__fmul_rn(e0, rr[k]), field_unit),
                               dy_offset);
    t_cum[k] = in_gap ? dt : 0.0f;
    y_cum[k] = in_gap ? dy : 0.0f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double at = 0.0, ay = 0.0, num = 0.0;
    for (int k = 0; k < R; ++k) {
      const float dy = y_cum[k];
      at = __dadd_rn(at, static_cast<double>(t_cum[k]));
      ay = __dadd_rn(ay, static_cast<double>(dy));
      const float tc = __double2float_rn(at);
      t_cum[k] = tc;
      y_cum[k] = __double2float_rn(ay);
      num = __dadd_rn(num, static_cast<double>(__fmul_rn(tc, dy)));
    }
    sh_avgt = __double2float_rn(__ddiv_rn(num, ay > 1e-30 ? ay : 1e-30));
  }
  __syncthreads();
  const float avgt = sh_avgt;
  for (int k = threadIdx.x; k < R; k += blockDim.x)
    t_cum[k] = __fsub_rn(t_cum[k], avgt);
  __syncthreads();
  const float y_last = y_cum[R - 1];
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    const float uq = __fmul_rn(qs[q], y_last);
    int a = 0, b = R;                      // first k with y_cum[k] >= uq
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (y_cum[mid] < uq) a = mid + 1; else b = mid;
    }
    const int i1 = a < 1 ? 1 : (a > R - 1 ? R - 1 : a);
    const int i0 = i1 - 1;
    const float x0 = y_cum[i0], x1 = y_cum[i1];
    const float y0 = t_cum[i0], y1 = t_cum[i1];
    float w = 0.0f;
    if (x1 > x0) {
      const float span = __fsub_rn(x1, x0);
      w = __fdiv_rn(__fsub_rn(uq, x0), span > 1e-30f ? span : 1e-30f);
    }
    w = w > 0.0f ? w : 0.0f;
    w = w < 1.0f ? w : 1.0f;
    inv[static_cast<long long>(i) * Q + q] =
        __fadd_rn(__fmul_rn(y0, __fsub_rn(1.0f, w)), __fmul_rn(y1, w));
  }
}

}  // namespace

extern "C" int wfsim_lumi_tables(const void* r, const void* rr, int R,
                                 const void* qs, int Q, const void* dG,
                                 const void* E0, int n_inst, float alpha,
                                 float field_unit, float dy_offset, void* inv,
                                 void* stream) {
  const size_t smem = 2 * static_cast<size_t>(R) * sizeof(float);
  if (n_inst <= 0 || R < 2 || Q <= 0 || smem > 200 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lumi_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lumi_tables_kernel<<<n_inst, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(rr), R,
      static_cast<const float*>(qs), Q, static_cast<const float*>(dG),
      static_cast<const float*>(E0), alpha, field_unit, dy_offset,
      static_cast<float*>(inv));
  return static_cast<int>(cudaGetLastError());
}
