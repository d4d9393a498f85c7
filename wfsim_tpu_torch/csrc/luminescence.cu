// luminescence: the per-instruction inverse CDFs of the single-electron
// luminescence time (the table half of the simple luminescence model).
//
// Replaces: wfsim_tpu/models/s2.py:167 luminescence_simple (lines 176-219,
// the anode-field integration and the resampling) and :141 _interp_rows.
// The per-photon lerp into the table is part of photon_times.cu.  Plain
// twin: models/s2.py luminescence_tables_ref.
//
// One block of 256 threads per instruction, the row in shared memory (2 R
// floats, R the radius grid, 4,883 points at the default geometry: 39 KB):
//   1. the fill: every thread computes dt(r) and dy(r) on its share of the
//      grid (coalesced) inside the instruction's gas gap (r <= dG), 0
//      outside it;
//   2. the scans: each thread owns a contiguous chunk of C points (C odd,
//      so a warp's chunk walks hit 32 distinct banks) and sums dt and dy
//      in float64 in order; one block pass (warp scans of the chunk totals
//      by __shfl_up_sync on doubles, the 8 warp totals through shared
//      memory) gives each chunk its exclusive prefixes; each thread then
//      walks its chunk again from them, writing the cumulative t and y as
//      float32 in place, and sums the light-weighted terms
//      float32(t_cum * dy) of its chunk; one more block pass gives their
//      sum `num`; avgt = num / y_total in float64, cast to float32 once;
//   3. the resample: every thread takes Q / 256 quantiles, a lower-bound
//      search of q * y_last in y_cum and the lerp with _interp_rows'
//      clamps, centring t_cum on avgt as it reads it.
//
// Exactness decides the path, per row.  The twin's rule is the sequential
// float64 accumulation that torch's CPU cumsum performs.  Another order
// gives the same bits wherever every partial sum is exact in float64, and
// for float32 terms that is cheap to show: with e the exponent of the
// lowest set bit of a row's nonzero terms, every term is a multiple of
// 2^e, so every partial sum, in any order, is one too, of magnitude at
// most sum |x|; below 2^(e+53) it is representable, and the sum of two
// representable values that is itself representable is exact.  The kernel
// tests the float64 sum of |x| against 2^(e+52): that test holds exactly
// when the exact sum is below 2^(e+52) (there the float64 sum is exact;
// from 2^(e+53) on it cannot round below 2^(e+52)), whatever the order of
// the block's reduction.  Step 2 reduces the minimum exponent and the
// magnitude sum of dt and of dy with their chunk totals, and those of the
// light-weighted terms with `num`, which therefore needs no scan: every
// partial sum of a reduction tree is a partial sum in some order.  A row
// that fails any of the three tests (the light-weighted terms exist only
// after the t scan, so the block decides once, after the scans) refills
// its shared row and takes the sequential pass, the one this kernel had
// before: thread 0 integrates both sums and `num` in one float64 pass in
// order, rounding each cumulative value to float32 in place.  Every such row adds one to
// `seq_rows`, an int32 on the card that the wrapper owns and never reads
// (models/s2.py lumi_sequential_rows; its plain twin
// lumi_sequential_rows_ref).  At the default geometry the three sums need
// 2^36.5, 2^34.5 and 2^45.1 of the 2^52 allowed, and no row of the
// port's configurations takes the sequential pass.  A light-yield offset
// within a few ulps of E0 / r at a point inside the gap makes a dy near
// 0, whose products with t_cum have last bits too fine: there the
// light-weighted sum fails.
//
// What bounds it on the H100: each block's chains of dependent steps, not
// the card's rates (the twin's arithmetic on the points inside the gaps
// and the (I, Q) output are ~0.6 us of them): the fill's two divisions a
// point, two chunk walks of ~21 dependent float64 adds with their 64-bit
// conversions, five block passes and ~13 dependent shared loads a
// quantile.  512 rows take ~0.024 ms (PERF.md); cutting the conversions
// by 30 % and the fill to the points inside the gap gained 3 %.  A row
// on the sequential pass costs ~R dependent float64 adds: 512 such rows
// take ~0.26 ms.  The TPU form computed the same thing as (I, R) arrays
// in device memory; here nothing but the (I, Q) output leaves the SM.
//
// Numerics.  nvcc contracts a*b+c into an FMA by default; every product
// and sum the twin rounds separately is written with the _rn intrinsics
// (float and double), including the lerp y0*(1-w) + y1*w.  1e-4 / x is
// torch's reciprocal(x) * 1e-4: a correctly rounded reciprocal
// (__frcp_rn), then a float32 product.  The float32 constants (alpha, the
// field unit, 0.8 * pressure, the default gas gap and its field) are the
// values torch rounds the twin's Python floats to.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// dt and dy of the row on every grid point, 0 outside the gas gap
__device__ void fill_row(const float* __restrict__ r,
                         const float* __restrict__ rr, int R, float dg,
                         float e0, float alpha, float field_unit,
                         float dy_offset, float* t_cum, float* y_cum) {
  const float ae0 = __fmul_rn(alpha, e0);
  for (int k = threadIdx.x; k < R; k += blockDim.x) {
    float dt = 0.0f, dy = 0.0f;
    if (r[k] <= dg) {
      dt = __fmul_rn(__frcp_rn(__fmul_rn(ae0, rr[k])), 1e-4f);
      dy = __fsub_rn(__fdiv_rn(__fmul_rn(e0, rr[k]), field_unit), dy_offset);
    }
    t_cum[k] = dt;
    y_cum[k] = dy;
  }
}

// the exponent of the lowest set bit of x (x = integer * 2^e), INT_MAX
// for a zero
__device__ __forceinline__ int low_exp(float x) {
  const unsigned b = __float_as_uint(x) & 0x7fffffffu;
  if (b == 0) return INT_MAX;
  const unsigned ex = b >> 23;
  const unsigned m = (b & 0x7fffffu) | (ex ? 0x800000u : 0u);
  return (ex ? static_cast<int>(ex) - 150 : -149) + __ffs(m) - 1;
}

// every partial sum of terms whose lowest exponent is e and whose float64
// magnitude sum is s is exact in float64, in any order (see the header)
__device__ __forceinline__ bool exact_sums(int e, double s) {
  return s == 0.0 || (e != INT_MAX && s < ldexp(1.0, e + 52));
}

__global__ void __launch_bounds__(kThreads) lumi_tables_kernel(
    const float* __restrict__ r, const float* __restrict__ rr, int R,
    const float* __restrict__ qs, int Q, const float* __restrict__ dG,
    const float* __restrict__ E0, float dg_const, float e0_const,
    float alpha, float field_unit, float dy_offset, float* __restrict__ inv,
    int* __restrict__ seq_rows) {
  extern __shared__ float sh[];
  float* t_cum = sh;        // dt, then its cumulative sum
  float* y_cum = sh + R;    // dy, then its cumulative sum
  __shared__ double sh_t[kWarps], sh_y[kWarps], sh_at[kWarps],
      sh_ay[kWarps];
  __shared__ int sh_et[kWarps], sh_ey[kWarps];
  __shared__ float sh_avgt;
  const int i = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float dg = dG ? dG[i] : dg_const;
  const float e0 = E0 ? E0[i] : e0_const;
  fill_row(r, rr, R, dg, e0, alpha, field_unit, dy_offset, t_cum, y_cum);
  __syncthreads();

  // the thread's chunk [k0, k1): C points, C odd
  const int C = ((R + kThreads - 1) / kThreads) | 1;
  const int k0 = min(static_cast<int>(threadIdx.x) * C, R);
  const int k1 = min(k0 + C, R);
  double st = 0.0, sy = 0.0, at = 0.0, ay = 0.0;
  int et = INT_MAX, ey = INT_MAX;
  for (int k = k0; k < k1; ++k) {
    const float dt = t_cum[k], dy = y_cum[k];
    const double xt = dt, xy = dy;
    st = __dadd_rn(st, xt);
    sy = __dadd_rn(sy, xy);
    at = __dadd_rn(at, fabs(xt));
    ay = __dadd_rn(ay, fabs(xy));
    et = min(et, low_exp(dt));
    ey = min(ey, low_exp(dy));
  }
  // inclusive warp scans of the chunk sums, warp reductions of the rest
  double pt = st, py = sy;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double xt = __shfl_up_sync(kFull, pt, d);
    const double xy = __shfl_up_sync(kFull, py, d);
    if (lane >= d) {
      pt = __dadd_rn(pt, xt);
      py = __dadd_rn(py, xy);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    at = __dadd_rn(at, __shfl_xor_sync(kFull, at, d));
    ay = __dadd_rn(ay, __shfl_xor_sync(kFull, ay, d));
    et = min(et, __shfl_xor_sync(kFull, et, d));
    ey = min(ey, __shfl_xor_sync(kFull, ey, d));
  }
  if (lane == 31) {
    sh_t[warp] = pt;
    sh_y[warp] = py;
    sh_at[warp] = at;
    sh_ay[warp] = ay;
    sh_et[warp] = et;
    sh_ey[warp] = ey;
  }
  __syncthreads();
  // the chunk's exclusive prefixes, the row totals and the checks
  double pre_t = __dsub_rn(pt, st), pre_y = __dsub_rn(py, sy);
  double y_total = 0.0, abs_t = 0.0, abs_y = 0.0;
  et = ey = INT_MAX;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      pre_t = __dadd_rn(pre_t, sh_t[w]);
      pre_y = __dadd_rn(pre_y, sh_y[w]);
    }
    y_total = __dadd_rn(y_total, sh_y[w]);
    abs_t = __dadd_rn(abs_t, sh_at[w]);
    abs_y = __dadd_rn(abs_y, sh_ay[w]);
    et = min(et, sh_et[w]);
    ey = min(ey, sh_ey[w]);
  }
  // the chunk's cumulative values from its prefixes (pt - st is exact
  // where the row passes: both are partial sums), and its light-weighted
  // terms
  double sn = 0.0, an = 0.0;
  int en = INT_MAX;
  for (int k = k0; k < k1; ++k) {
    const float dy = y_cum[k];
    pre_t = __dadd_rn(pre_t, static_cast<double>(t_cum[k]));
    pre_y = __dadd_rn(pre_y, static_cast<double>(dy));
    const float tc = __double2float_rn(pre_t);
    t_cum[k] = tc;
    y_cum[k] = __double2float_rn(pre_y);
    const float term = __fmul_rn(tc, dy);
    const double xn = term;
    sn = __dadd_rn(sn, xn);
    an = __dadd_rn(an, fabs(xn));
    en = min(en, low_exp(term));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    sn = __dadd_rn(sn, __shfl_xor_sync(kFull, sn, d));
    an = __dadd_rn(an, __shfl_xor_sync(kFull, an, d));
    en = min(en, __shfl_xor_sync(kFull, en, d));
  }
  __syncthreads();                    // every read of the step-2 totals
  if (lane == 0) {
    sh_t[warp] = sn;
    sh_at[warp] = an;
    sh_et[warp] = en;
  }
  __syncthreads();
  double num = 0.0, abs_n = 0.0;
  en = INT_MAX;
  for (int w = 0; w < kWarps; ++w) {
    num = __dadd_rn(num, sh_t[w]);
    abs_n = __dadd_rn(abs_n, sh_at[w]);
    en = min(en, sh_et[w]);
  }
  // every thread decides alike, so the block takes one path
  if (exact_sums(et, abs_t) && exact_sums(ey, abs_y) &&
      exact_sums(en, abs_n)) {
    if (threadIdx.x == 0)
      sh_avgt = __double2float_rn(
          __ddiv_rn(num, y_total > 1e-30 ? y_total : 1e-30));
  } else {                            // refill the row, then in sequence
    fill_row(r, rr, R, dg, e0, alpha, field_unit, dy_offset, t_cum, y_cum);
    __syncthreads();
    if (threadIdx.x == 0) {
      double st0 = 0.0, sy0 = 0.0, num0 = 0.0;
      for (int k = 0; k < R; ++k) {
        const float dy = y_cum[k];
        st0 = __dadd_rn(st0, static_cast<double>(t_cum[k]));
        sy0 = __dadd_rn(sy0, static_cast<double>(dy));
        const float tc = __double2float_rn(st0);
        t_cum[k] = tc;
        y_cum[k] = __double2float_rn(sy0);
        num0 = __dadd_rn(num0, static_cast<double>(__fmul_rn(tc, dy)));
      }
      sh_avgt = __double2float_rn(
          __ddiv_rn(num0, sy0 > 1e-30 ? sy0 : 1e-30));
      atomicAdd(seq_rows, 1);
    }
  }
  __syncthreads();
  const float avgt = sh_avgt;
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
    const float y0 = __fsub_rn(t_cum[i0], avgt);
    const float y1 = __fsub_rn(t_cum[i1], avgt);
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

// dG and E0 per instruction, or (both null) dg_const and e0_const for
// every row; seq_rows counts the rows on the sequential pass
extern "C" int wfsim_lumi_tables(const void* r, const void* rr, int R,
                                 const void* qs, int Q, const void* dG,
                                 const void* E0, int n_inst, float dg_const,
                                 float e0_const, float alpha,
                                 float field_unit, float dy_offset, void* inv,
                                 void* seq_rows, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(R) * sizeof(float);
  if (n_inst <= 0 || R < 2 || Q <= 0 || smem > 200 * 1024 ||
      (dG == nullptr) != (E0 == nullptr) || seq_rows == nullptr)
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
      static_cast<const float*>(E0), dg_const, e0_const, alpha, field_unit,
      dy_offset, static_cast<float*>(inv), static_cast<int*>(seq_rows));
  return static_cast<int>(cudaGetLastError());
}
