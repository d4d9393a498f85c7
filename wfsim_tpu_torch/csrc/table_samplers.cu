// table_samplers: per-photon samples of the tabulated timing distributions.
//
// Replaces: wfsim_tpu/models/s2.py:255 luminescence_garfield_gasgap (the
// garfield gas-gap luminescence times) and wfsim_tpu/models/s1.py:108
// _nest_table_delays (the NEST S1 photon delays).  Plain twins:
// models/s2.py lumi_gasgap_times_ref and models/s1.py nest_delays_ref.  The
// per-instruction halves (the gas-gap rows and fraction, the recoil class
// and the field and energy grid positions) are torch at instruction width.
//
// Two entry points, each one block per instruction walking the
// instruction's photons [edges[i], edges[i+1]):
//   wfsim_lumi_gasgap_times  T = lerp over the gas gap of the two table
//                            rows at quantile u * (M-2), lerped between
//                            floor and ceil (s2.py:271-286); the block sums
//                            its photons' T in int64 fixed point (2^-32 ns,
//                            each rounded half to even), so the sum is
//                            exact and its order free (the wrapper raises
//                            where a sum could pass int64:
//                            check_fixed_point_range); the mean is that
//                            sum over the count in float64, rounded to
//                            float32 once; t = trunc(T - mean).  T is kept
//                            in a scratch array between the two passes.
//   wfsim_nest_delays        the (class, field, energy, quantile) table read
//                            at the 2 x 2 field/energy corners and the two
//                            quantiles around u * (M-1), summed in the
//                            twin's order (s1.py:124-129).
//
// What bounds them on the H100: the uniforms they read and the times they
// write, 8 bytes a photon (+8 for the gas-gap scratch); the tables (40 KB
// gas-gap, 8 MB NEST) stay in L2 and the reads of one instruction hit the
// same few rows.
//
// Numerics.  nvcc contracts a*b+c into an FMA by default; every product
// and sum the twin rounds separately is written with __fmul_rn /
// __fadd_rn / __fsub_rn: (hi - lo) * f + lo, (t2 - t1) * w + t1,
// a * (1 - kw) + b * kw, out + (fwgt * ewgt) * q.  Casts truncate toward
// zero as trunc + .to(int32) does.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void lumi_gasgap_kernel(const float* __restrict__ inv, int M,
                                   const long long* __restrict__ lower,
                                   const long long* __restrict__ upper,
                                   const float* __restrict__ frac,
                                   const long long* __restrict__ edges,
                                   const float* __restrict__ u,
                                   float* __restrict__ scratch,
                                   int* __restrict__ t) {
  __shared__ long long partial[kThreads];
  __shared__ float mean;
  const int i = blockIdx.x;
  const long long lo = edges[i], hi = edges[i + 1];
  if (lo >= hi) return;   // the whole block leaves together
  const float* row_lo = inv + lower[i] * M;
  const float* row_hi = inv + upper[i] * M;
  const float f = frac[i];
  const float scale = static_cast<float>(M - 2);
  long long sum = 0;
  for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    const float s = __fmul_rn(u[j], scale);
    const int i0 = static_cast<int>(floorf(s));
    const int i1 = static_cast<int>(ceilf(s));
    const float w = __fsub_rn(s, static_cast<float>(i0));
    const float t1 = __fadd_rn(
        __fmul_rn(__fsub_rn(row_hi[i0], row_lo[i0]), f), row_lo[i0]);
    const float t2 = __fadd_rn(
        __fmul_rn(__fsub_rn(row_hi[i1], row_lo[i1]), f), row_lo[i1]);
    const float T = __fadd_rn(__fmul_rn(__fsub_rn(t2, t1), w), t1);
    scratch[j] = T;
    sum += __double2ll_rn(__dmul_rn(static_cast<double>(T), 0x1p32));
  }
  partial[threadIdx.x] = sum;
  __syncthreads();
  for (int step = blockDim.x / 2; step > 0; step >>= 1) {
    if (threadIdx.x < step) partial[threadIdx.x] += partial[threadIdx.x + step];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const double total = __dmul_rn(__ll2double_rn(partial[0]), 0x1p-32);
    mean = __double2float_rn(
        __ddiv_rn(total, static_cast<double>(hi - lo)));
  }
  __syncthreads();
  for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x)
    t[j] = static_cast<int>(__fsub_rn(scratch[j], mean));
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

}  // namespace

extern "C" int wfsim_lumi_gasgap_times(const void* inv, int G, int M,
                                       const void* lower, const void* upper,
                                       const void* frac, int n_inst,
                                       const void* edges, const void* u,
                                       void* scratch, void* t, void* stream) {
  if (n_inst <= 0 || G < 1 || M < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  lumi_gasgap_kernel<<<n_inst, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inv), M,
      static_cast<const long long*>(lower),
      static_cast<const long long*>(upper), static_cast<const float*>(frac),
      static_cast<const long long*>(edges), static_cast<const float*>(u),
      static_cast<float*>(scratch), static_cast<int*>(t));
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
