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
// The gas-gap and NEST entry points run one block per instruction walking
// the instruction's photons [edges[i], edges[i+1]):
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
// The custom and garfield entry points run one thread per photon, which
// finds its instruction by a binary search of the edges:
//   wfsim_s1_custom_delays   the delay of the instruction's recoil class
//                            only, from the class's draws: ER the primary
//                            singlet/triplet delay where u_prim <
//                            excfrac, else clip(reco_time * (-1 + 1/u),
//                            0, 1000) (u clamped to >= 1e-12) plus the
//                            secondary one; NR and alpha their
//                            singlet/triplet delay; LED u * led_length.  A
//                            singlet/triplet delay is trunc(exp *
//                            lifetime) as an int, then a float, as the
//                            twin (and JAX, s1.py:77-78) casts it;
//   wfsim_lumi_garfield_times
//                            two launches.  One thread per instruction
//                            finds the wire distance d: the rotated y,
//                            x sin(tilt) + y cos(tilt), plus pitch/2,
//                            modulo the pitch with the divisor's sign
//                            (jnp.remainder: fmodf, then + pitch where
//                            the remainder is non-zero and its sign is
//                            not the pitch's), minus pitch/2; or, in the
//                            confine mode, max(-c, u * 2c - c) from the
//                            instruction's uniform; then the table row
//                            nearest d, argmin |d - x_r|, the lowest on a
//                            tie.  One thread per photon then writes
//                            int(table[row, col]) - avgt.
//
// What bounds them on the H100: the uniforms they read and the times they
// write, 8 bytes a photon (+8 for the gas-gap scratch; 48 for the custom
// delays, which read the 11 draws of the photon's class only, 2-6 of
// them; 12 for the garfield times); the tables (40 KB gas-gap, 8 MB NEST,
// 22 KB garfield) stay in L2 and the reads of one instruction hit the
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

__device__ __forceinline__ int instruction_of(const long long* edges,
                                              int n_inst, long long j) {
  // the largest i with edges[i] <= j: edges[0] = 0 <= j < edges[n_inst]
  int lo = 0, hi = n_inst;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (edges[mid] <= j) lo = mid; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float singlet_triplet(float u, float e,
                                                 float frac, float t1,
                                                 float t3) {
  return static_cast<float>(
      static_cast<int>(__fmul_rn(e, u < frac ? t1 : t3)));
}

struct CustomDraws {
  const float *u_prim, *u_st_prim, *exp_st_prim, *u_reco, *u_st_sec,
      *exp_st_sec, *u_nr, *exp_nr, *u_alpha, *exp_alpha, *u_led;
};

struct CustomConsts {
  float excfrac, reco_time, f_prim, f_sec, f_nr, f_alpha, t1, t3, led;
};

__global__ void custom_delays_kernel(const long long* __restrict__ cls,
                                     const long long* __restrict__ edges,
                                     int n_inst, int n, CustomDraws d,
                                     CustomConsts k,
                                     float* __restrict__ out) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    const long long c = cls[instruction_of(edges, n_inst, j)];
    float v;
    if (c == 1) {
      v = singlet_triplet(d.u_nr[j], d.exp_nr[j], k.f_nr, k.t1, k.t3);
    } else if (c == 2) {
      v = singlet_triplet(d.u_alpha[j], d.exp_alpha[j], k.f_alpha, k.t1,
                          k.t3);
    } else if (c == 3) {
      v = __fmul_rn(d.u_led[j], k.led);
    } else if (d.u_prim[j] < k.excfrac) {
      v = singlet_triplet(d.u_st_prim[j], d.exp_st_prim[j], k.f_prim, k.t1,
                          k.t3);
    } else {
      const float u = fmaxf(d.u_reco[j], 1e-12f);
      float reco = __fmul_rn(k.reco_time,
                             __fadd_rn(-1.0f, __fdiv_rn(1.0f, u)));
      reco = fminf(fmaxf(reco, 0.0f), 1000.0f);
      v = __fadd_rn(reco, singlet_triplet(d.u_st_sec[j], d.exp_st_sec[j],
                                          k.f_sec, k.t1, k.t3));
    }
    out[j] = v;
  }
}

__global__ void garfield_rows_kernel(const float* __restrict__ xy,
                                     const float* __restrict__ u_wire,
                                     int n_inst,
                                     const float* __restrict__ x_axis, int R,
                                     float sin_t, float cos_t, float pitch,
                                     float half_pitch, float confine,
                                     int* __restrict__ rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_inst) return;
  float d;
  if (u_wire != nullptr) {
    d = fmaxf(-confine, __fadd_rn(__fmul_rn(u_wire[i],
                                            __fadd_rn(confine, confine)),
                                  -confine));
  } else {
    const float rot_y = __fadd_rn(__fmul_rn(xy[2 * i], sin_t),
                                  __fmul_rn(xy[2 * i + 1], cos_t));
    float r = fmodf(__fadd_rn(rot_y, half_pitch), pitch);
    if (r != 0.0f && ((r < 0.0f) != (pitch < 0.0f))) r = __fadd_rn(r, pitch);
    d = __fsub_rn(r, half_pitch);
  }
  int best_r = 0;
  float best = fabsf(__fsub_rn(d, x_axis[0]));
  for (int r = 1; r < R; ++r) {
    const float diff = fabsf(__fsub_rn(d, x_axis[r]));
    if (diff < best) {
      best = diff;
      best_r = r;
    }
  }
  rows[i] = best_r;
}

__global__ void garfield_times_kernel(const float* __restrict__ table, int M,
                                      const int* __restrict__ rows,
                                      const long long* __restrict__ edges,
                                      int n_inst,
                                      const long long* __restrict__ cols,
                                      int avgt, int n, int* __restrict__ t) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    const int row = rows[instruction_of(edges, n_inst, j)];
    t[j] = static_cast<int>(table[static_cast<long long>(row) * M + cols[j]])
           - avgt;
  }
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 132 * 32 ? blocks : 132 * 32);
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

extern "C" int wfsim_s1_custom_delays(
    const void* cls, const void* edges, int n_inst, int n,
    const void* u_prim, const void* u_st_prim, const void* exp_st_prim,
    const void* u_reco, const void* u_st_sec, const void* exp_st_sec,
    const void* u_nr, const void* exp_nr, const void* u_alpha,
    const void* exp_alpha, const void* u_led, float excfrac,
    float reco_time, float f_prim, float f_sec, float f_nr, float f_alpha,
    float t1, float t3, float led, void* out, void* stream) {
  if (n_inst <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const CustomDraws d{
      static_cast<const float*>(u_prim), static_cast<const float*>(u_st_prim),
      static_cast<const float*>(exp_st_prim),
      static_cast<const float*>(u_reco), static_cast<const float*>(u_st_sec),
      static_cast<const float*>(exp_st_sec), static_cast<const float*>(u_nr),
      static_cast<const float*>(exp_nr), static_cast<const float*>(u_alpha),
      static_cast<const float*>(exp_alpha), static_cast<const float*>(u_led)};
  const CustomConsts k{excfrac, reco_time, f_prim, f_sec, f_nr, f_alpha,
                       t1, t3, led};
  custom_delays_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(cls),
      static_cast<const long long*>(edges), n_inst, n, d, k,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wfsim_lumi_garfield_times(
    const void* table, int R, int M, const void* x_axis, const void* xy,
    const void* u_wire, int n_inst, const void* edges, const void* cols,
    int n, float sin_t, float cos_t, float pitch, float half_pitch,
    float confine, int avgt, void* rows, void* t, void* stream) {
  if (n_inst <= 0 || n <= 0 || R < 1 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  garfield_rows_kernel<<<(n_inst + kThreads - 1) / kThreads, kThreads, 0,
                         st>>>(
      static_cast<const float*>(xy), static_cast<const float*>(u_wire),
      n_inst, static_cast<const float*>(x_axis), R, sin_t, cos_t, pitch,
      half_pitch, confine, static_cast<int*>(rows));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  garfield_times_kernel<<<grid_for(n), kThreads, 0, st>>>(
      static_cast<const float*>(table), M, static_cast<const int*>(rows),
      static_cast<const long long*>(edges), n_inst,
      static_cast<const long long*>(cols), avgt, n, static_cast<int*>(t));
  return static_cast<int>(cudaGetLastError());
}
