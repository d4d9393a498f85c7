// pmt_response: the PMT response of a photon batch and its truth rows.
//
// Replaces: wfsim_tpu/models/pmt.py:19 pmt_response (TTS, double-PE, SPE
// gain, live mask), :89 _pulse_truth (the trigger test and the six sums
// plus their bottom-array twins) and :171 photon_time_stats (count, min,
// max, mean offset, sigma), with ops/segment.py's sorted_segment_sum and
// segment_min_max as those use them.  Plain twins: models/pmt.py
// photon_pass_ref, pulse_truth_ref and photon_time_stats_ref.
//
// Two entry points:
//   wfsim_pmt_photon_pass  one thread per photon: t + trunc(tts*(spread/
//                          2.35482) + mean), is_dpe = u < p_dpe, the two
//                          SPE-gain indices (u*2000)->int + 1, gain = g1 +
//                          (dpe ? g2 : 0), valid = valid & live channel;
//   wfsim_pmt_row_truth    one block per truth row over the row's
//                          contiguous photons [row_edges[r], row_edges[r+1]):
//                          count, t_min and t_max (identities 2^31-1 and
//                          -(2^31-1) for an empty row), then the float64
//                          sums of the min-centred times and their squares
//                          and, with the photons' channels given, the
//                          trigger test and the twelve truth sums.  Without
//                          channels it gives the time statistics alone (the
//                          electron times of an S2 batch);
//   wfsim_pmt_row_truth_per_pmt
//                          per-PMT truth (wfsim_tpu/models/pmt.py:146-154,
//                          plain twin pulse_truth_per_pmt_ref): one block per
//                          truth row over its contiguous photons, the six
//                          sums per channel accumulated in dynamic shared
//                          memory (4 x C int32 counts, 2 x C float64 areas:
//                          32 bytes a channel, 15.8 KB at C = 494) by
//                          shared-memory atomics, then the row's (6, C)
//                          slice stored coalesced into the (4, R, C) count
//                          and (2, R, C) area outputs.
//
// What bounds them on the H100: the photon pass reads four draws and
// writes the photon (~36 bytes a photon, ~57 MB at the bench S2 batch);
// the row kernel reads each photon twice (~14 bytes) and its work per
// photon is a few float64 adds; the per-PMT kernel reads each photon once
// (~14 bytes) and writes 32 bytes a (row, channel), ~8 MB for 512 rows of
// 494 channels.  The TPU form took every per-row sum as a
// float32 cumsum over the whole photon axis differenced at the row edges
// (ROADMAP F1: late rows lost precision); the twin keeps float64 cumsums,
// and here each block reduces its own row, in float64, in registers and
// shared memory, in a fixed order (the same bits run to run).
//
// Numerics.  nvcc contracts a*b+c into an FMA by default; every product
// and sum the twin rounds separately is written with the _rn intrinsics:
// tts*scale + mean, gain_ch*ut then g1 + g2, gain*cm*current_2_adc,
// s2/cnt - mean*mean (double).  float -> int casts truncate toward zero (a
// TTS offset can be negative).  (u*2000) as an integer is at most 1999 for
// every float32 u < 1, so index + 1 stays inside uniform_to_pe's 2001
// columns.  The integer-valued sums (counts) are exact in float64 in any
// order, so they equal the twin's; the raw areas agree with the twin's
// global cumsum differences within float64 rounding (rtol 1e-12).  The
// per-PMT counts are int32 atomics, exact in any order; the per-PMT areas
// are float64 atomics, whose order varies run to run: each (row, channel)
// sum agrees with the twin within rtol 1e-12 (bitwise while its float32
// terms span less than 2^29 in magnitude, when every float64 partial sum is
// exact).  wfsim_tpu's float32 scatter-add depends on its order too:
// against it counts are equal and areas agree within rtol 1e-5.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 12;          // six sums, then their bottom twins
constexpr int kBig = 0x7fffffff;   // 2^31 - 1

__global__ void pmt_photon_pass_kernel(
    int n, const int* __restrict__ t_in, const int* __restrict__ ch_in,
    const unsigned char* __restrict__ valid_in,
    const float* __restrict__ tts, const float* __restrict__ dpe,
    const float* __restrict__ u1, const float* __restrict__ u2,
    const float* __restrict__ chan_pack, int C,
    const float* __restrict__ ut, int M, float tts_scale, float tts_mean,
    float p_dpe, int* __restrict__ t_out, int* __restrict__ ch_out,
    float* __restrict__ gain, unsigned char* __restrict__ is_dpe,
    unsigned char* __restrict__ valid_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int c = ch_in[j];
  const int cc = c < 0 ? 0 : (c > C - 1 ? C - 1 : c);
  const float* cp = chan_pack + 4 * cc;   // [gain, threshold, live, bottom]
  const float gain_ch = cp[0];
  t_out[j] = t_in[j] + static_cast<int>(
      __fadd_rn(__fmul_rn(tts[j], tts_scale), tts_mean));
  const bool dp = dpe[j] < p_dpe;
  const long long i1 = static_cast<long long>(__fmul_rn(u1[j], 2000.0f)) + 1;
  const long long i2 = static_cast<long long>(__fmul_rn(u2[j], 2000.0f)) + 1;
  const float* row = ut + static_cast<long long>(cc) * M;
  const float g1 = __fmul_rn(gain_ch, row[i1]);
  const float g2 = __fmul_rn(gain_ch, row[i2]);
  gain[j] = __fadd_rn(g1, dp ? g2 : 0.0f);
  const bool v = valid_in[j] != 0 && c >= 0 && c < C && cp[2] > 0.0f;
  ch_out[j] = v ? c : -1;
  is_dpe[j] = dp ? 1 : 0;
  valid_out[j] = v ? 1 : 0;
}

// fixed-order block reductions (warp shuffles, then warp 0 over the warps)
__device__ double block_sum(double x, double* scratch) {
  for (int o = 16; o > 0; o >>= 1)
    x = __dadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s = __dadd_rn(s, scratch[w]);
  return s;   // valid in thread 0
}

__device__ long long block_sum_ll(long long x, long long* scratch) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  long long s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += scratch[w];
  return s;
}

__device__ int block_min(int x, int* scratch) {
  for (int o = 16; o > 0; o >>= 1)
    x = min(x, __shfl_down_sync(0xffffffffu, x, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  int s = kBig;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s = min(s, scratch[w]);
  return s;
}

__device__ int block_max(int x, int* scratch) {
  for (int o = 16; o > 0; o >>= 1)
    x = max(x, __shfl_down_sync(0xffffffffu, x, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  int s = -kBig;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s = max(s, scratch[w]);
  return s;
}

// the truth terms of valid photon j: its clamped channel, the trigger test
// (peak amplitude in ADC above the channel threshold), the DPE flag, the
// raw area gain / g and the bottom-array flag
struct PhotonTruth {
  int ch;
  bool above, dpe, bottom;
  float g_over;
};

__device__ __forceinline__ PhotonTruth photon_truth(
    long long j, const int* __restrict__ t, const int* __restrict__ ch,
    const float* __restrict__ gain, const unsigned char* __restrict__ is_dpe,
    const float* __restrict__ chan_pack, int C,
    const float* __restrict__ current_max, int dt, float current_2_adc) {
  const int c = ch[j];
  const int cc = c < 0 ? 0 : (c > C - 1 ? C - 1 : c);
  const float* cp = chan_pack + 4 * cc;
  int rem = t[j] % dt;                  // floor-mod, as torch.remainder
  if (rem < 0) rem += dt;
  const float g = gain[j];
  const float amp = __fmul_rn(__fmul_rn(g, current_max[rem]), current_2_adc);
  PhotonTruth p;
  p.ch = cc;
  p.above = amp > cp[1];
  p.dpe = is_dpe[j] != 0;
  p.bottom = cp[3] > 0.0f;
  p.g_over = __fdiv_rn(g, cp[0] > 1e-30f ? cp[0] : 1e-30f);
  return p;
}

__global__ void pmt_row_truth_kernel(
    const long long* __restrict__ row_edges, int n_rows,
    const int* __restrict__ t, const unsigned char* __restrict__ valid,
    const int* __restrict__ ch, const float* __restrict__ gain,
    const unsigned char* __restrict__ is_dpe,
    const float* __restrict__ chan_pack, int C,
    const float* __restrict__ current_max, int dt, float current_2_adc,
    double* __restrict__ sums, long long* __restrict__ count,
    int* __restrict__ t_min, int* __restrict__ t_max,
    double* __restrict__ mean_offset, double* __restrict__ sigma) {
  __shared__ double sh_d[kWarps];
  __shared__ long long sh_ll[kWarps];
  __shared__ int sh_i[kWarps];
  __shared__ int sh_base;
  const int r = blockIdx.x;
  const long long lo = row_edges[r], hi = row_edges[r + 1];

  // pass 1: count, min, max of the valid photons
  long long cnt = 0;
  int mn = kBig, mx = -kBig;
  for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    if (valid != nullptr && !valid[j]) continue;
    ++cnt;
    mn = min(mn, t[j]);
    mx = max(mx, t[j]);
  }
  cnt = block_sum_ll(cnt, sh_ll);
  mn = block_min(mn, sh_i);
  mx = block_max(mx, sh_i);
  if (threadIdx.x == 0) sh_base = cnt > 0 ? mn : 0;
  __syncthreads();
  const int base = sh_base;

  // pass 2: min-centred moments and the truth sums
  double s1 = 0.0, s2 = 0.0;
  double acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
  for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    const bool v = valid == nullptr || valid[j] != 0;
    if (v) {
      const double c = static_cast<double>(t[j] - base);
      s1 = __dadd_rn(s1, c);
      s2 = __dadd_rn(s2, __dmul_rn(c, c));
    }
    if (ch == nullptr || !v) continue;
    const PhotonTruth p = photon_truth(j, t, ch, gain, is_dpe, chan_pack, C,
                                       current_max, dt, current_2_adc);
    const double pe = p.dpe ? 2.0 : 1.0;
    const double x[6] = {1.0, pe, p.above ? 1.0 : 0.0, p.above ? pe : 0.0,
                         static_cast<double>(p.g_over),
                         p.above ? static_cast<double>(p.g_over) : 0.0};
    const bool bottom = p.bottom;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      acc[k] = __dadd_rn(acc[k], x[k]);
      if (bottom) acc[6 + k] = __dadd_rn(acc[6 + k], x[k]);
    }
  }
  s1 = block_sum(s1, sh_d);
  s2 = block_sum(s2, sh_d);
  if (ch != nullptr) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      const double s = block_sum(acc[k], sh_d);
      if (threadIdx.x == 0) sums[static_cast<long long>(k) * n_rows + r] = s;
    }
  }
  if (threadIdx.x == 0) {
    const double cntf = cnt > 1 ? static_cast<double>(cnt) : 1.0;
    const double m = __ddiv_rn(s1, cntf);
    double var = __dsub_rn(__ddiv_rn(s2, cntf), __dmul_rn(m, m));
    var = var > 0.0 ? var : 0.0;
    count[r] = cnt;
    t_min[r] = mn;
    t_max[r] = mx;
    mean_offset[r] = m;
    sigma[r] = __dsqrt_rn(var);
  }
}

// one block per truth row r: the four counts and two areas of each channel
// in shared memory, then the row's slices of counts (4, R, C) and areas
// (2, R, C)
__global__ void pmt_row_truth_per_pmt_kernel(
    const long long* __restrict__ row_edges, int n_rows,
    const int* __restrict__ t, const unsigned char* __restrict__ valid,
    const int* __restrict__ ch, const float* __restrict__ gain,
    const unsigned char* __restrict__ is_dpe,
    const float* __restrict__ chan_pack, int C,
    const float* __restrict__ current_max, int dt, float current_2_adc,
    int* __restrict__ counts, double* __restrict__ areas) {
  extern __shared__ double sh_area[];           // 2 * C, then 4 * C ints
  int* sh_cnt = reinterpret_cast<int*>(sh_area + 2 * C);
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) sh_area[i] = 0.0;
  for (int i = threadIdx.x; i < 4 * C; i += blockDim.x) sh_cnt[i] = 0;
  __syncthreads();
  const int r = blockIdx.x;
  const long long lo = row_edges[r], hi = row_edges[r + 1];
  for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    if (!valid[j]) continue;
    const PhotonTruth p = photon_truth(j, t, ch, gain, is_dpe, chan_pack, C,
                                       current_max, dt, current_2_adc);
    const int pe = p.dpe ? 2 : 1;
    const double area = static_cast<double>(p.g_over);
    atomicAdd(sh_cnt + p.ch, 1);
    atomicAdd(sh_cnt + C + p.ch, pe);
    atomicAdd(sh_area + p.ch, area);
    if (p.above) {
      atomicAdd(sh_cnt + 2 * C + p.ch, 1);
      atomicAdd(sh_cnt + 3 * C + p.ch, pe);
      atomicAdd(sh_area + C + p.ch, area);
    }
  }
  __syncthreads();
  const long long plane = static_cast<long long>(n_rows) * C;
  const long long base = static_cast<long long>(r) * C;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
#pragma unroll
    for (int k = 0; k < 4; ++k) counts[k * plane + base + i] = sh_cnt[k * C + i];
#pragma unroll
    for (int k = 0; k < 2; ++k) areas[k * plane + base + i] = sh_area[k * C + i];
  }
}

unsigned grid_of(long long work) {
  return static_cast<unsigned>((work + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int wfsim_pmt_photon_pass(
    int n, const void* t_in, const void* ch_in, const void* valid_in,
    const void* tts, const void* dpe, const void* u1, const void* u2,
    const void* chan_pack, int C, const void* ut, int M, float tts_scale,
    float tts_mean, float p_dpe, void* t_out, void* ch_out, void* gain,
    void* is_dpe, void* valid_out, void* stream) {
  if (n <= 0 || C <= 0 || M < 2001)
    return static_cast<int>(cudaErrorInvalidValue);
  pmt_photon_pass_kernel<<<grid_of(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const int*>(t_in), static_cast<const int*>(ch_in),
      static_cast<const unsigned char*>(valid_in),
      static_cast<const float*>(tts), static_cast<const float*>(dpe),
      static_cast<const float*>(u1), static_cast<const float*>(u2),
      static_cast<const float*>(chan_pack), C, static_cast<const float*>(ut),
      M, tts_scale, tts_mean, p_dpe, static_cast<int*>(t_out),
      static_cast<int*>(ch_out), static_cast<float*>(gain),
      static_cast<unsigned char*>(is_dpe),
      static_cast<unsigned char*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wfsim_pmt_row_truth(
    const void* row_edges, int n_rows, const void* t, const void* valid,
    const void* ch, const void* gain, const void* is_dpe,
    const void* chan_pack, int C, const void* current_max, int dt,
    float current_2_adc, void* sums, void* count, void* t_min, void* t_max,
    void* mean_offset, void* sigma, void* stream) {
  if (n_rows <= 0 || (ch != nullptr && (C <= 0 || dt <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  pmt_row_truth_kernel<<<n_rows, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(row_edges), n_rows,
      static_cast<const int*>(t), static_cast<const unsigned char*>(valid),
      static_cast<const int*>(ch), static_cast<const float*>(gain),
      static_cast<const unsigned char*>(is_dpe),
      static_cast<const float*>(chan_pack), C,
      static_cast<const float*>(current_max), dt, current_2_adc,
      static_cast<double*>(sums), static_cast<long long*>(count),
      static_cast<int*>(t_min), static_cast<int*>(t_max),
      static_cast<double*>(mean_offset), static_cast<double*>(sigma));
  return static_cast<int>(cudaGetLastError());
}

// counts (4, n_rows, C) int32 and areas (2, n_rows, C) float64, every entry
// written; C <= 1536 keeps the block's 32 * C bytes of shared memory under
// the 48 KB default
extern "C" int wfsim_pmt_row_truth_per_pmt(
    const void* row_edges, int n_rows, const void* t, const void* valid,
    const void* ch, const void* gain, const void* is_dpe,
    const void* chan_pack, int C, const void* current_max, int dt,
    float current_2_adc, void* counts, void* areas, void* stream) {
  if (n_rows <= 0 || C <= 0 || C > 1536 || dt <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(C) * (2 * sizeof(double) +
                                                4 * sizeof(int));
  pmt_row_truth_per_pmt_kernel<<<n_rows, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(row_edges), n_rows,
      static_cast<const int*>(t), static_cast<const unsigned char*>(valid),
      static_cast<const int*>(ch), static_cast<const float*>(gain),
      static_cast<const unsigned char*>(is_dpe),
      static_cast<const float*>(chan_pack), C,
      static_cast<const float*>(current_max), dt, current_2_adc,
      static_cast<int*>(counts), static_cast<double*>(areas));
  return static_cast<int>(cudaGetLastError());
}
