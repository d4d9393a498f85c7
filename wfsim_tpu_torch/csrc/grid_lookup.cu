// grid_lookup: multilinear detector-map lookups.
//
// Replaces: wfsim_tpu/ops/interp.py:85 grid_lookup (every map lookup of the
// S1 and S2 chains: LCE, patterns, S2 correction, inverse FDC, gas gap) and
// wfsim_tpu/models/s2.py:300 s2_pattern_map_diffuse (the per-electron
// pattern lookup of transverse diffusion and its per-instruction mean).
// Plain twins: ops/interp.py grid_lookup_ref and models/s2.py
// pattern_diffuse_ref.
//
// Two entry points:
//   wfsim_grid_lookup      one thread per (point, output column); the
//                          thread finds the point's cell and fractions and
//                          sums the 2^d corners of its column.  Neighbouring
//                          threads read neighbouring columns of a corner, so
//                          a 494-wide pattern row is one coalesced read.
//   wfsim_pattern_diffuse  one block per instruction, a thread per channel
//                          (512 threads for 494 channels).  The block walks
//                          the instruction's electrons in order: displaced
//                          position from the electron's two normals and the
//                          instruction's std_r, std_a, cos and sin of its
//                          azimuth; the inside-TPC test; the 4-corner lerp
//                          of the thread's channel; a float64 sum and a
//                          count.  The mean is divided once at the end.  The
//                          TPU form wrote the (E, 494) per-electron patterns
//                          to device memory (178 MB at the bench S2 batch)
//                          and scatter-added them; here they live one
//                          electron at a time in registers.
//
// What bounds them on the H100: the lookup reads the points and writes the
// (n, out_dim) result; the maps (a 30 x 30 x 494 pattern is 1.8 MB) stay in
// L2.  The diffused pattern reads two normals an electron and writes
// (I, 494) floats; its bound is the 4 x 2 float32 operations and the
// float64 add per electron and channel (~90 k x 494 at the bench batch).
//
// Numerics.  nvcc contracts a*b+c into an FMA by default, which rounds once
// where the twin rounds twice: every product and sum is written with
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in the twin's order:
// f = (p - lo) / span * (g - 1), clamped to [0, g-1], floored; the corner
// weight multiplied in dimension order starting from 1; out = out +
// weight * value in corner order from 0.  The per-channel electron sum is
// float64; the twin adds in float64 too (index_add_), so both agree
// wherever the float64 partial sums are exact (float32 terms within a
// bounded dynamic range: see models/s2.py pattern_diffuse).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDims = 3;
constexpr int kThreads = 256;
constexpr int kDiffuseThreads = 512;

struct Cell {
  int i0[kMaxDims];
  float w[kMaxDims];
};

// the point's lower cell index and fractions, as ops/interp.py _cell
__device__ __forceinline__ Cell find_cell(const float* p, int d,
                                          const int* g, const float* lows,
                                          const float* highs) {
  Cell c;
  for (int k = 0; k < d; ++k) {
    const float lo = lows[k];
    float span = __fsub_rn(highs[k], lo);
    span = span < 1e-30f ? 1e-30f : span;
    const float gm1 = static_cast<float>(g[k]) - 1.0f;
    float f = __fmul_rn(__fdiv_rn(__fsub_rn(p[k], lo), span), gm1);
    f = f < 0.0f ? 0.0f : f;
    f = f > gm1 ? gm1 : f;
    int i0 = static_cast<int>(floorf(f));
    i0 = i0 < 0 ? 0 : i0;
    i0 = i0 > g[k] - 1 ? g[k] - 1 : i0;
    c.i0[k] = i0;
    c.w[k] = __fsub_rn(f, static_cast<float>(i0));
  }
  return c;
}

// sum over the 2^d corners of column `col`, in the twin's order
__device__ __forceinline__ float corner_sum(const float* __restrict__ values,
                                            int d, const int* g, int out_dim,
                                            int col, const Cell& c) {
  float acc = 0.0f;
  for (int corner = 0; corner < (1 << d); ++corner) {
    long long flat = 0;
    float weight = 1.0f;
    for (int k = 0; k < d; ++k) {
      const int b = (corner >> k) & 1;
      int idx = c.i0[k] + b;
      idx = idx < g[k] - 1 ? idx : g[k] - 1;
      flat = flat * g[k] + idx;
      weight = __fmul_rn(weight, b ? c.w[k] : __fsub_rn(1.0f, c.w[k]));
    }
    acc = __fadd_rn(acc, __fmul_rn(weight, values[flat * out_dim + col]));
  }
  return acc;
}

__global__ void grid_lookup_kernel(const float* __restrict__ values, int d,
                                   int g0, int g1, int g2, int out_dim,
                                   const float* __restrict__ lows,
                                   const float* __restrict__ highs,
                                   const float* __restrict__ points, int n,
                                   float* __restrict__ out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n) * out_dim) return;
  const long long p = idx / out_dim;
  const int col = static_cast<int>(idx - p * out_dim);
  const int g[kMaxDims] = {g0, g1, g2};
  const Cell c = find_cell(points + p * d, d, g, lows, highs);
  out[idx] = corner_sum(values, d, g, out_dim, col, c);
}

__global__ void pattern_diffuse_kernel(
    const float* __restrict__ values, int gx, int gy, int out_dim, int C,
    const float* __restrict__ lows, const float* __restrict__ highs,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ std_r, const float* __restrict__ std_a,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    float r2_max, const long long* __restrict__ e_edges,
    const float* __restrict__ n_r, const float* __restrict__ n_a,
    float* __restrict__ out) {
  const int i = blockIdx.x;
  const long long lo = e_edges[i], hi = e_edges[i + 1];
  const float xi = x[i], yi = y[i], sr = std_r[i], sa = std_a[i];
  const float ct = cos_t[i], st = sin_t[i];
  const int g[kMaxDims] = {gx, gy, 1};
  for (int c0 = 0; c0 < C; c0 += blockDim.x) {
    const int ch = c0 + threadIdx.x;
    const int col = out_dim == 1 ? 0 : ch;
    double acc = 0.0;
    long long count = 0;
    for (long long j = lo; j < hi; ++j) {
      const float hr = __fmul_rn(n_r[j], sr);
      const float ha = __fmul_rn(n_a[j], sa);
      const float dx = __fsub_rn(__fmul_rn(hr, ct), __fmul_rn(ha, st));
      const float dy = __fadd_rn(__fmul_rn(hr, st), __fmul_rn(ha, ct));
      float p[2] = {__fadd_rn(xi, dx), __fadd_rn(yi, dy)};
      const float r2 = __fadd_rn(__fmul_rn(p[0], p[0]), __fmul_rn(p[1], p[1]));
      if (!(r2 <= r2_max)) continue;
      ++count;
      if (ch < C) {
        const Cell c = find_cell(p, 2, g, lows, highs);
        acc = __dadd_rn(acc, static_cast<double>(
                                 corner_sum(values, 2, g, out_dim, col, c)));
      }
    }
    if (ch < C) {
      const double den = static_cast<double>(count > 0 ? count : 1);
      out[static_cast<long long>(i) * C + ch] =
          __double2float_rn(__ddiv_rn(acc, den));
    }
  }
}

}  // namespace

extern "C" int wfsim_grid_lookup(const void* values, int d, int g0, int g1,
                                 int g2, int out_dim, const void* lows,
                                 const void* highs, const void* points, int n,
                                 void* out, void* stream) {
  if (d < 1 || d > kMaxDims || out_dim <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n) * out_dim;
  const long long blocks = (total + kThreads - 1) / kThreads;
  grid_lookup_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), d, g0, g1, g2, out_dim,
      static_cast<const float*>(lows), static_cast<const float*>(highs),
      static_cast<const float*>(points), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wfsim_pattern_diffuse(
    const void* values, int gx, int gy, int out_dim, int C, const void* lows,
    const void* highs, const void* x, const void* y, const void* std_r,
    const void* std_a, const void* cos_t, const void* sin_t, float r2_max,
    int n_inst, const void* e_edges, const void* n_r, const void* n_a,
    void* out, void* stream) {
  if (n_inst <= 0 || C <= 0 || gx < 1 || gy < 1 ||
      (out_dim != 1 && out_dim != C))
    return static_cast<int>(cudaErrorInvalidValue);
  pattern_diffuse_kernel<<<n_inst, kDiffuseThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), gx, gy, out_dim, C,
      static_cast<const float*>(lows), static_cast<const float*>(highs),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(std_r), static_cast<const float*>(std_a),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      r2_max, static_cast<const long long*>(e_edges),
      static_cast<const float*>(n_r), static_cast<const float*>(n_a),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
