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
//   wfsim_grid_lookup      two kernels behind one entry, by out_dim:
//                          out_dim == 1 (LCE, FDC, corrections, gas gap,
//                          later the optical splines at photon width): one
//                          thread per point finds its cell and fractions
//                          and sums the cell's 2^d corners of the map.
//                          out_dim > 1 (the 494-wide patterns): one warp per
//                          point.  The warp finds the point's cell once
//                          (every lane holds the same bits), lane c < 2^d
//                          forms corner c's flat row and weight, and a
//                          shuffle hands all 2^d of them to every lane; the
//                          lanes then stride over the columns, each corner
//                          row read coalesced, the corners summed in the
//                          twin's order: a point's d divisions and 2^d
//                          offsets are computed once, not once a column.
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
// (n, out_dim) result; the maps (a 30 x 30 x 494 pattern is 1.8 MB, a
// 50 x 50 x 100 map 1 MB) stay in L2.  The diffused pattern reads two
// normals an electron and writes (I, 494) floats; its bound is the 4 x 2
// float32 operations and the float64 add per electron and channel (~90 k
// x 494 at the bench batch).
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

// D, the map's input dimensions, is a template argument, so the cell's
// arrays and the corner loops unroll into registers (a runtime d put them
// in local memory)
template <int D>
struct Cell {
  int i0[D];
  float w[D];
};

// the point's lower cell index and fractions, as ops/interp.py _cell
template <int D>
__device__ __forceinline__ Cell<D> find_cell(const float* p, const int* g,
                                             const float* lows,
                                             const float* highs) {
  Cell<D> c;
#pragma unroll
  for (int k = 0; k < D; ++k) {
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

// corner `corner`'s flat grid row and weight (the weight multiplied in
// dimension order from 1, as the twin)
template <int D>
__device__ __forceinline__ void corner_of(const Cell<D>& c, const int* g,
                                          int corner, long long* flat,
                                          float* weight) {
  long long f = 0;
  float w = 1.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const int b = (corner >> k) & 1;
    int idx = c.i0[k] + b;
    idx = idx < g[k] - 1 ? idx : g[k] - 1;
    f = f * g[k] + idx;
    w = __fmul_rn(w, b ? c.w[k] : __fsub_rn(1.0f, c.w[k]));
  }
  *flat = f;
  *weight = w;
}

// sum over the 2^D corners of column `col`, in the twin's order
template <int D>
__device__ __forceinline__ float corner_sum(const float* __restrict__ values,
                                            const int* g, int out_dim,
                                            int col, const Cell<D>& c) {
  float acc = 0.0f;
#pragma unroll
  for (int corner = 0; corner < (1 << D); ++corner) {
    long long flat;
    float weight;
    corner_of<D>(c, g, corner, &flat, &weight);
    acc = __fadd_rn(acc, __fmul_rn(weight, values[flat * out_dim + col]));
  }
  return acc;
}

template <int D>
__global__ void lookup_points_kernel(const float* __restrict__ values,
                                     int g0, int g1, int g2,
                                     const float* __restrict__ lows,
                                     const float* __restrict__ highs,
                                     const float* __restrict__ points, int n,
                                     float* __restrict__ out) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int g[kMaxDims] = {g0, g1, g2};
  out[p] = corner_sum<D>(values, g, 1, 0,
                         find_cell<D>(points + p * D, g, lows, highs));
}

template <int D>
__global__ void lookup_rows_kernel(const float* __restrict__ values, int g0,
                                   int g1, int g2, int out_dim,
                                   const float* __restrict__ lows,
                                   const float* __restrict__ highs,
                                   const float* __restrict__ points, int n,
                                   float* __restrict__ out) {
  const long long p =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= n) return;                      // the whole warp leaves together
  const int g[kMaxDims] = {g0, g1, g2};
  const Cell<D> c = find_cell<D>(points + p * D, g, lows, highs);
  // lane `corner` forms that corner's row and weight; a shuffle hands
  // every lane all 2^D of them
  long long flat;
  float weight;
  corner_of<D>(c, g, lane & ((1 << D) - 1), &flat, &weight);
  const float* rows[1 << D];
  float wts[1 << D];
#pragma unroll
  for (int k = 0; k < (1 << D); ++k) {
    rows[k] = values + __shfl_sync(0xffffffffu, flat, k) * out_dim;
    wts[k] = __shfl_sync(0xffffffffu, weight, k);
  }
  float* o = out + p * out_dim;
  for (int col = lane; col < out_dim; col += 32) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < (1 << D); ++k)
      acc = __fadd_rn(acc, __fmul_rn(wts[k], rows[k][col]));
    o[col] = acc;
  }
}

template <int D>
void launch_lookup(const float* v, int g0, int g1, int g2, int out_dim,
                   const float* lo, const float* hi, const float* pts, int n,
                   float* o, cudaStream_t s) {
  if (out_dim == 1) {
    const long long blocks = (static_cast<long long>(n) + kThreads - 1) /
                             kThreads;
    lookup_points_kernel<D><<<static_cast<unsigned>(blocks), kThreads, 0,
                              s>>>(v, g0, g1, g2, lo, hi, pts, n, o);
  } else {
    const int warps = kThreads / 32;
    const long long blocks = (static_cast<long long>(n) + warps - 1) / warps;
    lookup_rows_kernel<D><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        v, g0, g1, g2, out_dim, lo, hi, pts, n, o);
  }
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
        const Cell<2> c = find_cell<2>(p, g, lows, highs);
        acc = __dadd_rn(acc, static_cast<double>(
                                 corner_sum<2>(values, g, out_dim, col, c)));
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
                                 int g2, int out_dim,
                                 const void* lows, const void* highs,
                                 const void* points, int n, void* out,
                                 void* stream) {
  if (d < 1 || d > kMaxDims || out_dim <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(values);
  const float* lo = static_cast<const float*>(lows);
  const float* hi = static_cast<const float*>(highs);
  const float* pts = static_cast<const float*>(points);
  float* o = static_cast<float*>(out);
  if (d == 1)
    launch_lookup<1>(v, g0, g1, g2, out_dim, lo, hi, pts, n, o, s);
  else if (d == 2)
    launch_lookup<2>(v, g0, g1, g2, out_dim, lo, hi, pts, n, o, s);
  else
    launch_lookup<3>(v, g0, g1, g2, out_dim, lo, hi, pts, n, o, s);
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
