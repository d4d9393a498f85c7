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
//   wfsim_pattern_diffuse  one block per instruction, a thread per two
//                          channels (rounded up to a warp, at most 256
//                          threads).  The block walks the instruction's
//                          electrons in order, in tiles of one electron a
//                          thread: first each thread computes the geometry of
//                          its electron once (the displaced position from the
//                          electron's two normals and the instruction's
//                          std_r, std_a, cos and sin of its azimuth; the
//                          inside-TPC test; the cell, its four corner weights
//                          and map offsets) into shared memory; then each
//                          channel thread walks the tile's electrons, keeps
//                          the four corner values of its channel for the
//                          current cell in registers, reloaded from the map
//                          (in L2) only when the cell changes (an
//                          instruction's electrons spread by < 0.4 cm over
//                          3.4 cm cells: one to four cells), forms the
//                          4-corner lerp and adds it to a float64 sum; the
//                          inside electrons are counted. The mean is divided
//                          once at the end.  The TPU form wrote the (E, 494)
//                          per-electron patterns to device memory (178 MB at
//                          the bench S2 batch) and scatter-added them; here
//                          they live one electron at a time in registers,
//                          each electron's geometry is computed once (not
//                          once a channel) and the map is read when the cell
//                          changes (not once an electron). Each thread takes
//                          two channels, so the per-electron loads, tests and
//                          counts serve two sums; four electrons in the cell
//                          held take a path without loads.  An instruction of
//                          more than `chunk` (2,048) electrons is split: its
//                          chunks go to blocks of their own (block n_inst + q
//                          takes the q-th chunk past an instruction's first,
//                          found by a block scan over the instructions' chunk
//                          counts), each writes its float64 sums and count,
//                          and the block that ends last adds them in chunk
//                          order.  The caller sizes the grid from the chunk
//                          count; a count too short gives NaN rows, not
//                          partial sums.  The chunk order equals the in-order
//                          sum only while the float64 partial sums are exact
//                          (the condition of models/s2.py pattern_diffuse,
//                          ROADMAP F12), which the twin on the card relies on
//                          as well; every instruction of at most `chunk`
//                          electrons is summed in order, as before.
//
// What bounds them on the H100: the lookup reads the points and writes the
// (n, out_dim) result; the maps (a 30 x 30 x 494 pattern is 1.8 MB, a
// 50 x 50 x 100 map 1 MB) stay in L2.  The diffused pattern reads two
// normals an electron and writes (I, 494) floats; its bound is the 4 x 2
// float32 operations and the float64 add per electron and channel (~90 k
// x 494 at the bench batch), and the float64 sum of a channel is one
// dependent chain over the instruction's electrons.
//
// Numerics.  nvcc contracts a*b+c into an FMA by default, which rounds once
// where the twin rounds twice: every product and sum is written with
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in the twin's order:
// f = (p - lo) / span * (g - 1), clamped to [0, g-1], floored; the corner
// weight multiplied in dimension order starting from 1; out = out +
// weight * value in corner order from 0.  The per-channel electron sum is
// float64, added in electron order; the twin adds in float64 too
// (index_add_), so both agree wherever the float64 partial sums are exact
// (float32 terms within a bounded dynamic range: see models/s2.py
// pattern_diffuse).  The per-electron lerp is corner_sum<2>'s operation
// sequence on the same weights and values, so the kernel's terms are the
// twin's bit for bit.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kMaxDims = 3;
constexpr int kThreads = 256;
constexpr int kDiffuseThreads = 256;   // at most; one electron a thread
constexpr int kDiffuseChannels = 2;    // channels a thread

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

// the 4-corner lerp of corner_sum<2>: from 0, corner by corner
__device__ __forceinline__ float lerp4(const float4& w, float v0, float v1,
                                       float v2, float v3) {
  float a = __fadd_rn(0.0f, __fmul_rn(w.x, v0));
  a = __fadd_rn(a, __fmul_rn(w.y, v1));
  a = __fadd_rn(a, __fmul_rn(w.z, v2));
  return __fadd_rn(a, __fmul_rn(w.w, v3));
}

// instruction i's electrons [lo, hi): the caller's edges end at n_e, and
// clamped, no electron is read past it
__device__ __forceinline__ void electron_range(
    const long long* __restrict__ e_edges, int i, int n_e, long long* lo,
    long long* hi) {
  long long a = e_edges[i], b = e_edges[i + 1];
  a = a < 0 ? 0 : (a > n_e ? n_e : a);
  *lo = a;
  *hi = b < a ? a : (b > n_e ? n_e : b);
}

// instruction i's chunks of `chunk` electrons past its first
__device__ __forceinline__ int extra_chunks(
    const long long* __restrict__ e_edges, int i, int n_e, int chunk) {
  long long lo, hi;
  electron_range(e_edges, i, n_e, &lo, &hi);
  return hi - lo > chunk ? static_cast<int>((hi - lo - 1) / chunk) : 0;
}

// the block's instruction and chunk: block b < n_inst takes the first
// chunk of instruction b, block n_inst + q the q-th chunk past the first in
// (instruction, chunk) order; *before the chunks past the first of the
// instructions before it, for a split instruction (a block scan over the
// instructions).  False for a block left without a chunk.
__device__ bool find_chunk(const long long* __restrict__ e_edges,
                           int n_inst, int n_e, int chunk, int* inst,
                           int* part, int* before) {
  __shared__ int found_s[3];
  __shared__ int warp_s[kDiffuseThreads / 32];
  const int b = blockIdx.x;
  if (b < n_inst && extra_chunks(e_edges, b, n_e, chunk) == 0) {
    *inst = b;
    *part = 0;
    *before = 0;
    return true;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n_inst + blockDim.x - 1) / blockDim.x;
  const int first = threadIdx.x * per;
  const int last = first + per < n_inst ? first + per : n_inst;
  int mine = 0;
  for (int q = first; q < last; ++q)
    mine += extra_chunks(e_edges, q, n_e, chunk);
  int incl = mine;                           // block scan of `mine`
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_s[warp] = incl;
  if (threadIdx.x == 0) found_s[0] = -1;
  __syncthreads();
  int run = incl - mine;
  for (int q = 0; q < warp; ++q) run += warp_s[q];
  for (int q = first; q < last; ++q) {
    const int e = extra_chunks(e_edges, q, n_e, chunk);
    const int t = b - n_inst;
    if (b < n_inst ? q == b : (t >= run && t < run + e)) {
      found_s[0] = q;
      found_s[1] = b < n_inst ? 0 : t - run + 1;
      found_s[2] = run;
    }
    run += e;
  }
  __syncthreads();
  *inst = found_s[0];
  *part = found_s[1];
  *before = found_s[2];
  return found_s[0] >= 0;
}

__global__ void __launch_bounds__(kDiffuseThreads) pattern_diffuse_kernel(
    const float* __restrict__ values, int gx, int gy, int out_dim, int C,
    const float* __restrict__ lows, const float* __restrict__ highs,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ std_r, const float* __restrict__ std_a,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    float r2_max, int n_inst, const long long* __restrict__ e_edges,
    int n_e, const float* __restrict__ n_r, const float* __restrict__ n_a,
    int chunk, double* __restrict__ partial,
    long long* __restrict__ part_count, int* __restrict__ done,
    float* __restrict__ out) {
  // a tile's electrons: the map offsets of the four corner points (x = -1
  // outside the TPC) and the four corner weights, in corner order
  __shared__ int4 ofs_s[kDiffuseThreads];
  __shared__ float4 w_s[kDiffuseThreads];
  __shared__ bool last_s;
  int i, part, before;
  if (!find_chunk(e_edges, n_inst, n_e, chunk, &i, &part, &before)) return;
  long long lo, hi;
  electron_range(e_edges, i, n_e, &lo, &hi);
  const int n_parts = hi - lo > chunk
      ? static_cast<int>((hi - lo - 1) / chunk) + 1 : 1;
  if (part == 0 && n_inst + before + n_parts - 1 > gridDim.x) {
    // fewer blocks than the split instructions' chunks: the caller's count
    // was short, and the instruction's pattern is NaN, not a partial sum
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      out[static_cast<long long>(i) * C + c] = __int_as_float(0x7fffffff);
    return;
  }
  const int slot = part == 0 ? i : n_inst + before + part - 1;
  lo += static_cast<long long>(part) * chunk;
  hi = hi < lo + chunk ? hi : lo + chunk;
  const float xi = x[i], yi = y[i], sr = std_r[i], sa = std_a[i];
  const float ct = cos_t[i], st = sin_t[i];
  const int g[kMaxDims] = {gx, gy, 1};
  const int span = blockDim.x * kDiffuseChannels;  // channels a pass
  for (int c0 = 0; c0 < C; c0 += span) {
    // the thread's channels: c0 + threadIdx.x + q * blockDim.x
    int ch[kDiffuseChannels];
    double acc[kDiffuseChannels];
#pragma unroll
    for (int q = 0; q < kDiffuseChannels; ++q) {
      ch[q] = c0 + threadIdx.x + q * blockDim.x;
      acc[q] = 0.0;
    }
    // a channel past C reads channel 0's values and is not written
    const float* src[kDiffuseChannels];
#pragma unroll
    for (int q = 0; q < kDiffuseChannels; ++q)
      src[q] = values + (out_dim == 1 || ch[q] >= C ? 0 : ch[q]);
    long long count = 0;
    // the corner values of the last cell read (its corner-0 offset)
    int cur = -1;
    float4 v[kDiffuseChannels];
    for (long long t0 = lo; t0 < hi; t0 += blockDim.x) {
      const int m = static_cast<int>(
          hi - t0 < blockDim.x ? hi - t0 : blockDim.x);
      if (threadIdx.x < m) {
        const long long j = t0 + threadIdx.x;
        const float hr = __fmul_rn(n_r[j], sr);
        const float ha = __fmul_rn(n_a[j], sa);
        const float dx = __fsub_rn(__fmul_rn(hr, ct), __fmul_rn(ha, st));
        const float dy = __fadd_rn(__fmul_rn(hr, st), __fmul_rn(ha, ct));
        float p[2] = {__fadd_rn(xi, dx), __fadd_rn(yi, dy)};
        const float r2 =
            __fadd_rn(__fmul_rn(p[0], p[0]), __fmul_rn(p[1], p[1]));
        int a[4] = {-1, 0, 0, 0};
        float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (r2 <= r2_max) {
          const Cell<2> c = find_cell<2>(p, g, lows, highs);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            long long flat;
            corner_of<2>(c, g, k, &flat, &w[k]);
            a[k] = static_cast<int>(flat) * out_dim;
          }
        }
        ofs_s[threadIdx.x] = make_int4(a[0], a[1], a[2], a[3]);
        w_s[threadIdx.x] = make_float4(w[0], w[1], w[2], w[3]);
      }
      __syncthreads();
      int k = 0;
      for (; k + 4 <= m; k += 4) {
        int4 o[4];
        float4 w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          o[u] = ofs_s[k + u];
          w[u] = w_s[k + u];
        }
        if (cur >= 0 && o[0].x == cur && o[1].x == cur && o[2].x == cur &&
            o[3].x == cur) {
          // the usual case: four electrons in the cell held
#pragma unroll
          for (int q = 0; q < kDiffuseChannels; ++q) {
            float a[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              a[u] = lerp4(w[u], v[q].x, v[q].y, v[q].z, v[q].w);
#pragma unroll
            for (int u = 0; u < 4; ++u)
              acc[q] = __dadd_rn(acc[q], static_cast<double>(a[u]));
          }
          count += 4;
          continue;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (o[u].x < 0) continue;
          cur = o[u].x;
          ++count;
#pragma unroll
          for (int q = 0; q < kDiffuseChannels; ++q) {
            v[q] = make_float4(src[q][o[u].x], src[q][o[u].y],
                               src[q][o[u].z], src[q][o[u].w]);
            acc[q] = __dadd_rn(acc[q], static_cast<double>(lerp4(
                w[u], v[q].x, v[q].y, v[q].z, v[q].w)));
          }
        }
      }
      for (; k < m; ++k) {
        const int4 o = ofs_s[k];
        if (o.x < 0) continue;
        ++count;
#pragma unroll
        for (int q = 0; q < kDiffuseChannels; ++q)
          acc[q] = __dadd_rn(acc[q], static_cast<double>(lerp4(
              w_s[k], src[q][o.x], src[q][o.y], src[q][o.z], src[q][o.w])));
      }
      __syncthreads();
    }
    const double den = static_cast<double>(count > 0 ? count : 1);
#pragma unroll
    for (int q = 0; q < kDiffuseChannels; ++q) {
      if (ch[q] >= C) continue;
      if (n_parts == 1)
        out[static_cast<long long>(i) * C + ch[q]] =
            __double2float_rn(__ddiv_rn(acc[q], den));
      else
        partial[static_cast<long long>(slot) * C + ch[q]] = acc[q];
    }
    if (n_parts > 1 && threadIdx.x == 0) part_count[slot] = count;
  }
  if (n_parts == 1) return;
  // a split instruction: the block that ends last adds the parts' sums in
  // part order (equal to the in-order sum while the sums are exact)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_s = atomicAdd(done + i, 1) == n_parts - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  long long count = 0;
  for (int p = 0; p < n_parts; ++p)
    count += __ldcg(part_count + (p == 0 ? i : n_inst + before + p - 1));
  const double den = static_cast<double>(count > 0 ? count : 1);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    double sum = 0.0;
    for (int p = 0; p < n_parts; ++p)
      sum = __dadd_rn(sum, __ldcg(partial + static_cast<long long>(
          p == 0 ? i : n_inst + before + p - 1) * C + c));
    out[static_cast<long long>(i) * C + c] =
        __double2float_rn(__ddiv_rn(sum, den));
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
    int n_inst, const void* e_edges, int n_e, const void* n_r,
    const void* n_a, int chunk, int n_extra, void* partial,
    void* part_count, void* done, void* out, void* stream) {
  if (n_inst <= 0 || C <= 0 || gx < 1 || gy < 1 || n_e < 0 || chunk <= 0 ||
      n_extra < 0 || n_extra > n_e / chunk ||
      (n_extra > 0 && !(partial && part_count && done)) ||
      (out_dim != 1 && out_dim != C))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (C + kDiffuseChannels - 1) / kDiffuseChannels;
  const int threads = per < kDiffuseThreads ? (per + 31) / 32 * 32
                                            : kDiffuseThreads;
  pattern_diffuse_kernel<<<n_inst + n_extra, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), gx, gy, out_dim, C,
      static_cast<const float*>(lows), static_cast<const float*>(highs),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(std_r), static_cast<const float*>(std_a),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      r2_max, n_inst, static_cast<const long long*>(e_edges), n_e,
      static_cast<const float*>(n_r), static_cast<const float*>(n_a), chunk,
      static_cast<double*>(partial), static_cast<long long*>(part_count),
      static_cast<int*>(done), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
