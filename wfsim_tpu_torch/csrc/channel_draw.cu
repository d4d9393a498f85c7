// channel_draw: the inverse-CDF channel draw of every photon.
//
// Replaces: wfsim_tpu/ops/randsample.py:120 categorical_from_cdf and :99
// search_sorted_rows, as the S1 and S2 chains call them (wfsim_tpu
// models/s1.py:162-170, models/s2.py:355-374), together with the pattern
// cumsum in front of them.  Plain twin: ops/randsample.py channel_draw_ref.
//
// One block per instruction.  Thread 0 builds the row's CDF in shared
// memory from the masked pattern (map lookup times live mask); the block's
// threads then walk the instruction's photons [edges[i], edges[i+1]) (the
// photons are grouped by instruction) and binary-search the row: the
// smallest c with cdf[c] > u * cdf[C-1] (side 'right'), clamped to C-1, or
// -1 where the row has no mass.  The TPU form searched a (I, 494) CDF in
// device memory with a two-level block search (_plan_widths/_descend) so
// that each step was one wide gather; here the row sits in shared memory
// (494 floats) and the search is nine shared-memory loads.
//
// What bounds it on the H100: reading the uniforms and writing the
// channels, 8 bytes a photon (~13 MB at the bench S2 batch of 1.57 M
// photons); the per-row CDF build is 494 sequential double adds per block.
//
// Numerics.  The CDF is the repaired twin's rule: a sequential float64
// accumulation, each entry rounded to float32 once (torch's CPU cumsum of
// float32 does exactly this).  A float32 scan in another order would give
// other last bits, and a photon whose target falls between the two
// versions would change channel.  The target u * total is one rounded
// float32 product, written __fmul_rn.  A float compare treats -0.0 and
// +0.0 as equal, as the twin's order keys (which map -0.0 to +0.0) do.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void channel_draw_kernel(const float* __restrict__ pattern, int C,
                                    const long long* __restrict__ edges,
                                    const float* __restrict__ u,
                                    int* __restrict__ ch) {
  extern __shared__ float cdf[];
  const int i = blockIdx.x;
  const long long lo = edges[i], hi = edges[i + 1];
  if (lo >= hi) return;   // the whole block leaves together
  if (threadIdx.x == 0) {
    const float* row = pattern + static_cast<long long>(i) * C;
    double acc = 0.0;
    for (int c = 0; c < C; ++c) {
      acc = __dadd_rn(acc, static_cast<double>(row[c]));
      cdf[c] = __double2float_rn(acc);
    }
  }
  __syncthreads();
  const float total = cdf[C - 1];
  for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    int out = -1;
    if (total > 0.0f) {
      const float target = __fmul_rn(u[j], total);
      int a = 0, b = C;
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (cdf[mid] <= target) a = mid + 1; else b = mid;
      }
      out = a < C - 1 ? a : C - 1;
    }
    ch[j] = out;
  }
}

}  // namespace

extern "C" int wfsim_channel_draw(const void* pattern, int n_inst, int C,
                                  const void* edges, const void* u, void* ch,
                                  void* stream) {
  const size_t smem = static_cast<size_t>(C) * sizeof(float);
  if (n_inst <= 0 || C <= 0 || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  channel_draw_kernel<<<n_inst, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pattern), C,
      static_cast<const long long*>(edges), static_cast<const float*>(u),
      static_cast<int*>(ch));
  return static_cast<int>(cudaGetLastError());
}
