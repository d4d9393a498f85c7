// pmt_response: the PMT response of a photon batch and its truth rows.
//
// Replaces: wfsim_tpu/models/pmt.py:19 pmt_response (TTS, double-PE, SPE
// gain, live mask), :89 _pulse_truth (the trigger test and the six sums
// plus their bottom-array twins), :146-154 the per-PMT scatter-adds and
// :171 photon_time_stats (count, min, max, mean offset, sigma), with
// ops/segment.py's sorted_segment_sum and segment_min_max as those use
// them.  Plain twins: models/pmt.py photon_pass_ref, pulse_truth_ref,
// pulse_truth_per_pmt_ref and photon_time_stats_ref.
//
// Three entry points:
//   wfsim_pmt_photon_pass  one thread per photon: t + trunc(tts*(spread/
//                          2.35482) + mean), is_dpe = u < p_dpe, the two
//                          SPE-gain indices (u*2000)->int + 1, gain = g1 +
//                          (dpe ? g2 : 0), valid = valid & live channel;
//   wfsim_pmt_row_truth    per truth row over its contiguous photons
//                          [row_edges[r], row_edges[r+1]): count, t_min and
//                          t_max (identities 2^31-1 and -(2^31-1) for a row
//                          without a valid photon), the mean offset from
//                          t_min and sigma and, with the photons' channels
//                          given, the trigger test and the twelve truth
//                          sums.  Without channels it gives the time
//                          statistics alone (an S2 batch's electron times);
//   wfsim_pmt_row_truth_per_pmt
//                          per-PMT truth: the six sums per (row, channel),
//                          four int32 counts (4, R, C) and two float64
//                          areas (2, R, C).
//
// What bounds them on the H100: the photon pass reads four draws and
// writes the photon (~36 bytes a photon); the two truth kernels read each
// photon once (t, valid, ch, gain, is_dpe: 14 bytes; ~22 MB at the bench
// S2 batch of 1.57 M photons, 6.6 us at 3.35 TB/s) and the per-PMT kernel
// writes 32 bytes a (row, channel), 8.1 MB at 512 rows of 494 channels.
// Both are memory-bound; the design has to keep every SM reading whatever
// the rows hold (14 photons an S1 row, ~176 electrons, ~3,076 photons an
// S2 row on the bench workload, 10^6 in one large S2).
//
// Exact integer sums, so the order does not matter.  Every sum is kept
// as an integer that is exact in any order: the counts; the areas in
// fixed point (below); and the time moments as sum(t) and sum(t^2) modulo
// 2^64 (int32 times, so t^2 < 2^62).  At the end a row's min-centred
// moments follow exactly, modulo 2^64:
//   S1 = sum(t) - n*m,  S2 = sum(t^2) - 2*m*sum(t) + n*m^2   (m = t_min),
// which is their true value wherever n * (t_max - t_min)^2 < 2^62 (every
// partial and final value of the min-centred sums then lies in [0, 2^62)).
// Partial sums of any split of a row therefore combine by integer adds or
// integer atomics, and the result has the same bits run to run.  Each
// sum is converted once to float64 (correctly rounded): the twins' float64
// cumsum differences give the same bits wherever their own sums are exact
// (every partial sum below 2^53, as on the bench workload), and agree
// within float64 rounding (rtol 1e-12) elsewhere.
//
// Areas in fixed point.  A raw-area term is a float32 x = gain / g (the
// SPE table's range puts it in [0.068, 6] on the synthetic tables).  As
// an int64 multiple of 2^-S, S = models/pmt.py's AREA_SCALE (32), handed
// to both entry points (TruthIn's area_* fields follow from it), x is
// exact whenever |x| >= 2^(23-S) = 2^-9 (its last bit is then at least
// 2^-S), and the row's sums stay exact while count * max|x| <= 2^(62-S) =
// 2^30 (|sum| * 2^S <= 2^62).  Each row keeps the
// smallest nonzero and the largest |x| (their float32 bits: ordered as
// unsigned integers) beside its count; a row outside that range takes the
// second pass below.  Where the twin's float64 sum of the same terms is
// exact (every partial sum a multiple of its smallest term's last bit and
// below 2^53 of it: terms spanning less than 2^29 in magnitude on a batch
// the size of the bench one), the fixed-point sum converted to float64 is
// that sum, bit for bit.
//
// The second pass.  A row whose moments fail n * span^2 < 2^62, or whose
// areas fail the fixed-point range, is summed once more inside the kernel
// in float64, in a fixed order (the row kernel: a warp, lanes strided over
// the row, then a fixed butterfly; the per-PMT kernel: a thread a channel
// over the row's photons in photon order, the twin's own order), so it
// too gives the same bits run to run and agrees with the twin within
// rtol 1e-12; its centred times are int32 differences, as the twin's.  Each
// such row adds one to a device counter, second[3] = {row moments, row
// areas, per-PMT areas}, that models/pmt.py's pmt_truth_second_pass hands
// out and no wrapper reads.  No row of the bench workload takes it.
//
// wfsim_pmt_row_truth: work cut by elements, not rows.  Each row's first
// chunk of elements is one piece, and each tile of a chunk of the batch
// another for the elements of rows longer than a chunk (a tile meets at
// most two such rows, those holding its first and its last element, found
// by two 32-ary searches of the row edges side by side, tiles.cuh's
// warp_counts: one ballot each a step).  One function finds a piece's rows (find_piece) for both layouts
// below and the per-PMT kernel; in a block every warp finds the same piece
// itself, so no shared-memory round is needed for it.  The wrapper picks the layout from the batch's size and mean row
// length, with no read-back: rows of a mean below 512 (S1 photons, S2
// electrons) take a warp a piece, the chunk the smallest power of two from
// 32 to 1,024 no shorter than twice the mean row and giving at most 2,048
// tiles; longer rows (S2 photons) a block of 256 a piece, the chunk 8,192.
// A warp's lanes load the fields of 4 photons (8 without channels) before
// using any; a block's threads load 4 consecutive photons each as 16-byte
// words (t, ch, gain; 4 bytes of valid and is_dpe), where aligned.  The
// sums stay in registers (four packed 16-bit counts in one 64-bit word)
// and their updates carry no branch, so the loads of the next batch fly
// while one is summed; one butterfly of shuffles reduces all of them (a
// block: then one shared-memory round and warp 0's butterfly over the
// warps).  A row in one piece is written by its warp (block).  A longer
// row's pieces add their sums to the row's 17-word accumulator with
// integer atomics, a word a lane in one coalesced request (the minimum and
// maximum as order-preserving unsigned keys), release them with an
// acquire-release fence and take a ticket; the piece whose ticket
// completes the row reads the accumulator back with atomicExch (leaving it
// zero for the next call) and writes the row.  The accumulators live in a
// zeroed scratch buffer the wrapper keeps per device and stream (launches
// on one stream run in order; two overlapping launches on one buffer would
// mix their sums); every launch that completes leaves it zero.  With channels, chan_pack's gain, threshold and bottom columns
// are copied to shared memory (cp.async) while the rows are found.  The
// launch reads nothing back to the host and never reads an element at or
// past n.
//
// wfsim_pmt_row_truth_per_pmt: the same pieces with a chunk of 8,192, a
// block each.  A block loads 4 consecutive photons a thread as 16-byte
// words and accumulates them into a shared-memory table of C channels (two
// 32-bit words of packed 16-bit counts and two 64-bit fixed-point areas:
// 24 bytes a channel) by native 32-bit shared atomics (a 64-bit add as two
// with the carry: a 64-bit shared atomic add is a compare-and-swap loop on
// sm_90), so channels hit by many photons serialise only on native integer
// adds.  A row that fits its chunk is written from the table, once and
// coalesced: 4 count planes and 2 area planes, 32 bytes a channel.  A
// longer row's blocks add their tables to a scratch table indexed by the
// row's first chunk (distinct for every long row) with integer atomics and
// take a ticket; the last writes the row and zeroes the scratch table.
// Counts are exact, the areas are exact in the fixed-point range, so the
// outputs have the same bits run to run (float64 atomics would not: their
// order varies).
//
// Numerics.  nvcc contracts a*b+c into an FMA by default; every product
// and sum the twin rounds separately is written with the _rn intrinsics:
// tts*scale + mean, gain_ch*ut then g1 + g2, gain*cm*current_2_adc,
// s2/cnt - mean*mean (double).  float -> int casts truncate toward zero (a
// TTS offset can be negative).  t mod dt (floor, as torch.remainder) comes
// from an exact double floor of t / dt and one correction.  (u*2000) as an
// integer is at most 1999 for
// every float32 u < 1, so index + 1 stays inside uniform_to_pe's 2001
// columns.  wfsim_tpu's float32 sums depend on their order: against it
// counts are equal and areas agree within rtol 1e-5.
#include <cuda_runtime.h>

#include <cmath>

#include "tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBig = 0x7fffffff;   // 2^31 - 1
constexpr unsigned kFull = 0xffffffffu;

constexpr unsigned long long kMomentLimit = 1ull << 62;

// the second-pass counters
constexpr int kMomentRows = 0, kAreaRows = 1, kPerPmtRows = 2;
// a row accumulator of the row kernel: 8 counts, 4 areas, sum t, sum t^2,
// the (min, max) keys, the (~smallest, largest) |area| bits, the ticket
constexpr int kAccWords = 17;

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

// what both truth kernels read: the row edges, the photons and the
// per-channel constants
struct TruthIn {
  const long long* edges;   // (n_rows + 1,) ascending
  int n_rows;
  long long n;              // photons; edges are clamped to n
  const int* t;
  const unsigned char* valid;   // nullptr: every photon valid
  const int* ch;                // nullptr: time statistics only
  const float* gain;
  const unsigned char* is_dpe;
  const float* chan_pack;       // (C, 4): gain, threshold, live, bottom
  int C;
  const float* current_max;
  int dt;
  double inv_dt;                // 1 / dt
  float current_2_adc;
  // areas: int64 multiples of 2^-S, S = models/pmt.py's AREA_SCALE
  float area_unit;              // 2^S
  double area_inv;              // 2^-S
  unsigned area_min_bits;       // float32 bits of 2^(23 - S)
  double area_max_sum;          // 2^(62 - S)
  int* second;                  // (3,) second-pass counters
};

// the dynamic shared memory of either kernel; the row kernel keeps the
// gain, threshold and bottom columns of chan_pack at its start
extern __shared__ __align__(16) unsigned char g_dyn_sh[];

__device__ __forceinline__ long long edge(const TruthIn& in, long long r) {
  const long long e = __ldg(in.edges + r);
  return e < in.n ? e : in.n;
}

// The pieces of a batch cut into chunks of elements: piece p < n_rows is
// row p's first chunk, piece n_rows + k is tile k (elements [k chunk,
// (k + 1) chunk)) past the first chunks of the rows it meets, at most two:
// those holding its first and its last element.  A piece sums rows
// row[i] >= 0, each [lo, hi), over its elements [pa, pb).
struct Piece {
  int row[2];
  long long lo[2], hi[2], pa[2], pb[2];
};

// the pieces over which row [lo, hi) is summed
__device__ __forceinline__ long long pieces_of(long long lo, long long hi,
                                               long long chunk) {
  return hi - lo > chunk ? 1 + (hi - 1) / chunk - (lo + chunk) / chunk + 1
                         : 1;
}

// piece p, found by a whole warp (the same in every lane; a row's first
// chunk, p < n_rows, by any thread: no search); a row's first chunk is a
// piece even when empty (it writes the row), a tile's row only where the
// tile holds some of its elements
__device__ Piece find_piece(const TruthIn& in, long long p, long long chunk) {
  Piece q;
  q.row[1] = -1;
  q.lo[1] = q.hi[1] = q.pa[1] = q.pb[1] = 0;
  if (p < in.n_rows) {
    q.row[0] = static_cast<int>(p);
    q.lo[0] = q.pa[0] = edge(in, p);
    q.hi[0] = edge(in, p + 1);
    q.pb[0] = q.hi[0] - q.lo[0] > chunk ? q.lo[0] + chunk : q.hi[0];
    return q;
  }
  const int lane = threadIdx.x & 31;
  const long long c0 = (p - in.n_rows) * chunk;
  const long long c1 = c0 + chunk < in.n ? c0 + chunk : in.n;
  // the last rows starting at or before the tile's first and last elements
  // (the first row whose edge is at least x is the count of those below it)
  long long n0, n1;
  tiles::warp_counts(in.edges, in.n_rows - 1, in.n, c0, c1 - 1, n0, n1);
  const int r0 = static_cast<int>(n0), r1 = static_cast<int>(n1);
  q.row[0] = r0 - 1;
  q.row[1] = r1 == r0 ? -1 : r1 - 1;
  const int rr = lane < 2 ? q.row[0] : q.row[1];
  const long long e = edge(in, lane < 4 && rr >= 0 ? rr + (lane & 1) : 0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    q.lo[i] = __shfl_sync(kFull, e, 2 * i);
    q.hi[i] = __shfl_sync(kFull, e, 2 * i + 1);
    q.pa[i] = q.lo[i] + chunk > c0 ? q.lo[i] + chunk : c0;
    q.pb[i] = q.hi[i] < c1 ? q.hi[i] : c1;
    if (q.pb[i] <= q.pa[i]) q.row[i] = -1;
  }
  return q;
}

// the truth terms of valid photon j: its clamped channel, the trigger test
// (peak amplitude in ADC above the channel threshold), the DPE flag, the
// raw area gain / g and the bottom-array flag
struct PhotonTruth {
  int ch;
  bool above, dpe, bottom;
  float g_over;
};

// from photon j's loaded fields; kShared: the channel columns from the
// row kernel's shared memory, else one 16-byte load from chan_pack
template <bool kShared>
__device__ __forceinline__ PhotonTruth truth_of(const TruthIn& in, int t,
                                                int c, float g,
                                                bool dpe) {
  const int cc = c < 0 ? 0 : (c > in.C - 1 ? in.C - 1 : c);
  // floor-mod, as torch.remainder: the double product is within 2^-21 of
  // t / dt for every int32 t, so its floor q is off by at most one, and
  // t - q dt (small) is exact in 32-bit wrapping arithmetic
  const int q = __double2int_rd(__dmul_rn(static_cast<double>(t), in.inv_dt));
  int rem = static_cast<int>(static_cast<unsigned>(t) -
                             static_cast<unsigned>(q) *
                                 static_cast<unsigned>(in.dt));
  if (rem < 0) rem += in.dt;
  else if (rem >= in.dt) rem -= in.dt;
  const float amp = __fmul_rn(__fmul_rn(g, __ldg(in.current_max + rem)),
                              in.current_2_adc);
  float gc, thr;
  bool bottom;
  if (kShared) {
    const float* tab = reinterpret_cast<const float*>(g_dyn_sh) + 3 * cc;
    gc = tab[0];
    thr = tab[1];
    bottom = tab[2] > 0.0f;
  } else {
    const float4 cp = __ldg(reinterpret_cast<const float4*>(in.chan_pack) +
                            cc);
    gc = cp.x;
    thr = cp.y;
    bottom = cp.w > 0.0f;
  }
  PhotonTruth p;
  p.ch = cc;
  p.above = amp > thr;
  p.dpe = dpe;
  p.bottom = bottom;
  p.g_over = __fdiv_rn(g, gc > 1e-30f ? gc : 1e-30f);
  return p;
}

template <bool kShared>
__device__ __forceinline__ PhotonTruth photon_truth(const TruthIn& in,
                                                    long long j) {
  return truth_of<kShared>(in, in.t[j], in.ch[j], in.gain[j],
                           in.is_dpe[j] != 0);
}

// a batch of U photons j0 + s*u (u < U) below b, every field loaded before
// any is used (the loads of a batch are in flight together); valid false
// past b
template <bool kTruth, int U>
struct Batch {
  int t[U], ch[U];
  float gain[U];
  bool valid[U], dpe[U];

  __device__ __forceinline__ void load(const TruthIn& in, long long j0,
                                       long long s, long long b) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = j0 + s * u;
      const bool inr = j < b;
      valid[u] = inr && (in.valid == nullptr || __ldg(in.valid + j) != 0);
      t[u] = inr ? __ldg(in.t + j) : 0;
      if (kTruth) {
        ch[u] = inr ? __ldg(in.ch + j) : 0;
        gain[u] = inr ? __ldg(in.gain + j) : 0.0f;
        dpe[u] = inr && __ldg(in.is_dpe + j) != 0;
      }
    }
  }
};

// a 4-byte asynchronous copy from global to shared memory, of its first
// `bytes` (the rest zero)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

// with channels (kTruth): the gain, threshold and bottom columns of
// chan_pack copied to the start of shared memory, landing while the rows
// are found; wait_channels before their first use
template <bool kTruth>
__device__ __forceinline__ void stage_channels(const TruthIn& in) {
  if (!kTruth) return;
  float* chan = reinterpret_cast<float*>(g_dyn_sh);
  for (int i = threadIdx.x; i < in.C; i += kThreads) {
    cp_async4(chan + 3 * i, in.chan_pack + 4 * i, 4);
    cp_async4(chan + 3 * i + 1, in.chan_pack + 4 * i + 1, 4);
    cp_async4(chan + 3 * i + 2, in.chan_pack + 4 * i + 3, 4);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool kTruth>
__device__ __forceinline__ void wait_channels() {
  if (!kTruth) return;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// photons [a, b) over the block: four consecutive photons a thread at a
// time where they are 16-byte aligned (16-byte loads of t, ch and gain,
// 4-byte loads of valid and is_dpe: few, wide requests keep enough bytes
// in flight), one at a time at the two ends; f(valid, t, ch, gain, dpe)
// for each (fields meaningless where valid is false)
template <bool kTruth, int kDepth, class F>
__device__ __forceinline__ void block_photons(const TruthIn& in, long long a,
                                              long long b, F f) {
  const long long a4 = (a + 3) & ~3ll, b4 = b & ~3ll;
  auto one = [&](long long j) {
    f(in.valid == nullptr || in.valid[j] != 0, in.t[j],
      kTruth ? in.ch[j] : 0, kTruth ? in.gain[j] : 0.0f,
      kTruth && in.is_dpe[j] != 0);
  };
  if (a4 >= b4) {
    for (long long j = a + threadIdx.x; j < b; j += kThreads) one(j);
    return;
  }
  if (a + threadIdx.x < a4) one(a + threadIdx.x);
  if (b4 + threadIdx.x < b) one(b4 + threadIdx.x);
  auto four = [&](long long q) {
    const int4 t4 = __ldg(reinterpret_cast<const int4*>(in.t) + q);
    int4 c4 = make_int4(0, 0, 0, 0);
    float4 g4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    unsigned d4 = 0;
    if (kTruth) {
      c4 = __ldg(reinterpret_cast<const int4*>(in.ch) + q);
      g4 = __ldg(reinterpret_cast<const float4*>(in.gain) + q);
      d4 = __ldg(reinterpret_cast<const unsigned*>(in.is_dpe) + q);
    }
    const unsigned v4 =
        in.valid == nullptr
            ? 0x01010101u
            : __ldg(reinterpret_cast<const unsigned*>(in.valid) + q);
    f((v4 & 0xffu) != 0, t4.x, c4.x, g4.x, (d4 & 0xffu) != 0);
    f((v4 & 0xff00u) != 0, t4.y, c4.y, g4.y, (d4 & 0xff00u) != 0);
    f((v4 & 0xff0000u) != 0, t4.z, c4.z, g4.z, (d4 & 0xff0000u) != 0);
    f((v4 >> 24) != 0, t4.w, c4.w, g4.w, (d4 >> 24) != 0);
  };
  // kDepth 2: two groups' loads in flight a thread (the per-PMT kernel);
  // 1 leaves the registers to the row kernel's sums
  const long long q1 = b4 >> 2;
  if (kDepth == 2) {
#pragma unroll 2
    for (long long q = (a4 >> 2) + threadIdx.x; q < q1; q += kThreads) four(q);
  } else {
#pragma unroll 1
    for (long long q = (a4 >> 2) + threadIdx.x; q < q1; q += kThreads) four(q);
  }
}

__device__ __forceinline__ unsigned long long area_fixed(const TruthIn& in,
                                                        float x) {
  return static_cast<unsigned long long>(
      __float2ll_rn(__fmul_rn(x, in.area_unit)));
}

__device__ __forceinline__ double area_double(const TruthIn& in,
                                              unsigned long long a) {
  return __dmul_rn(__ll2double_rn(static_cast<long long>(a)), in.area_inv);
}

__device__ __forceinline__ unsigned mag_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

// whether cnt area terms, the smallest nonzero |x| and the largest of bits
// xlo and xhi (xhi 0: every term 0), sum exactly in the fixed point
__device__ __forceinline__ bool areas_fixed_ok(const TruthIn& in,
                                               unsigned long long cnt,
                                               unsigned xlo, unsigned xhi) {
  return xhi == 0 ||
         (xlo >= in.area_min_bits &&
          __dmul_rn(static_cast<double>(cnt),
                    static_cast<double>(__uint_as_float(xhi))) <=
              in.area_max_sum);
}

// whether the min-centred moments of cnt times in [mn, mx] lie in [0, 2^62)
__device__ __forceinline__ bool moments_ok(unsigned long long cnt, int mn,
                                           int mx) {
  if (cnt == 0) return true;
  const unsigned long long span =
      static_cast<unsigned long long>(static_cast<long long>(mx) - mn);
  const unsigned long long sq = span * span;      // span < 2^32
  return __umul64hi(cnt, sq) == 0 && cnt * sq < kMomentLimit;
}

// ---------------------------------------------------------------------------
// the row kernel

// one lane's (then the warp's) sums over a row's photons: four packed
// 16-bit counts (valid photons, PE, triggered photons, triggered PE) for
// all channels and for the bottom array, the four fixed-point areas, sum t
// and sum t^2 modulo 2^64, min and max, the smallest nonzero and the
// largest |area| bits
struct RowPart {
  unsigned long long cnt4, bot4, area[4], s1, s2;
  int mn, mx;
  unsigned xlo, xhi;
};

__device__ __forceinline__ void part_init(RowPart& p) {
  p.cnt4 = p.bot4 = p.s1 = p.s2 = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) p.area[k] = 0;
  p.mn = kBig;
  p.mx = -kBig;
  p.xlo = kFull;
  p.xhi = 0;
}

// photon (t, c, g, dpe) added where v (its fields are loaded, possibly
// meaningless, where not: every update is masked, so no branch)
template <bool kTruth>
__device__ __forceinline__ void part_add(RowPart& p, const TruthIn& in,
                                         bool v, int tj, int c, float g,
                                         bool dpe) {
  const long long tl = v ? tj : 0;
  p.s1 += static_cast<unsigned long long>(tl);
  p.s2 += static_cast<unsigned long long>(tl * tl);
  p.mn = min(p.mn, v ? tj : kBig);
  p.mx = max(p.mx, v ? tj : -kBig);
  if (!kTruth) {
    p.cnt4 += v ? 1 : 0;
    return;
  }
  const PhotonTruth q = truth_of<true>(in, tj, c, g, dpe);
  const unsigned long long pe = q.dpe ? 2 : 1;
  const unsigned long long w =
      v ? (1ull | (pe << 16) | (q.above ? ((1ull << 32) | (pe << 48)) : 0ull))
        : 0ull;
  const unsigned long long x = v ? area_fixed(in, q.g_over) : 0ull;
  const unsigned long long xa = q.above ? x : 0ull;
  p.cnt4 += w;
  p.area[0] += x;
  p.area[1] += xa;
  p.bot4 += q.bottom ? w : 0ull;
  p.area[2] += q.bottom ? x : 0ull;
  p.area[3] += q.bottom ? xa : 0ull;
  const unsigned m = v ? mag_bits(q.g_over) : 0u;
  p.xlo = min(p.xlo, m != 0 ? m : kFull);
  p.xhi = max(p.xhi, m);
}

// a lane's sums over photons [a, b) strided by the warp, in batches of U
// whose loads are all issued before any is used (and, the batch's sums
// being free of branches, while the previous batch is summed)
template <bool kTruth>
__device__ __forceinline__ void part_range(RowPart& p, const TruthIn& in,
                                           long long a, long long b) {
  constexpr int U = kTruth ? 4 : 8;
#pragma unroll 2
  for (long long j = a + (threadIdx.x & 31); j < b; j += 32 * U) {
    Batch<kTruth, U> x;
    x.load(in, j, 32, b);
#pragma unroll
    for (int u = 0; u < U; ++u)
      part_add<kTruth>(p, in, x.valid[u], x.t[u], x.ch[u], x.gain[u],
                       x.dpe[u]);
  }
}

template <bool kTruth>
__device__ __forceinline__ void part_reduce(RowPart& p) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    p.cnt4 += __shfl_xor_sync(kFull, p.cnt4, o);
    p.s1 += __shfl_xor_sync(kFull, p.s1, o);
    p.s2 += __shfl_xor_sync(kFull, p.s2, o);
    p.mn = min(p.mn, __shfl_xor_sync(kFull, p.mn, o));
    p.mx = max(p.mx, __shfl_xor_sync(kFull, p.mx, o));
    if (kTruth) {
      p.bot4 += __shfl_xor_sync(kFull, p.bot4, o);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        p.area[k] += __shfl_xor_sync(kFull, p.area[k], o);
      p.xlo = min(p.xlo, __shfl_xor_sync(kFull, p.xlo, o));
      p.xhi = max(p.xhi, __shfl_xor_sync(kFull, p.xhi, o));
    }
  }
}

// a row's totals: counts c[0..3] of all channels, c[4..7] of the bottom
// array (c[0] is the valid count)
struct RowTotal {
  unsigned long long c[8], area[4], s1, s2;
  int mn, mx;
  unsigned xlo, xhi;
};

__device__ __forceinline__ RowTotal totals_of(const RowPart& p) {
  RowTotal s;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s.c[k] = (p.cnt4 >> (16 * k)) & 0xffff;
    s.c[4 + k] = (p.bot4 >> (16 * k)) & 0xffff;
    s.area[k] = p.area[k];
  }
  s.s1 = p.s1;
  s.s2 = p.s2;
  s.mn = p.mn;
  s.mx = p.mx;
  s.xlo = p.xlo;
  s.xhi = p.xhi;
  return s;
}

// add a warp's piece of row totals s (uniform across the warp) to the
// row's accumulator w and take a ticket; true in the warp that completes
// the row's `pieces`, whose s then holds the row's totals (and w is zero
// again).  Lane k adds word k, so a piece's adds and the last piece's
// reads are one coalesced request each (a row split over many chunks
// contends on its accumulator's line).
__device__ bool combine_row(unsigned long long* w, RowTotal& s,
                            long long pieces) {
  const int lane = threadIdx.x & 31;
  unsigned* w32 = reinterpret_cast<unsigned*>(w);
  unsigned long long v = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (lane == k) v = s.c[k];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (lane == 8 + k) v = s.area[k];
  if (lane == 12) v = s.s1;
  if (lane == 13) v = s.s2;
  if (lane < 14 && v != 0) atomicAdd(w + lane, v);
  // keys whose unsigned maximum is the minimum time, the maximum time, the
  // smallest and the largest |area|; 0 is each one's identity
  unsigned key = 0;
  if (lane == 14)
    key = static_cast<unsigned>(kBig - static_cast<long long>(s.mn));
  if (lane == 15) key = static_cast<unsigned>(s.mx) ^ 0x80000000u;
  if (lane == 16) key = ~s.xlo;
  if (lane == 17) key = s.xhi;
  if (lane >= 14 && lane < 18 && key != 0)
    atomicMax(w32 + 28 + (lane - 14), key);
  tiles::fence_acq_rel();
  __syncwarp();
  unsigned ticket = 0;
  if (lane == 0) ticket = tiles::ticket_add(w32 + 32);
  ticket = __shfl_sync(kFull, ticket, 0);
  if (ticket + 1 != pieces) return false;
  tiles::fence_acq_rel();
  unsigned long long got = 0;
  if (lane <= 16) got = atomicExch(w + lane, 0ull);
#pragma unroll
  for (int k = 0; k < 8; ++k) s.c[k] = __shfl_sync(kFull, got, k);
#pragma unroll
  for (int k = 0; k < 4; ++k) s.area[k] = __shfl_sync(kFull, got, 8 + k);
  s.s1 = __shfl_sync(kFull, got, 12);
  s.s2 = __shfl_sync(kFull, got, 13);
  const unsigned long long mm = __shfl_sync(kFull, got, 14);
  const unsigned long long xx = __shfl_sync(kFull, got, 15);
  s.mn = static_cast<int>(kBig - static_cast<long long>(
                                     static_cast<unsigned>(mm)));
  s.mx = static_cast<int>(static_cast<unsigned>(mm >> 32) ^ 0x80000000u);
  s.xlo = ~static_cast<unsigned>(xx);
  s.xhi = static_cast<unsigned>(xx >> 32);
  return true;
}

struct RowOut {
  double* sums;             // (12, n_rows) or nullptr
  long long* count;
  int* t_min;
  int* t_max;
  double* mean_offset;
  double* sigma;
};

// the float64 second pass of row [lo, hi) by one warp in a fixed order:
// the min-centred moments (as int32 differences, as the twin) and/or the
// four areas; results valid in every lane
template <bool kTruth>
__device__ void row_second_pass(const TruthIn& in, long long lo, long long hi,
                                int base, bool moments, bool areas,
                                double& d1, double& d2, double ar[4]) {
  const int lane = threadIdx.x & 31;
  double a1 = 0.0, a2 = 0.0, x[4] = {0.0, 0.0, 0.0, 0.0};
  for (long long j = lo + lane; j < hi; j += 32) {
    if (in.valid != nullptr && !in.valid[j]) continue;
    if (moments) {
      const double c = static_cast<double>(static_cast<int>(
          static_cast<unsigned>(in.t[j]) - static_cast<unsigned>(base)));
      a1 = __dadd_rn(a1, c);
      a2 = __dadd_rn(a2, __dmul_rn(c, c));
    }
    if (kTruth && areas) {
      const PhotonTruth q = photon_truth<true>(in, j);
      const double g = static_cast<double>(q.g_over);
      x[0] = __dadd_rn(x[0], g);
      if (q.above) x[1] = __dadd_rn(x[1], g);
      if (q.bottom) {
        x[2] = __dadd_rn(x[2], g);
        if (q.above) x[3] = __dadd_rn(x[3], g);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a1 = __dadd_rn(a1, __shfl_xor_sync(kFull, a1, o));
    a2 = __dadd_rn(a2, __shfl_xor_sync(kFull, a2, o));
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[k] = __dadd_rn(x[k], __shfl_xor_sync(kFull, x[k], o));
  }
  // lane 0's sums, in the fixed order of its butterfly
  if (moments) {
    d1 = __shfl_sync(kFull, a1, 0);
    d2 = __shfl_sync(kFull, a2, 0);
  }
  if (kTruth && areas) {
#pragma unroll
    for (int k = 0; k < 4; ++k) ar[k] = __shfl_sync(kFull, x[k], 0);
  }
}

// write row r from its totals (uniform across the warp)
template <bool kTruth>
__device__ void finish_row(const TruthIn& in, const RowOut& out, int r,
                           const RowTotal& s, long long lo, long long hi) {
  const int lane = threadIdx.x & 31;
  const unsigned long long cnt = s.c[0];
  const int mn = cnt ? s.mn : kBig, mx = cnt ? s.mx : -kBig;
  const bool ok_m = moments_ok(cnt, mn, mx);
  const bool ok_a = !kTruth || areas_fixed_ok(in, cnt, s.xlo, s.xhi);
  double d1 = 0.0, d2 = 0.0, ar[4];
  if (cnt != 0) {
    const unsigned long long m = static_cast<unsigned long long>(
        static_cast<long long>(mn));
    d1 = __ull2double_rn(s.s1 - cnt * m);
    d2 = __ull2double_rn(s.s2 - 2ull * m * s.s1 + cnt * (m * m));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) ar[k] = area_double(in, s.area[k]);
  if (!ok_m || !ok_a) {
    row_second_pass<kTruth>(in, lo, hi, mn, !ok_m, !ok_a, d1, d2, ar);
    if (lane == 0) {
      if (!ok_m) atomicAdd(in.second + kMomentRows, 1);
      if (!ok_a) atomicAdd(in.second + kAreaRows, 1);
    }
  }
  if (kTruth && lane < 12) {
    // the output order: photons, PE, triggered photons, triggered PE, raw
    // area, triggered raw area; then the same on the bottom array
    double v = 0.0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (lane == 6 * h + k) v = static_cast<double>(s.c[4 * h + k]);
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (lane == 6 * h + 4 + k) v = ar[2 * h + k];
    }
    out.sums[static_cast<long long>(lane) * in.n_rows + r] = v;
  }
  if (lane == 12) out.count[r] = static_cast<long long>(cnt);
  if (lane == 13) out.t_min[r] = mn;
  if (lane == 14) out.t_max[r] = mx;
  if (lane == 15 || lane == 16) {
    const double cntf = cnt > 1 ? static_cast<double>(cnt) : 1.0;
    const double m = __ddiv_rn(d1, cntf);
    if (lane == 15) {
      out.mean_offset[r] = m;
    } else {
      double var = __dsub_rn(__ddiv_rn(d2, cntf), __dmul_rn(m, m));
      out.sigma[r] = __dsqrt_rn(var > 0.0 ? var : 0.0);
    }
  }
}

// the photons [pa, pb) of row r = [lo, hi), by the warp or (kBlock) the
// block: each thread's sums, the warp's butterfly and, for a block, one
// shared-memory round and warp 0's butterfly over the eight warp sums;
// then the row written by that warp, alone or as the last of its pieces
template <bool kTruth, bool kBlock>
__device__ void row_piece(const TruthIn& in, const RowOut& out, int r,
                          long long lo, long long hi, long long pa,
                          long long pb, long long chunk,
                          unsigned long long* acc) {
  RowPart p;
  part_init(p);
  if constexpr (kBlock) {
    __shared__ RowPart sh_part[kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    block_photons<kTruth, 1>(in, pa, pb,
                             [&](bool v, int t, int c, float g, bool dpe) {
                               part_add<kTruth>(p, in, v, t, c, g, dpe);
                             });
    part_reduce<kTruth>(p);
    __syncthreads();               // a previous piece is done with sh_part
    if (lane == 0) sh_part[warp] = p;
    __syncthreads();
    if (warp != 0) return;
    part_init(p);
    if (lane < kWarps) p = sh_part[lane];
    part_reduce<kTruth>(p);
  } else if (pb > pa) {
    part_range<kTruth>(p, in, pa, pb);
    part_reduce<kTruth>(p);
  }
  RowTotal s = totals_of(p);
  if (hi - lo > chunk &&
      !combine_row(acc + static_cast<long long>(r) * kAccWords, s,
                   pieces_of(lo, hi, chunk)))
    return;
  finish_row<kTruth>(in, out, r, s, lo, hi);
}

// piece p (find_piece) of the n_pieces a warp, or a block (kBlock: batches
// of long rows, all of a block's threads summing its photons).  Shared
// memory, with channels: the gain, threshold and bottom columns of
// chan_pack (3 C floats).
template <bool kTruth, bool kBlock>
__global__ void __launch_bounds__(kThreads, kBlock ? 4 : 3)
    pmt_row_truth_kernel(TruthIn in, RowOut out, long long chunk,
                         long long n_pieces,
                         unsigned long long* __restrict__ acc) {
  stage_channels<kTruth>(in);
  const long long p =
      kBlock ? blockIdx.x
             : static_cast<long long>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
  const Piece q = find_piece(in, p < n_pieces ? p : 0, chunk);
  wait_channels<kTruth>();
  if (p >= n_pieces) return;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (q.row[i] >= 0)
      row_piece<kTruth, kBlock>(in, out, q.row[i], q.lo[i], q.hi[i], q.pa[i],
                                q.pb[i], chunk, acc);
}

// ---------------------------------------------------------------------------
// the per-PMT kernel

struct PmtOut {
  int* counts;               // (4, n_rows, C)
  double* areas;             // (2, n_rows, C)
  unsigned long long* scratch;
  int chunk;
};

// the per-PMT scratch table of the long row whose first chunk is q: counts
// (4, C) u32, areas (2, C) u64, then [count, ~smallest |x|, largest |x|,
// ticket] u32
__device__ __forceinline__ unsigned long long* pmt_scratch(
    const PmtOut& out, int C, long long q) {
  return out.scratch + q * (4ll * C + 2);
}

// a 64-bit shared-memory add from native 32-bit atomics (a 64-bit shared
// atomic add is a compare-and-swap loop on sm_90): the low word's carry
// goes to the high word, so the total is the same in any order
__device__ __forceinline__ void shared_add64(unsigned long long* p,
                                             unsigned long long x) {
  unsigned* w = reinterpret_cast<unsigned*>(p);
  const unsigned lo = static_cast<unsigned>(x);
  const unsigned old = atomicAdd(w, lo);
  const unsigned hi =
      static_cast<unsigned>(x >> 32) + (old + lo < old ? 1u : 0u);
  if (hi != 0) atomicAdd(w + 1, hi);
}

// the row's areas in float64, a thread a channel over the row's photons in
// photon order (the twin's order), into sh_d (2, C); then written
__device__ void per_pmt_exact_areas(const TruthIn& in, const PmtOut& out,
                                    int r, long long lo, long long hi,
                                    double* sh_d) {
  __shared__ int st_ch[kThreads];
  __shared__ float st_x[kThreads];
  __shared__ unsigned char st_above[kThreads];
  const int C = in.C;
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C; i += kThreads) sh_d[i] = 0.0;
  for (long long b = lo; b < hi; b += kThreads) {
    const long long j = b + threadIdx.x;
    int cc = -1;
    float x = 0.0f;
    bool above = false;
    if (j < hi && in.valid[j]) {
      const PhotonTruth q = photon_truth<false>(in, j);
      cc = q.ch;
      x = q.g_over;
      above = q.above;
    }
    __syncthreads();
    st_ch[threadIdx.x] = cc;
    st_x[threadIdx.x] = x;
    st_above[threadIdx.x] = above;
    __syncthreads();
    const int m = hi - b < kThreads ? static_cast<int>(hi - b) : kThreads;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      double s0 = sh_d[c], s1 = sh_d[C + c];
      for (int i = 0; i < m; ++i) {
        if (st_ch[i] != c) continue;
        const double g = static_cast<double>(st_x[i]);
        s0 = __dadd_rn(s0, g);
        if (st_above[i]) s1 = __dadd_rn(s1, g);
      }
      sh_d[c] = s0;
      sh_d[C + c] = s1;
    }
  }
  __syncthreads();
  const long long plane = static_cast<long long>(in.n_rows) * C;
  const long long base = static_cast<long long>(r) * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    out.areas[base + c] = sh_d[c];
    out.areas[plane + base + c] = sh_d[C + c];
  }
  if (threadIdx.x == 0) atomicAdd(in.second + kPerPmtRows, 1);
}

// the block's photons [pa, pb) of row r = [lo, hi) into the shared table,
// then the row written (alone, or by the last of its blocks)
__device__ void per_pmt_piece(const TruthIn& in, const PmtOut& out, int r,
                              long long lo, long long hi, long long pa,
                              long long pb, unsigned long long* sh_area) {
  __shared__ unsigned sh_red[3][kWarps];
  __shared__ unsigned sh_g[3];
  __shared__ int sh_last;
  const int C = in.C;
  unsigned* sh_cnt = reinterpret_cast<unsigned*>(sh_area + 2 * C);
  __syncthreads();           // the previous piece is done with the tables
  for (int i = threadIdx.x; i < 2 * C; i += kThreads) {
    sh_area[i] = 0;
    sh_cnt[i] = 0;
  }
  __syncthreads();
  unsigned cnt = 0, xlo = kFull, xhi = 0;
  block_photons<true, 2>(in, pa, pb,
                      [&](bool v, int t, int c, float g, bool dpe) {
    if (!v) return;
    const PhotonTruth q = truth_of<false>(in, t, c, g, dpe);
    const unsigned w = 1u | ((q.dpe ? 2u : 1u) << 16);
    const unsigned long long x = area_fixed(in, q.g_over);
    atomicAdd(sh_cnt + q.ch, w);
    shared_add64(sh_area + q.ch, x);
    if (q.above) {
      atomicAdd(sh_cnt + C + q.ch, w);
      shared_add64(sh_area + C + q.ch, x);
    }
    ++cnt;
    const unsigned mb = mag_bits(q.g_over);
    if (mb != 0) {
      xlo = min(xlo, mb);
      xhi = max(xhi, mb);
    }
  });
  // the block's count and |area| range: shuffles, one shared round, then
  // every thread over the warps in a fixed order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_xor_sync(kFull, cnt, o);
    xlo = min(xlo, __shfl_xor_sync(kFull, xlo, o));
    xhi = max(xhi, __shfl_xor_sync(kFull, xhi, o));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh_red[0][warp] = cnt;
    sh_red[1][warp] = xlo;
    sh_red[2][warp] = xhi;
  }
  __syncthreads();
  cnt = 0;
  xlo = kFull;
  xhi = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    cnt += sh_red[0][w];
    xlo = min(xlo, sh_red[1][w]);
    xhi = max(xhi, sh_red[2][w]);
  }
  const long long plane = static_cast<long long>(in.n_rows) * C;
  const long long base = static_cast<long long>(r) * C;
  const long long ch = out.chunk;
  if (hi - lo <= ch) {
    // the row is this block's alone
    const bool ok = areas_fixed_ok(in, cnt, xlo, xhi);
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const unsigned p0 = sh_cnt[c], p1 = sh_cnt[C + c];
      out.counts[base + c] = static_cast<int>(p0 & 0xffff);
      out.counts[plane + base + c] = static_cast<int>(p0 >> 16);
      out.counts[2 * plane + base + c] = static_cast<int>(p1 & 0xffff);
      out.counts[3 * plane + base + c] = static_cast<int>(p1 >> 16);
      if (ok) {
        out.areas[base + c] = area_double(in, sh_area[c]);
        out.areas[plane + base + c] = area_double(in, sh_area[C + c]);
      }
    }
    if (!ok)
      per_pmt_exact_areas(in, out, r, lo, hi,
                          reinterpret_cast<double*>(sh_area));
    return;
  }
  // a long row: add the table to the row's scratch table, take a ticket
  const long long pieces = pieces_of(lo, hi, ch);
  unsigned long long* w = pmt_scratch(out, C, lo / ch);
  unsigned* wc = reinterpret_cast<unsigned*>(w);
  unsigned long long* wa = w + 2 * C;
  unsigned* wg = reinterpret_cast<unsigned*>(w + 4 * C);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const unsigned p0 = sh_cnt[c], p1 = sh_cnt[C + c];
    if (p0 != 0) {
      atomicAdd(wc + c, p0 & 0xffff);
      atomicAdd(wc + C + c, p0 >> 16);
    }
    if (p1 != 0) {
      atomicAdd(wc + 2 * C + c, p1 & 0xffff);
      atomicAdd(wc + 3 * C + c, p1 >> 16);
    }
    if (sh_area[c] != 0) atomicAdd(wa + c, sh_area[c]);
    if (sh_area[C + c] != 0) atomicAdd(wa + C + c, sh_area[C + c]);
  }
  if (threadIdx.x == 0) {
    if (cnt != 0) atomicAdd(wg, cnt);
    if (xhi != 0) {
      atomicMax(wg + 1, ~xlo);
      atomicMax(wg + 2, xhi);
    }
  }
  tiles::fence_acq_rel();
  __syncthreads();
  if (threadIdx.x == 0) sh_last = tiles::ticket_add(wg + 3) + 1 == pieces;
  __syncthreads();
  if (!sh_last) return;
  tiles::fence_acq_rel();
  if (threadIdx.x == 0) {
    sh_g[0] = atomicExch(wg, 0u);
    sh_g[1] = ~atomicExch(wg + 1, 0u);
    sh_g[2] = atomicExch(wg + 2, 0u);
    atomicExch(wg + 3, 0u);
  }
  __syncthreads();
  const bool ok = areas_fixed_ok(in, sh_g[0], sh_g[1], sh_g[2]);
  for (int c = threadIdx.x; c < C; c += kThreads) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out.counts[k * plane + base + c] =
          static_cast<int>(atomicExch(wc + k * C + c, 0u));
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const unsigned long long a = atomicExch(wa + k * C + c, 0ull);
      if (ok) out.areas[k * plane + base + c] = area_double(in, a);
    }
  }
  if (!ok)
    per_pmt_exact_areas(in, out, r, lo, hi,
                        reinterpret_cast<double*>(sh_area));
}

// piece p (find_piece) a block: a row's first chunk found by every
// thread, a tile's rows by warp 0 and kept in shared memory (held in
// registers across the first row's piece, they cost 30 % on the bench
// batch), at most 64 registers a thread (80 cost 25 %); dynamic shared
// memory: the tables, (2, C) u64 areas then (2, C) u32 packed counts
__global__ void __launch_bounds__(kThreads, 4) pmt_row_truth_per_pmt_kernel(
    TruthIn in, PmtOut out) {
  __shared__ Piece sh_q;
  auto* sh_area = reinterpret_cast<unsigned long long*>(g_dyn_sh);
  if (blockIdx.x < static_cast<unsigned>(in.n_rows)) {
    const Piece q = find_piece(in, blockIdx.x, out.chunk);
    per_pmt_piece(in, out, q.row[0], q.lo[0], q.hi[0], q.pa[0], q.pb[0],
                  sh_area);
    return;
  }
  if (threadIdx.x < 32) {
    const Piece q = find_piece(in, blockIdx.x, out.chunk);
    if (threadIdx.x == 0) sh_q = q;
  }
  __syncthreads();
  for (int i = 0; i < 2; ++i)
    if (sh_q.row[i] >= 0)
      per_pmt_piece(in, out, sh_q.row[i], sh_q.lo[i], sh_q.hi[i], sh_q.pa[i],
                    sh_q.pb[i], sh_area);
}

unsigned grid_of(long long work) {
  return static_cast<unsigned>((work + kThreads - 1) / kThreads);
}

TruthIn truth_in(const void* row_edges, int n_rows, int n, const void* t,
                 const void* valid, const void* ch, const void* gain,
                 const void* is_dpe, const void* chan_pack, int C,
                 const void* current_max, int dt, float current_2_adc,
                 int area_scale, void* second) {
  TruthIn in;
  in.edges = static_cast<const long long*>(row_edges);
  in.n_rows = n_rows;
  in.n = n;
  in.t = static_cast<const int*>(t);
  in.valid = static_cast<const unsigned char*>(valid);
  in.ch = static_cast<const int*>(ch);
  in.gain = static_cast<const float*>(gain);
  in.is_dpe = static_cast<const unsigned char*>(is_dpe);
  in.chan_pack = static_cast<const float*>(chan_pack);
  in.C = C;
  in.current_max = static_cast<const float*>(current_max);
  in.dt = dt;
  in.inv_dt = dt > 0 ? 1.0 / dt : 0.0;
  in.current_2_adc = current_2_adc;
  in.area_unit = std::ldexp(1.0f, area_scale);
  in.area_inv = std::ldexp(1.0, -area_scale);
  in.area_min_bits = static_cast<unsigned>(127 + 23 - area_scale) << 23;
  in.area_max_sum = std::ldexp(1.0, 62 - area_scale);
  in.second = static_cast<int*>(second);
  return in;
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

// a warp (block_rows: a block) per row (its first 2^wlog photons) and per
// tile of 2^wlog of the n photons (wlog <= 14 keeps a piece's packed
// 16-bit counts exact); areas as int64 multiples of 2^-area_scale (1 to
// 61); acc: n_rows * 17 zero 64-bit words, left zero (one buffer per
// stream: two launches sharing it must not overlap); second: the (3,)
// int32 second-pass counters
extern "C" int wfsim_pmt_row_truth(
    const void* row_edges, int n_rows, int n, int wlog, int block_rows,
    const void* t,
    const void* valid, const void* ch, const void* gain, const void* is_dpe,
    const void* chan_pack, int C, const void* current_max, int dt,
    float current_2_adc, int area_scale, void* sums, void* count,
    void* t_min, void* t_max, void* mean_offset, void* sigma, void* acc,
    void* second, void* stream) {
  if (n_rows <= 0 || n < 0 || wlog < 5 || wlog > 14 || area_scale < 1 ||
      area_scale > 61 || (ch != nullptr && (C <= 0 || C > 1536 || dt <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<unsigned long long>(t) |
       reinterpret_cast<unsigned long long>(valid) |
       reinterpret_cast<unsigned long long>(ch) |
       reinterpret_cast<unsigned long long>(gain) |
       reinterpret_cast<unsigned long long>(is_dpe)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const TruthIn in = truth_in(row_edges, n_rows, n, t, valid, ch, gain,
                              is_dpe, chan_pack, C, current_max, dt,
                              current_2_adc, area_scale, second);
  RowOut out;
  out.sums = static_cast<double*>(sums);
  out.count = static_cast<long long*>(count);
  out.t_min = static_cast<int*>(t_min);
  out.t_max = static_cast<int*>(t_max);
  out.mean_offset = static_cast<double*>(mean_offset);
  out.sigma = static_cast<double*>(sigma);
  const long long chunk = 1ll << wlog;
  const long long pieces =
      n_rows + (static_cast<long long>(n) + chunk - 1) / chunk;
  auto* a = static_cast<unsigned long long*>(acc);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = ch != nullptr ? 16 * ((3 * C + 3) / 4) : 0;
  const unsigned blocks = static_cast<unsigned>(
      block_rows ? pieces : (pieces + kWarps - 1) / kWarps);
  if (block_rows && ch != nullptr)
    pmt_row_truth_kernel<true, true><<<blocks, kThreads, smem, s>>>(
        in, out, chunk, pieces, a);
  else if (block_rows)
    pmt_row_truth_kernel<false, true><<<blocks, kThreads, 0, s>>>(
        in, out, chunk, pieces, a);
  else if (ch != nullptr)
    pmt_row_truth_kernel<true, false><<<blocks, kThreads, smem, s>>>(
        in, out, chunk, pieces, a);
  else
    pmt_row_truth_kernel<false, false><<<blocks, kThreads, 0, s>>>(
        in, out, chunk, pieces, a);
  return static_cast<int>(cudaGetLastError());
}

// counts (4, n_rows, C) int32 and areas (2, n_rows, C) float64, every entry
// written; a block per row and per chunk-sized tile of the n photons
// (chunk <= 16,383 keeps a block's packed 16-bit counts exact); areas as
// the row kernel's; scratch: ceil(n / chunk) * (4 C + 2) zero 64-bit
// words, left zero (one buffer per stream, as the row kernel's acc); C <=
// 1536 keeps the block's 24 bytes a channel of tables and its staging
// under the 48 KB default; chan_pack 16-byte aligned (one 16-byte load a
// photon)
extern "C" int wfsim_pmt_row_truth_per_pmt(
    const void* row_edges, int n_rows, int n, int chunk, const void* t,
    const void* valid, const void* ch, const void* gain, const void* is_dpe,
    const void* chan_pack, int C, const void* current_max, int dt,
    float current_2_adc, int area_scale, void* counts, void* areas,
    void* scratch, void* second, void* stream) {
  if (n_rows <= 0 || n < 0 || C <= 0 || C > 1536 || dt <= 0 || chunk <= 0 ||
      chunk > 16383 || area_scale < 1 || area_scale > 61)
    return static_cast<int>(cudaErrorInvalidValue);
  const TruthIn in = truth_in(row_edges, n_rows, n, t, valid, ch, gain,
                              is_dpe, chan_pack, C, current_max, dt,
                              current_2_adc, area_scale, second);
  PmtOut out;
  out.counts = static_cast<int*>(counts);
  out.areas = static_cast<double*>(areas);
  out.scratch = static_cast<unsigned long long*>(scratch);
  out.chunk = chunk;
  const long long tiles = (static_cast<long long>(n) + chunk - 1) / chunk;
  if ((reinterpret_cast<unsigned long long>(t) |
       reinterpret_cast<unsigned long long>(valid) |
       reinterpret_cast<unsigned long long>(ch) |
       reinterpret_cast<unsigned long long>(gain) |
       reinterpret_cast<unsigned long long>(is_dpe) |
       reinterpret_cast<unsigned long long>(chan_pack)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = static_cast<size_t>(C) * (2 * sizeof(unsigned long long) +
                                                2 * sizeof(unsigned));
  pmt_row_truth_per_pmt_kernel<<<static_cast<unsigned>(n_rows + tiles),
                                 kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(in,
                                                                      out);
  return static_cast<int>(cudaGetLastError());
}
