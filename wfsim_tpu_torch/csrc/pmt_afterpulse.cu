// pmt_afterpulse: PMT afterpulse photons and the electron-afterpulse
// photon summaries.
//
// Replaces: wfsim_tpu/models/afterpulse.py:56 pmt_afterpulse_photons
// (selection over every (element, photon) slot, compaction, the delay and
// amplitude CDF inversions of the compacted slots, the regroup by truth row
// and the per-row counts, first and last times) and :184 photon_summaries
// (lines 183-198: the valid photons, offsets and time-zero candidates per
// instruction).
//
// The generator's output order is (truth row, element, photon): the
// element-major compaction of wfsim_tpu regrouped stably by truth row.
// The TPU form compacted with a cumulative sum and a search, then sorted
// the survivors by row.  Here the final position of each selected slot is
// known without a sort: photons ascend in truth row (the pmt_response
// contract), so the selected slots of element e in row r are those of the
// photon range [rs_r, re_r), and slot (e, i) of row r goes to
//   base(r, e) + (selected slots of element e in [rs_r, i)),
//   base(r, e) = sum_e' P_e'(rs_r) + sum_{e' < e} (P_e'(re_r) - P_e'(rs_r)),
// where P_e(x) counts the selected slots of element e among photons < x.
// Five entry points, the first three one call of the generator, the last
// two one call of the summaries, each with a plain twin in
// wfsim_tpu_torch/models/afterpulse.py:
//   wfsim_pmt_ap_select        a block an (element, tile of 1,024
//                              photons), a thread a slot: a warp's
//                              selection is one ballot, a 32-bit mask word
//                              (E x n bits in all), and the tile's count
//                              the sum of its 32 popcounts.  The
//                              per-(element, channel) comparands (the delay
//                              row's last value, the amplitude row's first
//                              two summed) come from an (E, C) table the
//                              wrapper makes once per pair of tables (8 KB
//                              at E = 2, read through L1), so a slot reads
//                              its uniforms and no table row.  (A block
//                              looping over the elements, the photon read
//                              once, took 1.5 times as long: its elements'
//                              loads wait on one another.)
//   (torch.cumsum over the E x tiles counts, in (element, tile) order)
//   wfsim_pmt_ap_rows          a warp a truth row: its photon range [rs, re)
//                              by two 16-ary searches of the ascending rows
//                              side by side (half a warp each), F at both
//                              ends for every element (a tile's prefix plus
//                              the popcounts of its mask words before the
//                              end, one load a lane), lane e the offset
//                              base(r, e) - F(e, rs), the row's count, t_min
//                              and t_max set to their identities; the warp
//                              of the last row writes [total, status], the
//                              call's one read-back (status 1: a truth row
//                              outside [0, rows));
//   wfsim_pmt_ap_emit          a warp an (element, tile): the tile's
//                              selected slots are dealt round the lanes
//                              (slot s to lane s mod 32: its word by a
//                              5-step search of the lanes' prefix sums of
//                              popcounts, its bit by skipping the set bits
//                              before it), so a lane holds one slot or two
//                              whatever the words hold; the slot goes to
//                              offsets[r, e] + F(e, tile start) + s.  It
//                              inverts the CDF rows exactly as the twin
//                              (the delay and amplitude searches step side
//                              by side) and writes t, ch, gain, is_dpe,
//                              valid and truth row there; t_min and t_max
//                              by atomicMin / atomicMax on int32, first
//                              reduced in the lane and then among the
//                              lanes that end on one row (the result does
//                              not depend on the order);
//   wfsim_ap_valid_tiles       the summaries' valid photons as select
//                              makes its slots: a block a tile of 1,024
//                              photons, a warp's 32 flags one ballot, a
//                              32-bit mask word, the tile's count the sum
//                              of its 32 popcounts;
//   (torch.cumsum over the tile counts)
//   wfsim_ap_photon_summaries  a warp an instruction: its photon range
//                              [rs, re) by rows' two searches (row_range),
//                              F at both ends (rank_of, as rows takes
//                              it), count = F(re) - F(rs) and offset =
//                              F(rs) - F(rs_0), the twin's exclusive
//                              cumsum of the counts (valid photons of
//                              rows at or past n_inst, which the twin's
//                              bincount drops, sit after every range, so
//                              no offset counts them); its lanes take
//                              the K candidates in turn, t[clip(offset +
//                              trunc(u * max(count, 1)))].  Three
//                              launches, no nonzero, bincount or
//                              read-back (the twin's boolean index and
//                              bincount each sync).
// F(e, x) is the flat (element, photon) rank of photon x of element e: the
// selected slots of the elements before e plus P_e(x).  A row of 10^6
// photons is ~1,000 tiles like any other: no warp walks a row, and the
// ranks see no skew.  Both the generator's photons and the summaries'
// ascend in truth row, invalid photons included: pmt_response keeps the
// photon order of the S1 and S2 passes, which give each photon its
// instruction's row, and the instructions' rows ascend.
//
// What bounds them on the H100: memory traffic.  Select reads u0 and the
// auxiliary draw of every slot and ch, is_dpe and valid of every photon
// (~22 bytes a photon at E = 2) and writes n/8 bytes of mask an element;
// emit touches only the ~1.5 % selected slots, each binary-searching its
// 4,000-float delay row (12 steps of cached loads) for a non-uniform
// element.  At the bench batch (1.5 M photons, E = 2) the bytes are ~35 MB
// (~0.011 ms); the fixed costs are the four launches and the read-back.
// The summaries read the n valid flags (1.5 MB at the bench batch), the
// rows' search probes and K candidates an instruction: ~3 MB; their
// fixed costs are the three launches.
//
// Numerics.  nvcc contracts a*b+c into an FMA by default (--fmad=true),
// which rounds once where the twin rounds twice.  Every product, sum and
// quotient the twin rounds separately is written with __fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn, so kernel and twin agree bitwise:
//   (lo0 + aux*(hi0-lo0)) * delay_bin,  didx*delay_bin - t_modifier,
//   gains[ch]*amp,  (1-u0)/modifier,  rU0/2,  u*max(count,1),
//   amp_cdf[0] + amp_cdf[1] (the wrapper's float32 add: the same rounding).
// float -> int casts truncate toward zero in C as in astype and torch's
// .to(int32); afterpulse delays go down to -pmt_ap_t_modifier, so the sign
// matters and truncation (not floor) is what the reference does.
// The CDF rows are edge-padded, so they have plateaus; the lower-bound
// search and the "|v0-r| <= |v1-r| picks the lower index" rule settle
// the index on a plateau exactly as the twin's searchsorted does.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kTileWords = 32;                 // mask words a tile
constexpr int kTile = kTileWords * 32;         // photons a tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// rU0 = (1 - u0) / modifier, halved for a double-PE photon
// (wfsim_tpu afterpulse.py:88-90)
__device__ __forceinline__ float select_draw(float u0, float modifier,
                                             bool dpe) {
  float r0 = __fdiv_rn(__fsub_rn(1.0f, u0), modifier);
  return dpe ? __fdiv_rn(r0, 2.0f) : r0;
}

// index minimizing |row[i] - r| on a non-decreasing row, the lower index
// on a tie: the first index at or above r (lower bound, clamped to R-1)
// and its predecessor are the only candidates (afterpulse.py:29-52)
__device__ __forceinline__ int argmin_of(const float* row, int R, float r,
                                         int lower) {
  const int i1 = lower < R - 1 ? lower : R - 1;
  const int i0 = i1 > 0 ? i1 - 1 : 0;
  return fabsf(__fsub_rn(row[i0], r)) <= fabsf(__fsub_rn(row[i1], r)) ? i0
                                                                      : i1;
}

// argmin_of on two rows at once: their lower-bound searches step side by
// side, so the two chains of dependent loads overlap
__device__ __forceinline__ void argmin_abs_monotone2(
    const float* a, int Ra, float ra, const float* b, int Rb, float rb,
    int* ia, int* ib) {
  int lo_a = 0, hi_a = Ra, lo_b = 0, hi_b = Rb;
  while (lo_a < hi_a || lo_b < hi_b) {
    if (lo_a < hi_a) {
      const int mid = (lo_a + hi_a) >> 1;
      if (a[mid] < ra) lo_a = mid + 1; else hi_a = mid;
    }
    if (lo_b < hi_b) {
      const int mid = (lo_b + hi_b) >> 1;
      if (b[mid] < rb) lo_b = mid + 1; else hi_b = mid;
    }
  }
  *ia = argmin_of(a, Ra, ra, lo_a);
  *ib = argmin_of(b, Rb, rb, lo_b);
}

// a block an (element, tile): a thread a slot, a warp a mask word
__global__ void ap_select_kernel(
    const float* __restrict__ u0, const float* __restrict__ u2,
    const int* __restrict__ ch, const unsigned char* __restrict__ is_dpe,
    const unsigned char* __restrict__ valid, int n,
    const float2* __restrict__ limits, int C,
    const unsigned char* __restrict__ uniform_e,
    const float* __restrict__ amp_bin, float modifier, int n_tiles,
    unsigned* __restrict__ mask, int* __restrict__ tile_counts) {
  __shared__ int warp_counts[kTileWords];
  const int tile = blockIdx.x, e = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = tile * kTile + threadIdx.x;
  const long long k = static_cast<long long>(e) * n + i;
  bool sel = false;
  if (i < n && valid[i]) {
    // limits: the delay row's last value, the amplitude row's first two
    // summed (NaN without two: never below 2 aux)
    const float2 l = limits[e * C + clampi(ch[i], 0, C - 1)];
    sel = select_draw(u0[k], modifier, is_dpe[i] != 0) <= l.x;
    // a non-uniform element's amplitude index 0 (amplitude 0) holds iff
    // aux <= the midpoint of the row's first two values
    if (sel && !uniform_e[e])
      sel = amp_bin[e] > 0.0f &&
            __fmul_rn(2.0f, __fsub_rn(1.0f, u2[k])) > l.y;
  }
  const unsigned w = __ballot_sync(kFull, sel);
  const int n_words = (n + 31) >> 5, word = tile * kTileWords + warp;
  if (lane == 0) {
    if (word < n_words) mask[static_cast<long long>(e) * n_words + word] = w;
    warp_counts[warp] = __popc(w);
  }
  __syncthreads();
  if (warp == 0) {
    const int cnt = __reduce_add_sync(kFull, warp_counts[lane]);
    if (lane == 0) tile_counts[e * n_tiles + tile] = cnt;
  }
}

// lanes 0-15 and lanes 16-31 each find the first index in [0, n) whose row
// is >= their v (n if none): each step probes 16 evenly spaced rows and
// keeps the segment where the rows reach v (rows ascend)
__device__ __forceinline__ int lower_bound_half(
    const long long* __restrict__ rows, int n, long long v, int lane) {
  const int base = lane & 16, sub = lane & 15;
  int lo = 0, hi = n;
  while (__any_sync(kFull, lo < hi)) {
    const int q = lo + static_cast<int>(
        static_cast<long long>(hi - lo) * sub / 16);
    const bool above = lo < hi && rows[q] >= v;
    const unsigned b = (__ballot_sync(kFull, above) >> base) & 0xffffu;
    const int first = b ? __ffs(b) - 1 : 16;
    const int q_hi = __shfl_sync(kFull, q, base + (first < 16 ? first : 15));
    const int q_lo = __shfl_sync(kFull, q, base + (first > 0 ? first - 1 : 0));
    if (lo < hi) {
      if (first == 16) {
        lo = q_hi + 1;                 // every probe below v: past q_15
      } else if (first == 0) {
        hi = lo;
      } else {
        lo = q_lo + 1;
        hi = q_hi;
      }
    }
  }
  return lo;
}

// the lane's word of the tile holding photon x, cut to the bits before x
// (0 past x's word)
__device__ __forceinline__ unsigned bits_before(const unsigned* __restrict__ m,
                                                int x, int n_words,
                                                int lane) {
  const int word = x / kTile * kTileWords + lane, xw = x >> 5;
  if (word < xw) return m[word];
  if (word == xw && word < n_words) return m[word] & ((1u << (x & 31)) - 1u);
  return 0u;
}

// a warp's truth row r: its photon range [rs, re), the first photons
// whose rows reach r and r + 1 (lanes 0-15 search one, lanes 16-31 the
// other)
__device__ __forceinline__ void row_range(const long long* __restrict__ rows,
                                          int n, int r, int lane, int* rs,
                                          int* re) {
  const int bound = lower_bound_half(rows, n, static_cast<long long>(r) +
                                     (lane >> 4), lane);
  *rs = __shfl_sync(kFull, bound, 0);
  *re = __shfl_sync(kFull, bound, 16);
}

// the set bits of a mask before photon x, by a warp: the inclusive prefix
// `incl` of the tiles' counts before x's tile (flat tile index k; 0 for
// the first) plus the popcounts of x's tile's words before x
__device__ __forceinline__ int rank_of(const unsigned* __restrict__ m,
                                       const int* __restrict__ incl, int k,
                                       int x, int n_words, int lane) {
  return (k > 0 ? incl[k - 1] : 0) +
         static_cast<int>(__reduce_add_sync(
             kFull, __popc(bits_before(m, x, n_words, lane))));
}

// a warp a truth row
__global__ void ap_rows_kernel(
    const long long* __restrict__ truth_row, int n, int R, int n_elements,
    const unsigned* __restrict__ mask, const int* __restrict__ incl,
    int n_tiles, int* __restrict__ offsets, int* __restrict__ counts,
    int* __restrict__ t_min, int* __restrict__ t_max,
    int* __restrict__ info) {
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  const int n_words = (n + 31) >> 5;
  int rs, re;
  row_range(truth_row, n, r, lane, &rs, &re);
  // the flat rank F(e, x) of photon x: the tile's exclusive prefix plus
  // the selected bits of its tile before x; P_e(x) = F(e, x) - F(e, 0)
  int base = 0, cum = 0, mine = 0;
  for (int e = 0; e < n_elements; ++e) {
    const unsigned* m = mask + static_cast<long long>(e) * n_words;
    const int a = rank_of(m, incl, e * n_tiles + rs / kTile, rs, n_words,
                          lane);
    const int b = rank_of(m, incl, e * n_tiles + re / kTile, re, n_words,
                          lane);
    base += a - (e > 0 ? incl[e * n_tiles - 1] : 0);
    if (lane == e) mine = cum - a;
    cum += b - a;
  }
  // slot (e, i) of this row goes to offsets[r, e] + F(e, i)
  if (lane < n_elements) offsets[r * n_elements + lane] = base + mine;
  if (lane == 0) {
    counts[r] = cum;
    t_min[r] = INT_MAX;
    t_max[r] = -INT_MAX;
    if (r == R - 1) {
      info[0] = incl[n_elements * n_tiles - 1];
      info[1] = n > 0 && (truth_row[0] < 0 || truth_row[n - 1] >= R);
    }
  }
}

// a warp an (element, tile): a lane a mask word
__global__ void ap_emit_kernel(
    const unsigned* __restrict__ mask, const int* __restrict__ incl,
    const int* __restrict__ offsets, int n_tiles, int total,
    const float* __restrict__ u0, const float* __restrict__ u1,
    const float* __restrict__ u2, const int* __restrict__ t,
    const int* __restrict__ ch, const unsigned char* __restrict__ is_dpe,
    const long long* __restrict__ truth_row, int n, int n_elements, int R,
    const float* __restrict__ delay, int C, int Td,
    const float* __restrict__ amp, int Ta, const float* __restrict__ gains,
    float modifier, float t_modifier,
    const unsigned char* __restrict__ uniform_e,
    const float* __restrict__ delay_bin, const float* __restrict__ amp_bin,
    int* __restrict__ out_t, int* __restrict__ out_ch,
    float* __restrict__ out_gain, unsigned char* __restrict__ out_dpe,
    unsigned char* __restrict__ out_valid, long long* __restrict__ out_row,
    int* __restrict__ t_min, int* __restrict__ t_max) {
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int e = blockIdx.y;
  const int lane = threadIdx.x & 31;
  if (tile >= n_tiles) return;
  const int n_words = (n + 31) >> 5;
  const int word = tile * kTileWords + lane;
  const unsigned w = word < n_words
      ? mask[static_cast<long long>(e) * n_words + word] : 0u;
  const int c_w = __popc(w);
  int pre = c_w;                               // inclusive warp prefix sum
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, pre, d);
    if (lane >= d) pre += y;
  }
  const int n_sel = __shfl_sync(kFull, pre, 31);  // the tile's selected
  const int k = e * n_tiles + tile;
  const int first = k > 0 ? incl[k - 1] : 0;      // F of the tile's first
  const bool uni = uniform_e[e] != 0;
  const float dbin = delay_bin[e], abin = amp_bin[e];
  // the lane's running first and last time of its current row
  int cur = -1, lo_t = INT_MAX, hi_t = -INT_MAX;
  // the tile's selected slots dealt round the lanes: slot s to lane s % 32
  for (int s0 = 0; s0 < n_sel; s0 += 32) {
    const int s = s0 + lane;
    // its word: the first lane whose inclusive prefix passes s
    int j = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (__shfl_sync(kFull, pre, j + step - 1) <= s) j += step;
    unsigned wj = __shfl_sync(kFull, w, j & 31);
    const int skip = s - __shfl_sync(kFull, pre - c_w, j & 31);
    if (s >= n_sel) continue;
    for (int q = 0; q < skip; ++q) wj &= wj - 1;
    const int i = (tile * kTileWords + j) * 32 + __ffs(wj) - 1;
    const long long sk = static_cast<long long>(e) * n + i;
    const long long rl = truth_row[i];
    const int r = static_cast<int>(rl);
    const int pos = rl >= 0 && rl < R
        ? offsets[r * n_elements + e] + first + s : -1;
    if (pos < 0 || pos >= total) continue;     // rows out of contract
    const int c = clampi(ch[i], 0, C - 1);
    const long long tab = static_cast<long long>(e) * C + c;
    const float* drow = delay + tab * Td;
    float ap_delay, ap_amp;
    if (uni) {
      const float aux = u1[sk];
      const float lo = drow[0], hi = drow[1];
      ap_delay = __fmul_rn(__fadd_rn(lo, __fmul_rn(aux, __fsub_rn(hi, lo))),
                           dbin);
      ap_amp = 1.0f;
    } else {
      const float aux = __fsub_rn(1.0f, u2[sk]);
      const float r0 = select_draw(u0[sk], modifier, is_dpe[i] != 0);
      int didx, aidx;
      argmin_abs_monotone2(drow, Td, r0, amp + tab * Ta, Ta, aux, &didx,
                           &aidx);
      ap_delay = __fsub_rn(__fmul_rn(static_cast<float>(didx), dbin),
                           t_modifier);
      ap_amp = __fmul_rn(static_cast<float>(aidx), abin);
    }
    const int tt = t[i] + static_cast<int>(ap_delay);  // truncates to 0
    out_t[pos] = tt;
    out_ch[pos] = ch[i];
    out_gain[pos] = __fmul_rn(gains[c], ap_amp);
    out_dpe[pos] = 0;
    out_valid[pos] = 1;
    out_row[pos] = rl;
    if (r != cur) {
      if (cur >= 0) {
        atomicMin(t_min + cur, lo_t);
        atomicMax(t_max + cur, hi_t);
      }
      cur = r;
      lo_t = hi_t = tt;
    } else {
      lo_t = min(lo_t, tt);
      hi_t = max(hi_t, tt);
    }
  }
  // the lanes that end on one row combine before their atomics
  const unsigned same = __match_any_sync(kFull, cur);
  lo_t = __reduce_min_sync(same, lo_t);
  hi_t = __reduce_max_sync(same, hi_t);
  if (cur >= 0 && lane == __ffs(same) - 1) {
    atomicMin(t_min + cur, lo_t);
    atomicMax(t_max + cur, hi_t);
  }
}

// the summaries' valid photons: a block a tile of 1,024 photons, a thread
// a photon, a warp a mask word; the tile's count
__global__ void ap_valid_tiles_kernel(const unsigned char* __restrict__ valid,
                                      int n, unsigned* __restrict__ mask,
                                      int* __restrict__ tile_counts) {
  __shared__ int warp_counts[kTileWords];
  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = tile * kTile + threadIdx.x;
  const unsigned w = __ballot_sync(kFull, i < n && valid[i]);
  const int n_words = (n + 31) >> 5, word = tile * kTileWords + warp;
  if (lane == 0) {
    if (word < n_words) mask[word] = w;
    warp_counts[warp] = __popc(w);
  }
  __syncthreads();
  if (warp == 0) {
    const int cnt = __reduce_add_sync(kFull, warp_counts[lane]);
    if (lane == 0) tile_counts[tile] = cnt;
  }
}

// a warp an instruction: its valid photons F(re) - F(rs), F the valid
// photons before a photon, its offset F(rs) - F(rs_0), and its K
// candidates t[clip(offset + trunc(u * max(count, 1)))], a lane each in
// turn
__global__ void ap_summaries_kernel(
    const int* __restrict__ t, const long long* __restrict__ truth_row,
    int n, const unsigned* __restrict__ mask, const int* __restrict__ incl,
    int n_inst, int K, const float* __restrict__ u,
    int* __restrict__ counts, int* __restrict__ out) {
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n_inst) return;
  const int n_words = (n + 31) >> 5;
  int rs, re;
  row_range(truth_row, n, i, lane, &rs, &re);
  const int a = rank_of(mask, incl, rs / kTile, rs, n_words, lane);
  const int b = rank_of(mask, incl, re / kTile, re, n_words, lane);
  // F(rs_0): the valid photons of rows below 0 (none within the contract)
  int below = 0;
  if (truth_row[0] < 0) {
    int s0, e0;
    row_range(truth_row, n, 0, lane, &s0, &e0);
    below = rank_of(mask, incl, s0 / kTile, s0, n_words, lane);
  }
  const int cnt = b - a;
  if (lane == 0) counts[i] = cnt;
  const long long offset = a - below;
  const float c = static_cast<float>(cnt > 1 ? cnt : 1);
  for (int k = lane; k < K; k += 32) {
    const long long j = static_cast<long long>(i) * K + k;
    // slot = offset + trunc(u * max(count, 1)), clipped to the array
    long long slot = offset + static_cast<int>(__fmul_rn(u[j], c));
    slot = slot < 0 ? 0 : (slot > n - 1 ? n - 1 : slot);
    out[j] = t[slot];
  }
}

}  // namespace

extern "C" int wfsim_pmt_ap_select(
    const void* u0, const void* u2, const void* ch, const void* is_dpe,
    const void* valid, int n, int n_elements, const void* limits, int C,
    const void* uniform_e, const void* amp_bin, float modifier, int n_tiles,
    void* mask, void* tile_counts, void* stream) {
  if (n <= 0 || n_elements <= 0 || n_elements > 32 || C <= 0 ||
      n_tiles != (n + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  ap_select_kernel<<<dim3(n_tiles, n_elements), kTile, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u0), static_cast<const float*>(u2),
      static_cast<const int*>(ch), static_cast<const unsigned char*>(is_dpe),
      static_cast<const unsigned char*>(valid), n,
      static_cast<const float2*>(limits), C,
      static_cast<const unsigned char*>(uniform_e),
      static_cast<const float*>(amp_bin), modifier, n_tiles,
      static_cast<unsigned*>(mask), static_cast<int*>(tile_counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wfsim_pmt_ap_rows(
    const void* truth_row, int n, int R, int n_elements, const void* mask,
    const void* incl, int n_tiles, void* offsets, void* counts, void* t_min,
    void* t_max, void* info, void* stream) {
  if (n <= 0 || R <= 0 || n_elements <= 0 || n_elements > 32 ||
      n_tiles != (n + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  ap_rows_kernel<<<(R + kWarps - 1) / kWarps, kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(truth_row), n, R, n_elements,
      static_cast<const unsigned*>(mask), static_cast<const int*>(incl),
      n_tiles, static_cast<int*>(offsets), static_cast<int*>(counts),
      static_cast<int*>(t_min), static_cast<int*>(t_max),
      static_cast<int*>(info));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wfsim_pmt_ap_emit(
    const void* mask, const void* incl, const void* offsets, int n_tiles,
    int total, const void* u0, const void* u1, const void* u2, const void* t,
    const void* ch, const void* is_dpe, const void* truth_row, int n,
    int n_elements, int R, const void* delay, int C, int Td, const void* amp,
    int Ta, const void* gains, float modifier, float t_modifier,
    const void* uniform_e, const void* delay_bin, const void* amp_bin,
    void* out_t, void* out_ch, void* out_gain, void* out_dpe,
    void* out_valid, void* out_row, void* t_min, void* t_max, void* stream) {
  // a uniform element reads drow[1]: the wrapper checks Td >= 2 for it
  if (total <= 0 || n <= 0 || R <= 0 || n_elements <= 0 ||
      n_elements > 65535 || C <= 0 || Td <= 0 || Ta <= 0 ||
      n_tiles != (n + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  ap_emit_kernel<<<dim3((n_tiles + kWarps - 1) / kWarps, n_elements), kBlock,
                   0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(mask), static_cast<const int*>(incl),
      static_cast<const int*>(offsets), n_tiles, total,
      static_cast<const float*>(u0), static_cast<const float*>(u1),
      static_cast<const float*>(u2), static_cast<const int*>(t),
      static_cast<const int*>(ch), static_cast<const unsigned char*>(is_dpe),
      static_cast<const long long*>(truth_row), n, n_elements, R,
      static_cast<const float*>(delay), C, Td,
      static_cast<const float*>(amp), Ta, static_cast<const float*>(gains),
      modifier, t_modifier, static_cast<const unsigned char*>(uniform_e),
      static_cast<const float*>(delay_bin),
      static_cast<const float*>(amp_bin), static_cast<int*>(out_t),
      static_cast<int*>(out_ch), static_cast<float*>(out_gain),
      static_cast<unsigned char*>(out_dpe),
      static_cast<unsigned char*>(out_valid),
      static_cast<long long*>(out_row), static_cast<int*>(t_min),
      static_cast<int*>(t_max));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wfsim_ap_valid_tiles(const void* valid, int n, int n_tiles,
                                    void* mask, void* tile_counts,
                                    void* stream) {
  if (n <= 0 || n_tiles != (n + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  ap_valid_tiles_kernel<<<n_tiles, kTile, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(valid), n,
      static_cast<unsigned*>(mask), static_cast<int*>(tile_counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wfsim_ap_photon_summaries(
    const void* t, const void* truth_row, int n, const void* mask,
    const void* incl, int n_inst, int K, const void* u, void* counts,
    void* out, void* stream) {
  if (n <= 0 || n_inst <= 0 || K < 0 ||
      static_cast<long long>(n_inst) * K > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  ap_summaries_kernel<<<(n_inst + kWarps - 1) / kWarps, kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(t), static_cast<const long long*>(truth_row),
      n, static_cast<const unsigned*>(mask), static_cast<const int*>(incl),
      n_inst, K, static_cast<const float*>(u), static_cast<int*>(counts),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
