// CDEF of one frame with one frame-wide preset, as one kernel for Hopper:
// cdef_filter.
//
// Replaces the jitted CDEF of av1tpu/models/cdef_tpu.py: `cdef_dirs`
// (:73, the per-8x8 direction search as a 0/1 matrix product) and
// `_filter_plane` (:116), which `cdef_planes` (:173) runs on the three
// planes (`cdef_tpu`, :229, is its jitted entry).  This is not a
// pallas_call: XLA fused them, where the port's eager version issued about
// 2,000 PyTorch operations per frame, each over the whole plane
// (kernels/cdef.py holds the wrapper and the plain PyTorch version, whose
// arithmetic this kernel repeats).  It runs in the inter step's in-loop
// filter, on the keyframe, and once per preset in the keyframe's strength
// search.  Per 8x8 luma unit that skip8 leaves on:
//
// - the direction search (spec 7.15.2): the eight directions' partial sums
//   of (y >> coeff_shift) - 128 over their bins, the cost
//   sum(partial^2 * weight) in wrapping int32 (as the plain version's
//   int32 sum), the first maximum and the variance (best - opposite) >> 10;
// - the luma primary strength adjusted by the variance (adjust_strength)
//   and its parity, which picks the (4, 2) or (3, 3) primary taps;
// - the filter of each pixel (spec 7.15.3): primary taps along the
//   direction, secondary taps at +-2 directions, constrain() with
//   damping + coeff_shift (chroma damping - 1 + coeff_shift), the min/max
//   clamp over the taps, and CDEF_VERY_LARGE outside the frame;
// - the unit's two 4x4 chroma units with the luma unit's direction.
//
// A unit that skip8 marks, and a plane whose strengths are zero, is copied.
// A preset of all-zero strengths never launches (the wrapper returns the
// planes).
//
// What bounds it on an H100.  A 1088x1920 frame reads its 3.1 M pre-CDEF
// samples (int32) and writes as many, 25 MB, about 7.5 us at 3.35 TB/s.
// The integer work depends on the skip map: a live unit costs about 840
// operations of direction search and about 137 per filtered pixel (12
// taps of about 11 each), 14,000 a unit with chroma, so a frame whose
// 32,640 units are all live needs about 0.46 G int32 operations, 27 us at
// the card's 16.7 T int32 operations/s (64 lanes per SM), more than its
// bytes.  On the main path the live share varies from frame to frame
// (the smoke's 1080p quality encode: 0.25% to 87% of an inter frame's
// units, 64% of the keyframe's), so a mostly skipped frame is bound by its
// bytes and a mostly live one by its integer work.
//
// What the design does about it.  A CTA of 256 threads takes a tile of 2 x
// 16 units (16 x 128 luma pixels, 8 x 64 per chroma plane): 1,020 CTAs at
// 1080p, one wave.  Every warp reads the tile's 32 skip bits (a ballot, no
// barrier).  A tile without a live unit is a copy in 16-byte loads and
// stores, coalesced along rows, each thread's loads in flight together.
// A tile with a live unit stages its three planes with a 2-row, 4-column
// apron in shared memory once (16-byte pieces; the apron outside the frame
// is CDEF_VERY_LARGE, so no tap tests a bound); the direction search runs
// a direction per warp and a unit per lane, its 8 to 15 partial sums in
// registers (the bins are compile-time per direction), and the argmax a
// lane per unit; then each warp filters whole units (luma, then U and V
// together), so the direction, the strengths and the tap offsets are
// uniform per warp and computed once per unit.  At 64 registers four
// CTAs fit an SM, which the filter needs to hide its loads (at 134, one
// CTA an SM ran the dense frame 1.6 times slower).  All integer: the costs
// wrap in uint32 in any order, the first maximum is kept with a strict >
// over d = 0..7 in signed int32 (the plain version's argmax), so the
// kernel is bit-exact with the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LARGE = 0x4000;   // CDEF_VERY_LARGE
constexpr int NT = 256, NW = NT / 32;
// the tile: TR x TC units, one per lane of a warp
constexpr int TR = 2, TC = 16, TU = TR * TC;
static_assert(TU == 32, "one unit per lane");
constexpr int TH = 8 * TR, TW = 8 * TC;            // luma pixels
constexpr int AR = 2, AC = 4;                      // apron rows, columns
constexpr int LS = TW + 2 * AC, LR = TH + 2 * AR;  // luma stage stride, rows
constexpr int CS = TW / 2 + 2 * AC, CR = TH / 2 + 2 * AR;   // chroma

// spec CdefDirections[dir][k] = (dy, dx)
__constant__ int kDirs[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
    {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},  {{1, 0}, {2, 1}},
    {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}}};

// direction d's bins and its first bin in the 90-bin weight row
// (models/cdef.py _NBINS: 15, 11, 8, 11, 15, 11, 8, 11)
__host__ __device__ constexpr int nbins(int d) {
  return (d & 1) ? 11 : (d == 2 || d == 6 ? 8 : 15);
}
__host__ __device__ constexpr int bin_off(int d) {
  return d == 0 ? 0 : bin_off(d - 1) + nbins(d - 1);
}

// the bin of pixel (i, j) of an 8x8 block in direction D (spec 7.15.2)
template <int D>
__device__ __forceinline__ constexpr int bin_of(int i, int j) {
  return D == 0 ? i + j
       : D == 1 ? i + (j >> 1)
       : D == 2 ? i
       : D == 3 ? 3 + i - (j >> 1)
       : D == 4 ? 7 + i - j
       : D == 5 ? 3 - (i >> 1) + j
       : D == 6 ? j
       : (i >> 1) + j;
}

// floor(log2(max(x, 1)))
__device__ __forceinline__ int floor_log2(int x) {
  return x <= 1 ? 0 : 31 - __clz(x);
}

__device__ __forceinline__ int constrain(int diff, int threshold,
                                         int damp_adj) {
  if (threshold <= 0) return 0;
  const int ad = abs(diff);
  const int m = min(ad, max(threshold - (ad >> damp_adj), 0));
  return diff < 0 ? -m : m;
}

// Direction D's cost of the unit whose top-left staged pixel is p (row
// stride LS): the partial sums of (x >> cs) - 128 over D's bins, then
// sum(partial^2 * weight) wrapping in uint32.
template <int D>
__device__ unsigned dir_cost(const int* __restrict__ p, int cs,
                             const int* __restrict__ wts) {
  int part[nbins(D)];
#pragma unroll
  for (int b = 0; b < nbins(D); ++b) part[b] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // a row's loads at a time: hoisting all 16 set 134 registers for the
    // whole kernel (one CTA per SM), 56-64 without
    asm volatile("" ::: "memory");
    const int4 a = *reinterpret_cast<const int4*>(p + i * LS);
    const int4 b = *reinterpret_cast<const int4*>(p + i * LS + 4);
    const int x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) part[bin_of<D>(i, j)] += (x[j] >> cs) - 128;
  }
  unsigned c = 0;
#pragma unroll
  for (int b = 0; b < nbins(D); ++b)
    c += (unsigned)(part[b] * part[b]) * (unsigned)wts[bin_off(D) + b];
  return c;
}

__device__ __forceinline__ unsigned dir_cost_of(int d, const int* p, int cs,
                                                const int* wts) {
  switch (d) {
    case 0: return dir_cost<0>(p, cs, wts);
    case 1: return dir_cost<1>(p, cs, wts);
    case 2: return dir_cost<2>(p, cs, wts);
    case 3: return dir_cost<3>(p, cs, wts);
    case 4: return dir_cost<4>(p, cs, wts);
    case 5: return dir_cost<5>(p, cs, wts);
    case 6: return dir_cost<6>(p, cs, wts);
    default: return dir_cost<7>(p, cs, wts);
  }
}

// A unit's taps in a staged plane of row stride `stride`: the offsets of
// the primary taps (k = 0, 1) along d and of the secondary ones at d + 2
// and d + 6, each read at +offset and -offset.
struct Taps {
  int off[2][3];
};

__device__ __forceinline__ Taps taps_of(int d, int stride) {
  Taps T;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const int dd = o == 0 ? d : (d + (o == 1 ? 2 : 6)) & 7;
      T.off[k][o] = kDirs[dd][k][0] * stride + kDirs[dd][k][1];
    }
  }
  return T;
}

// One filtered sample at staged pixel p: primary strength pri with tap
// parity par, secondary strength sec, damping.
__device__ __forceinline__ int filter_px(const int* __restrict__ p,
                                         const Taps& T, int pri, int par,
                                         int sec, int damping) {
  const int px = *p;
  const int pt[2] = {4 - par, 2 + par}, st[2] = {2, 1};
  const int damp_pri = max(damping - floor_log2(pri), 0);
  const int damp_sec = max(damping - floor_log2(sec), 0);
  int sum = 0, mn = px, mx = px;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int o = 0; o < 3; ++o) {
#pragma unroll
      for (int s = 1; s >= -1; s -= 2) {
        const int q = p[s * T.off[k][o]];
        sum += o == 0 ? pt[k] * constrain(q - px, pri, damp_pri)
                      : st[k] * constrain(q - px, sec, damp_sec);
        mn = min(mn, q);
        mx = max(mx, q == LARGE ? -1 : q);
      }
    }
  }
  const int out = px + ((8 + sum - (sum < 0 ? 1 : 0)) >> 4);
  return min(max(out, mn), mx);
}

// Stage rows [r0 - AR, r0 + rows + AR) and columns [c0 - AC, c0 + cols +
// AC) of an h x w plane at row stride `stride`, CDEF_VERY_LARGE outside
// the plane, in 16-byte pieces (w is a multiple of 4, c0 of 4).
__device__ __forceinline__ void stage(const int* __restrict__ g, int h,
                                      int w, int r0, int c0, int rows,
                                      int stride, int* s) {
  const int per_row = stride / 4, n = (rows + 2 * AR) * per_row;
  for (int e = threadIdx.x; e < n; e += NT) {
    const int r = e / per_row, q = e % per_row;
    const int Y = r0 - AR + r, X = c0 - AC + 4 * q;
    int4 v = make_int4(LARGE, LARGE, LARGE, LARGE);
    if (Y >= 0 && Y < h && X >= 0 && X < w)
      v = __ldg(reinterpret_cast<const int4*>(g + (size_t)Y * w + X));
    *reinterpret_cast<int4*>(s + r * stride + 4 * q) = v;
  }
}

// Copy the tile (luma rows [y0, y0 + TH) x columns [x0, x0 + TW), and
// the chroma planes' halves), clipped to the planes, in 16-byte pieces:
// each thread's loads are in flight together before its stores.
__device__ __forceinline__ void copy_tile(
    const int* __restrict__ y, const int* __restrict__ u,
    const int* __restrict__ v, int* __restrict__ oy, int* __restrict__ ou,
    int* __restrict__ ov, int h, int w, int y0, int x0) {
  constexpr int PL = TW / 4, NL = TH * PL;               // luma pieces
  constexpr int PC = TW / 8, NC = TH / 2 * PC;           // a chroma plane's
  constexpr int K = (NL + 2 * NC + NT - 1) / NT;
  int4 val[K];
  int* to[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = threadIdx.x + k * NT;
    to[k] = nullptr;
    if (e < NL) {
      const int Y = y0 + e / PL, X = x0 + 4 * (e % PL);
      if (Y < h && X < w) {
        const size_t at = (size_t)Y * w + X;
        val[k] = __ldg(reinterpret_cast<const int4*>(y + at));
        to[k] = oy + at;
      }
    } else if (e < NL + 2 * NC) {
      const int ec = (e - NL) % NC, wc = w >> 1;
      const int Y = y0 / 2 + ec / PC, X = x0 / 2 + 4 * (ec % PC);
      if (Y < (h >> 1) && X < wc) {
        const size_t at = (size_t)Y * wc + X;
        const bool is_u = e < NL + NC;
        val[k] = __ldg(reinterpret_cast<const int4*>((is_u ? u : v) + at));
        to[k] = (is_u ? ou : ov) + at;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (to[k] != nullptr) *reinterpret_cast<int4*>(to[k]) = val[k];
}

__global__ void __launch_bounds__(NT, 2) cdef_kernel(
    const int* __restrict__ y, const int* __restrict__ u,
    const int* __restrict__ v, const unsigned char* __restrict__ skip8,
    const int* __restrict__ weights, int h, int w, int pri_y, int sec_y,
    int pri_uv, int sec_uv, int damping, int cs, int* oy, int* ou,
    int* ov) {
  __shared__ __align__(16) int s_y[LR * LS];
  // U, then V 4 words on (their 4x4 units on other banks)
  __shared__ __align__(16) int s_c[2 * CR * CS + 4];
  int* const s_u = s_c;
  int* const s_v = s_c + CR * CS + 4;
  __shared__ int s_w[90];
  __shared__ int s_cost[8][TU];
  __shared__ int s_dir[TU], s_var[TU];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nbr = h >> 3, nbc = w >> 3, hc = h >> 1, wc = w >> 1;
  const int ub_r = blockIdx.y * TR, ub_c = blockIdx.x * TC;
  const int y0 = 8 * ub_r, x0 = 8 * ub_c;
  // the tile's units, one per lane: every warp reads them (no barrier)
  const int ur = ub_r + lane / TC, uc = ub_c + lane % TC;
  const bool inside = ur < nbr && uc < nbc;
  const unsigned live = __ballot_sync(~0u, inside && !skip8[ur * nbc + uc]);
  if (live == 0) {
    copy_tile(y, u, v, oy, ou, ov, h, w, y0, x0);
    return;
  }
  const unsigned inside_mask = __ballot_sync(~0u, inside);

  stage(y, h, w, y0, x0, TH, LS, s_y);
  stage(u, hc, wc, y0 / 2, x0 / 2, TH / 2, CS, s_u);
  stage(v, hc, wc, y0 / 2, x0 / 2, TH / 2, CS, s_v);
  if (t < 90) s_w[t] = weights[t];
  __syncthreads();

  const bool luma_on = pri_y > 0 || sec_y > 0;
  const bool chroma_on = pri_uv > 0 || sec_uv > 0;
  const bool search = pri_y > 0 || pri_uv > 0;
  if (search) {
    // direction d on warps d mod NW, unit `lane` on each lane
    const int* p = s_y + (AR + 8 * (lane / TC)) * LS + AC + 8 * (lane % TC);
    if ((live >> lane) & 1)
      for (int d = warp; d < 8; d += NW)
        s_cost[d][lane] = (int)dir_cost_of(d, p, cs, s_w);
    __syncthreads();
    if (warp == 0 && ((live >> lane) & 1)) {
      int best = 0, cb = s_cost[0][lane];
      for (int d = 1; d < 8; ++d) {
        const int c = s_cost[d][lane];
        if (c > cb) {
          cb = c;
          best = d;
        }
      }
      s_dir[lane] = best;
      s_var[lane] = (int)((unsigned)cb - (unsigned)s_cost[best ^ 4][lane])
                    >> 10;
    }
    __syncthreads();
  }

  // warp `warp` takes units warp, warp + NW, ...: its lanes a unit's luma
  // pixels (four rows of eight a pass, two passes), then its U (lanes
  // 0-15) and V (16-31) pixels
  const int sec_y_eff = (sec_y + (sec_y == 3 ? 1 : 0)) << cs;
  const int sec_uv_eff = (sec_uv + (sec_uv == 3 ? 1 : 0)) << cs;
  for (int un = warp; un < TU; un += NW) {
    if (!((inside_mask >> un) & 1)) continue;
    const bool on = (live >> un) & 1;
    const int r = un / TC, c = un % TC;
    const int d = on && search ? s_dir[un] : 0;
    const int var = on && search ? s_var[un] : 0;
    {   // luma: pixel (i, j) of the unit, i = 4 * half + lane / 8
      const int i = lane >> 3, j = lane & 7;
      const int* p = s_y + (AR + 8 * r + i) * LS + AC + 8 * c + j;
      int* o = oy + (size_t)(y0 + 8 * r + i) * w + x0 + 8 * c + j;
      if (on && luma_on) {
        const int v6 = var >> 6;
        const int ii = v6 > 0 ? min(floor_log2(v6), 12) : 0;
        const int pri = var > 0 ? ((pri_y << cs) * (4 + ii) + 8) >> 4 : 0;
        const Taps T = taps_of(d, LS);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          o[(size_t)4 * half * w] = filter_px(p + 4 * half * LS, T, pri,
                                              (pri >> cs) & 1, sec_y_eff,
                                              damping + cs);
      } else {
        o[0] = p[0];
        o[(size_t)4 * w] = p[4 * LS];
      }
    }
    {   // chroma: U on lanes 0-15, V on 16-31, pixel (i, j) of the 4x4
      const int i = (lane & 15) >> 2, j = lane & 3;
      const int* p = (lane < 16 ? s_u : s_v) + (AR + 4 * r + i) * CS + AC
                     + 4 * c + j;
      int* o = (lane < 16 ? ou : ov)
               + (size_t)(y0 / 2 + 4 * r + i) * wc + x0 / 2 + 4 * c + j;
      if (on && chroma_on) {
        *o = filter_px(p, taps_of(d, CS), pri_uv << cs, pri_uv & 1,
                       sec_uv_eff, damping - 1 + cs);
      } else {
        *o = *p;
      }
    }
  }
}

}  // namespace

extern "C" int av1_cdef_filter(const int* y, const int* u, const int* v,
                               const unsigned char* skip8,
                               const int* weights, int h, int w, int pri_y,
                               int sec_y, int pri_uv, int sec_uv,
                               int damping, int coeff_shift, int* oy,
                               int* ou, int* ov, cudaStream_t stream) {
  const dim3 grid(((w >> 3) + TC - 1) / TC, ((h >> 3) + TR - 1) / TR);
  cdef_kernel<<<grid, NT, 0, stream>>>(
      y, u, v, skip8, weights, h, w, pri_y, sec_y, pri_uv, sec_uv, damping,
      coeff_shift, oy, ou, ov);
  return (int)cudaGetLastError();
}

// The tile geometry, for kernels/cdef.py:cdef_layout to check its mirror
// against: out = {units per tile in rows TR and columns TC, apron rows AR
// and columns AC, luma and chroma stage strides LS and CS (words),
// threads}.
extern "C" int av1_cdef_layout(int* out) {
  const int v[7] = {TR, TC, AR, AC, LS, CS, NT};
  for (int k = 0; k < 7; ++k) out[k] = v[k];
  return 0;
}
