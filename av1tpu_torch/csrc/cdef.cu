// CDEF of one frame with one frame-wide preset, as one kernel for Hopper:
// cdef_filter.
//
// Replaces the jitted CDEF of av1tpu/models/cdef_tpu.py: `cdef_dirs`
// (:73, the per-8x8 direction search as a 0/1 matrix product) and
// `_filter_plane` (:116), which `cdef_tpu` (:173) runs on the three
// planes.  This is not a pallas_call: XLA fused them, where the port's
// eager version issued about 2,000 PyTorch operations per frame, each over
// the whole plane (kernels/cdef.py holds the wrapper and the plain PyTorch
// version, whose arithmetic this kernel repeats).  It runs in the inter
// step's in-loop filter, on the keyframe, and once per preset in the
// keyframe's strength search.  Per 8x8 luma unit that skip8 leaves on:
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
// What bounds it on an H100.  All integer work on a few bytes per pixel: a
// 1088x1920 frame reads its 3.1 M pre-CDEF samples (int32) and writes as
// many, 25 MB, about 7.5 us at 3.35 TB/s; the taps are about 100 integer
// operations per pixel, 0.3 G operations, a small share of the card's
// integer rate.  So it is bound by bytes.
//
// What the design does about it.  One block of 64 threads per 8x8 unit,
// one thread per luma pixel and, for chroma, 16 threads per plane's 4x4
// unit; the taps (a 2-pixel apron) are read from global memory, where a
// neighbouring unit's block reads the same lines through L1/L2.  The
// direction's partial sums are integer atomics in shared memory (exact in
// any order), so the kernel is bit-exact with the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;
constexpr int LARGE = 0x4000;   // CDEF_VERY_LARGE

// spec CdefDirections[dir][k] = (dy, dx)
__constant__ int kDirs[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
    {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},  {{1, 0}, {2, 1}},
    {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}}};
// first bin of each direction in the 90-bin weight row (models/cdef.py
// _NBINS: 15, 11, 8, 11, 15, 11, 8, 11)
__constant__ int kBinOff[9] = {0, 15, 26, 34, 45, 60, 71, 79, 90};

// the bin of pixel (i, j) of an 8x8 block in direction d (spec 7.15.2)
__device__ __forceinline__ int bin_of(int d, int i, int j) {
  switch (d) {
    case 0: return i + j;
    case 1: return i + (j >> 1);
    case 2: return i;
    case 3: return 3 + i - (j >> 1);
    case 4: return 7 + i - j;
    case 5: return 3 - (i >> 1) + j;
    case 6: return j;
    default: return (i >> 1) + j;
  }
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

// One filtered sample of plane (h, w) at (Y, X): direction d, primary
// strength pri with tap parity par, secondary strength sec, damping.
__device__ int filter_px(const int* __restrict__ plane, int h, int w, int Y,
                         int X, int d, int pri, int par, int sec,
                         int damping) {
  const int px = plane[(size_t)Y * w + X];
  const int pt[2] = {4 - par, 2 + par}, st[2] = {2, 1};
  const int damp_pri = max(damping - floor_log2(pri), 0);
  const int damp_sec = max(damping - floor_log2(sec), 0);
  int sum = 0, mn = px, mx = px;
  for (int k = 0; k < 2; ++k) {
    for (int o = 0; o < 3; ++o) {           // primary, then +2 and +6
      const int dd = o == 0 ? d : (d + (o == 1 ? 2 : 6)) & 7;
      const int dy = kDirs[dd][k][0], dx = kDirs[dd][k][1];
      for (int s = 1; s >= -1; s -= 2) {
        const int yy = Y + s * dy, xx = X + s * dx;
        const int p = (yy >= 0 && yy < h && xx >= 0 && xx < w)
            ? plane[(size_t)yy * w + xx] : LARGE;
        sum += o == 0 ? pt[k] * constrain(p - px, pri, damp_pri)
                      : st[k] * constrain(p - px, sec, damp_sec);
        mn = min(mn, p);
        mx = max(mx, p == LARGE ? -1 : p);
      }
    }
  }
  const int out = px + ((8 + sum - (sum < 0 ? 1 : 0)) >> 4);
  return min(max(out, mn), mx);
}

__global__ void __launch_bounds__(NT) cdef_kernel(
    const int* __restrict__ y, const int* __restrict__ u,
    const int* __restrict__ v, const unsigned char* __restrict__ skip8,
    const int* __restrict__ weights, int h, int w, int pri_y, int sec_y,
    int pri_uv, int sec_uv, int damping, int cs, int* oy, int* ou,
    int* ov) {
  __shared__ int s_part[90];
  __shared__ int s_cost[8];
  __shared__ int s_dir, s_var;
  const int unit = blockIdx.x, nbc = w >> 3;
  const int br = unit / nbc, bc = unit % nbc;
  const int t = threadIdx.x, i = t >> 3, j = t & 7;
  const int Y = br * 8 + i, X = bc * 8 + j;
  const int hc = h >> 1, wc = w >> 1;
  // chroma: threads 0-15 the U unit's 4x4, 16-31 the V unit's
  const int* cp = t < 16 ? u : v;
  int* co = t < 16 ? ou : ov;
  const size_t cidx = (size_t)(br * 4 + ((t & 15) >> 2)) * wc + bc * 4 + (t & 3);
  const int px = y[(size_t)Y * w + X];
  const bool luma_on = pri_y > 0 || sec_y > 0;
  const bool chroma_on = pri_uv > 0 || sec_uv > 0;
  if (skip8[unit]) {
    oy[(size_t)Y * w + X] = px;
    if (t < 32) co[cidx] = cp[cidx];
    return;
  }

  int dir = 0, var = 0;
  if (pri_y > 0 || pri_uv > 0) {
    if (t < 90 - NT) s_part[NT + t] = 0;
    s_part[t] = 0;
    __syncthreads();
    const int val = (px >> cs) - 128;
    for (int d = 0; d < 8; ++d) atomicAdd(&s_part[kBinOff[d] + bin_of(d, i, j)],
                                          val);
    __syncthreads();
    if (t < 8) {
      unsigned int c = 0;
      for (int b = kBinOff[t]; b < kBinOff[t + 1]; ++b)
        c += (unsigned int)(s_part[b] * s_part[b]) * (unsigned int)weights[b];
      s_cost[t] = (int)c;
    }
    __syncthreads();
    if (t == 0) {
      int best = 0;
      for (int d = 1; d < 8; ++d)
        if (s_cost[d] > s_cost[best]) best = d;
      s_dir = best;
      s_var = (int)((unsigned int)s_cost[best]
                    - (unsigned int)s_cost[best ^ 4]) >> 10;
    }
    __syncthreads();
    dir = s_dir;
    var = s_var;
  }

  if (luma_on) {
    const int v6 = var >> 6;
    const int ii = v6 > 0 ? min(floor_log2(v6), 12) : 0;
    const int pri = var > 0 ? ((pri_y << cs) * (4 + ii) + 8) >> 4 : 0;
    oy[(size_t)Y * w + X] = filter_px(
        y, h, w, Y, X, dir, pri, (pri >> cs) & 1,
        (sec_y + (sec_y == 3 ? 1 : 0)) << cs, damping + cs);
  } else {
    oy[(size_t)Y * w + X] = px;
  }
  if (t < 32) {
    if (chroma_on) {
      co[cidx] = filter_px(cp, hc, wc, (int)(cidx / wc), (int)(cidx % wc),
                           dir, pri_uv << cs, pri_uv & 1,
                           (sec_uv + (sec_uv == 3 ? 1 : 0)) << cs,
                           damping - 1 + cs);
    } else {
      co[cidx] = cp[cidx];
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
  cdef_kernel<<<(h >> 3) * (w >> 3), NT, 0, stream>>>(
      y, u, v, skip8, weights, h, w, pri_y, sec_y, pri_uv, sec_uv, damping,
      coeff_shift, oy, ou, ov);
  return (int)cudaGetLastError();
}
