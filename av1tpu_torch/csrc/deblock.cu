// One direction of the in-loop deblocking filter on one plane, as one
// kernel for Hopper: deblock_edges.
//
// Replaces the jitted loop filter of av1tpu/models/deblock_tpu.py:
// `deblock_planes` (:394) with `_deblock_plane_v` (:324),
// `_deblock_interior_v` (:293) and the filters `_filter_luma_lines` (:68),
// `_filter_chroma_lines` (:165), `_filter_luma8_lines` (:216) and
// `_filter_chroma4_lines` (:264).  This is not a pallas_call: XLA fused
// them, where the port's eager version issued about 300 PyTorch
// operations per plane and direction, each over the whole plane
// (kernels/deblock.py holds the wrapper and the plain PyTorch version,
// whose arithmetic this kernel repeats).  It runs after every inter step,
// on the fast keyframe and wherever a keyframe's levels are not 0.
//
// What it computes, per line across the edges of one direction (vertical
// edges: each pixel row; horizontal edges: each pixel column):
//
// - every block edge (16 px luma, 8 px chroma) that edge_on enables: the
//   14/8/4-tap chain (luma) or the 6/4-tap chain (chroma), capped at 8 or
//   4 taps where split16 marks either side;
// - where split16 marks a block, its interior edge at the 8 px (luma) or
//   4 px (chroma) offset: the 8/4-tap chain (luma) or the 4-tap chain.
//
// Why one pass in any order is exact: the plain version filters the
// interior edges first and then the block edges, each from the plane as
// the earlier pass left it.  A capped block edge reads p3..q3 and writes
// p2..q2, which no interior edge touches; its wider taps p6..p4 and q4..q6,
// which an interior edge may have changed, feed only the 14-tap mask,
// which the cap turns off.  A chroma block edge's p2/q2 likewise feed only
// the 6-tap terms, which the cap turns off.  So every edge can be filtered
// from the direction's input, and a pixel takes the value of the edge that
// actually modifies it.
//
// What bounds it on an H100.  All integer work on 4 bytes per pixel: a
// 1088x1920 luma plane is read once and written once per direction,
// 16.7 MB, about 5 us at 3.35 TB/s; the filters are a few hundred integer
// operations per edge and line, a small share of the card's integer rate.
// So it is bound by bytes.
//
// What the design does about it.  One thread per (line, block): it loads
// the block's samples and the taps of both its edges (30 samples luma, 14
// chroma) into registers, applies the interior edge, then the q side of
// the block's first edge and the p side of its last, and writes the block
// once.  Each edge is computed by the two threads that share it (twice the
// integer work, none of it in memory).  On horizontal edges neighbouring
// threads take neighbouring columns, so every load and store is coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;

struct Thr {
  int limit, blimit, thresh, F, mx;
};

__device__ __forceinline__ int r2(int x, int n) {
  return (x + (1 << (n - 1))) >> n;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// the 4-tap filter's outputs (models/deblock.py:_narrow)
__device__ __forceinline__ void narrow(int p1, int p0, int q0, int q1,
                                       const Thr& t, int& np1, int& np0,
                                       int& nq0, int& nq1) {
  const bool hev = abs(p1 - p0) > t.thresh * t.F ||
                   abs(q1 - q0) > t.thresh * t.F;
  const int lo = -128 * t.F, hi = 128 * t.F - 1;
  int fil = hev ? clampi(p1 - q1, lo, hi) : 0;
  fil = clampi(fil + 3 * (q0 - p0), lo, hi);
  const int f1 = clampi(fil + 4, lo, hi) >> 3;
  const int f2 = clampi(fil + 3, lo, hi) >> 3;
  nq0 = clampi(q0 - f1, 0, t.mx);
  np0 = clampi(p0 + f2, 0, t.mx);
  const int f3 = r2(f1, 1);
  nq1 = hev ? q1 : clampi(q1 - f3, 0, t.mx);
  np1 = hev ? p1 : clampi(p1 + f3, 0, t.mx);
}

// x: p3..q3 at x[0..7].  The filter mask and flat of the 8-tap chain.
__device__ __forceinline__ bool mask8(const int* x, const Thr& t) {
  const int p3 = x[0], p2 = x[1], p1 = x[2], p0 = x[3];
  const int q0 = x[4], q1 = x[5], q2 = x[6], q3 = x[7];
  const int L = t.limit * t.F;
  return abs(p1 - p0) <= L && abs(q1 - q0) <= L &&
         abs(p0 - q0) * 2 + (abs(p1 - q1) >> 1) <= t.blimit * t.F &&
         abs(p2 - p1) <= L && abs(q2 - q1) <= L && abs(p3 - p2) <= L &&
         abs(q3 - q2) <= L;
}

__device__ __forceinline__ bool flat8(const int* x, int F) {
  const int p3 = x[0], p2 = x[1], p1 = x[2], p0 = x[3];
  const int q0 = x[4], q1 = x[5], q2 = x[6], q3 = x[7];
  return abs(p1 - p0) <= F && abs(q1 - q0) <= F && abs(p2 - p0) <= F &&
         abs(q2 - q0) <= F && abs(p3 - p0) <= F && abs(q3 - q0) <= F;
}

// The 8/4-tap luma chain (models/deblock.py:_filter_luma8_lines).
// x: p3..q3; o: p2..q2.
__device__ __forceinline__ void luma8(const int* x, const Thr& t, int* o) {
  const int p3 = x[0], p2 = x[1], p1 = x[2], p0 = x[3];
  const int q0 = x[4], q1 = x[5], q2 = x[6], q3 = x[7];
  const bool fm = mask8(x, t);
  int np1, np0, nq0, nq1;
  narrow(p1, p0, q0, q1, t, np1, np0, nq0, nq1);
  const bool m8 = fm && flat8(x, t.F);
  if (m8) {
    o[0] = r2(p3 * 3 + p2 * 2 + p1 + p0 + q0, 3);
    o[1] = r2(p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1, 3);
    o[2] = r2(p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2, 3);
    o[3] = r2(p2 + p1 + p0 + q0 * 2 + q1 + q2 + q3, 3);
    o[4] = r2(p1 + p0 + q0 + q1 * 2 + q2 + q3 * 2, 3);
    o[5] = r2(p0 + q0 + q1 + q2 * 2 + q3 * 3, 3);
  } else if (fm) {
    o[0] = p2; o[1] = np1; o[2] = np0; o[3] = nq0; o[4] = nq1; o[5] = q2;
  } else {
    o[0] = p2; o[1] = p1; o[2] = p0; o[3] = q0; o[4] = q1; o[5] = q2;
  }
}

// The 14/8/4-tap luma chain (models/deblock.py:_filter_luma_lines).
// x: p6..q6; o: p5..q5; allow14 false caps it at 8 taps.
__device__ __forceinline__ void luma14(const int* x, bool allow14,
                                       const Thr& t, int* o) {
  const int p6 = x[0], p5 = x[1], p4 = x[2];
  const int q4 = x[11], q5 = x[12], q6 = x[13];
  const int* c = x + 3;       // p3..q3
  const int p3 = c[0], p2 = c[1], p1 = c[2], p0 = c[3];
  const int q0 = c[4], q1 = c[5], q2 = c[6], q3 = c[7];
  const int F = t.F;
  const bool fm = mask8(c, t);
  const bool m8 = fm && flat8(c, F);
  const bool flat2 = abs(p4 - p0) <= F && abs(q4 - q0) <= F &&
                     abs(p5 - p0) <= F && abs(q5 - q0) <= F &&
                     abs(p6 - p0) <= F && abs(q6 - q0) <= F;
  if (m8 && flat2 && allow14) {
    o[0] = r2(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0, 4);
    o[1] = r2(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1,
              4);
    o[2] = r2(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1
              + q2, 4);
    o[3] = r2(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1
              + q2 + q3, 4);
    o[4] = r2(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1
              + q2 + q3 + q4, 4);
    o[5] = r2(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2
              + q3 + q4 + q5, 4);
    o[6] = r2(q6 + q5 + q4 + q3 + q2 + q1 * 2 + q0 * 2 + p0 * 2 + p1 + p2
              + p3 + p4 + p5, 4);
    o[7] = r2(q6 * 2 + q5 + q4 + q3 + q2 * 2 + q1 * 2 + q0 * 2 + p0 + p1
              + p2 + p3 + p4, 4);
    o[8] = r2(q6 * 3 + q5 + q4 + q3 * 2 + q2 * 2 + q1 * 2 + q0 + p0 + p1
              + p2 + p3, 4);
    o[9] = r2(q6 * 4 + q5 + q4 * 2 + q3 * 2 + q2 * 2 + q1 + q0 + p0 + p1
              + p2, 4);
    o[10] = r2(q6 * 5 + q5 * 2 + q4 * 2 + q3 * 2 + q2 + q1 + q0 + p0 + p1,
               4);
    o[11] = r2(q6 * 7 + q5 * 2 + q4 * 2 + q3 + q2 + q1 + q0 + p0, 4);
    return;
  }
  o[0] = p5; o[1] = p4; o[2] = p3;
  o[9] = q3; o[10] = q4; o[11] = q5;
  luma8(c, t, o + 3);
}

// The 6/4-tap chroma chain (models/deblock.py:_filter_chroma_lines).
// x: p2..q2; o: p1..q1; allow6 false caps it at 4 taps (and drops the
// p2/q2 terms from the mask).
__device__ __forceinline__ void chroma6(const int* x, bool allow6,
                                        const Thr& t, int* o) {
  const int p2 = x[0], p1 = x[1], p0 = x[2], q0 = x[3], q1 = x[4],
            q2 = x[5];
  const int L = t.limit * t.F, F = t.F;
  bool fm = abs(p1 - p0) <= L && abs(q1 - q0) <= L &&
            abs(p0 - q0) * 2 + (abs(p1 - q1) >> 1) <= t.blimit * t.F;
  if (allow6) fm = fm && abs(p2 - p1) <= L && abs(q2 - q1) <= L;
  const bool flat = abs(p1 - p0) <= F && abs(q1 - q0) <= F &&
                    abs(p2 - p0) <= F && abs(q2 - q0) <= F;
  if (fm && flat && allow6) {
    o[0] = r2(p2 * 3 + p1 * 2 + p0 * 2 + q0, 3);
    o[1] = r2(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1, 3);
    o[2] = r2(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2, 3);
    o[3] = r2(p0 + q0 * 2 + q1 * 2 + q2 * 3, 3);
  } else if (fm) {
    narrow(p1, p0, q0, q1, t, o[0], o[1], o[2], o[3]);
  } else {
    o[0] = p1; o[1] = p0; o[2] = q0; o[3] = q1;
  }
}

// The 4-tap chroma chain (models/deblock.py:_filter_chroma4_lines).
// x: p1..q1; o: p1..q1.
__device__ __forceinline__ void chroma4(const int* x, const Thr& t, int* o) {
  const int p1 = x[0], p0 = x[1], q0 = x[2], q1 = x[3];
  const bool fm = abs(p1 - p0) <= t.limit * t.F &&
                  abs(q1 - q0) <= t.limit * t.F &&
                  abs(p0 - q0) * 2 + (abs(p1 - q1) >> 1) <= t.blimit * t.F;
  if (fm) {
    narrow(p1, p0, q0, q1, t, o[0], o[1], o[2], o[3]);
  } else {
    o[0] = p1; o[1] = p0; o[2] = q0; o[3] = q1;
  }
}

// NB: block size along the line (16 luma, 8 chroma); TAPS: samples read on
// each side of a block edge (7 luma, 3 chroma).
template <int NB, int TAPS>
__global__ void __launch_bounds__(NT) deblock_kernel(
    const int* __restrict__ in, int* __restrict__ out, int h, int w,
    const unsigned char* __restrict__ edge_on,
    const unsigned char* __restrict__ split16, int vertical, Thr t) {
  constexpr int WL = NB + 2 * TAPS;
  const bool luma = NB == 16;
  // lines and blocks along a line; the block grid has `cols` columns
  const int cols = w / NB;
  const int nlines = vertical ? h : w, len = vertical ? w : h;
  const int nb = len / NB;
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= nlines * nb) return;
  int L, b;
  if (vertical) {            // neighbouring threads: neighbouring blocks
    b = idx % nb;
    L = idx / nb;
  } else {                   // neighbouring threads: neighbouring columns
    L = idx % nlines;
    b = idx / nlines;
  }
  const int R = vertical ? L / NB : b, C = vertical ? b : L / NB;
  const size_t lstride = vertical ? 1 : (size_t)w;
  const size_t lbase = vertical ? (size_t)L * w : (size_t)L;
  const int base = b * NB;

  int x[WL];
#pragma unroll
  for (int k = 0; k < WL; ++k) {
    const int p = clampi(base - TAPS + k, 0, len - 1);
    x[k] = in[lbase + (size_t)p * lstride];
  }
  int o[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) o[k] = x[TAPS + k];

  // the 16-grid cell before and after each block edge of this block
  auto cell = [&](int bb) { return vertical ? R * cols + bb : bb * cols + C; };
  auto edge = [&](int bb) {   // the edge between blocks bb - 1 and bb
    return vertical ? edge_on[R * (cols - 1) + bb - 1]
                    : edge_on[(bb - 1) * cols + C];
  };
  const bool split = split16 != nullptr && split16[cell(b)];
  if (split) {                // the interior edge at NB / 2
    if (luma) {
      int e[6];
      luma8(x + TAPS + 4, t, e);
#pragma unroll
      for (int k = 0; k < 6; ++k) o[5 + k] = e[k];
    } else {
      int e[4];
      chroma4(x + TAPS + 2, t, e);
#pragma unroll
      for (int k = 0; k < 4; ++k) o[2 + k] = e[k];
    }
  }
  // the block edge before this block (its q side) and after it (p side)
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int bb = b + side;
    if (bb == 0 || bb == nb || !edge(bb)) continue;
    const bool allow = split16 == nullptr ||
                       !(split16[cell(bb - 1)] || split16[cell(bb)]);
    const int* win = x + side * NB;   // p(TAPS-1)..q(TAPS-1) of that edge
    if (luma) {
      int e[12];
      luma14(win, allow, t, e);
      const int m = allow ? 6 : 3;   // capped: p2..q2 only
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        if (k >= m) continue;
        if (side == 0) o[k] = e[6 + k];          // q0..q5
        else o[NB - 1 - k] = e[5 - k];           // p0..p5
      }
    } else {
      int e[4];
      chroma6(win, allow, t, e);
      if (side == 0) { o[0] = e[2]; o[1] = e[3]; }
      else { o[NB - 2] = e[0]; o[NB - 1] = e[1]; }
    }
  }
#pragma unroll
  for (int k = 0; k < NB; ++k)
    out[lbase + (size_t)(base + k) * lstride] = o[k];
}

}  // namespace

// plane (h, w) int32 -> out; edge_on: (rows, cols - 1) for vertical edges,
// (rows - 1, cols) for horizontal ones; split16 (rows, cols) or null.
extern "C" int av1_deblock_edges(const int* in, int* out, int h, int w,
                                 int luma, int vertical,
                                 const unsigned char* edge_on,
                                 const unsigned char* split16, int limit,
                                 int blimit, int thresh, int bit_depth,
                                 cudaStream_t stream) {
  const Thr t{limit, blimit, thresh, 1 << (bit_depth - 8),
              (1 << bit_depth) - 1};
  const int nb = luma ? 16 : 8;
  const int threads = (vertical ? h * (w / nb) : w * (h / nb));
  const int grid = (threads + NT - 1) / NT;
  if (luma)
    deblock_kernel<16, 7><<<grid, NT, 0, stream>>>(in, out, h, w, edge_on,
                                                   split16, vertical, t);
  else
    deblock_kernel<8, 3><<<grid, NT, 0, stream>>>(in, out, h, w, edge_on,
                                                  split16, vertical, t);
  return (int)cudaGetLastError();
}
