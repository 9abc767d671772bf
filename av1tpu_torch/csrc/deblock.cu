// The in-loop deblocking filter of one plane, both directions, as one
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
// edges: each pixel row; horizontal edges: each pixel column), first the
// vertical edges of the whole plane, then the horizontal ones:
//
// - every block edge (16 px luma, 8 px chroma) that edge_on enables: the
//   14/8/4-tap chain (luma) or the 6/4-tap chain (chroma), capped at 8 or
//   4 taps where split16 marks either side;
// - where split16 marks a block, its interior edge at the 8 px (luma) or
//   4 px (chroma) offset: the 8/4-tap chain (luma) or the 4-tap chain.
//
// Why one pass per direction in any order is exact: the plain version
// filters the interior edges first and then the block edges, each from the
// plane as the earlier pass left it.  A capped block edge reads p3..q3 and
// writes p2..q2, which no interior edge touches; its wider taps p6..p4 and
// q4..q6, which an interior edge may have changed, feed only the 14-tap
// mask, which the cap turns off.  A chroma block edge's p2/q2 likewise
// feed only the 6-tap terms, which the cap turns off.  So every edge can
// be filtered from the direction's input, and a pixel takes the value of
// the edge that actually modifies it.
//
// Why a tile with a halo is exact: the horizontal edges of a column of
// 16-px (8-px) blocks read that column's samples from TAPS rows above the
// block to TAPS rows below it (7 luma, 3 chroma), as the vertical pass
// left them, and nothing else.  Filtering a row's vertical edges reads
// only that row, from TAPS columns left of a block to TAPS right of it.
// So a CTA that owns the rows [r0, r0 + TH) and columns [c0, c0 + TW) of
// the output (TH, TW multiples of the block size) loads the input rows
// [r0 - TAPS, r0 + TH + TAPS) and columns [c0 - HL, c0 + TW + HL) (HL:
// TAPS rounded up to whole 16-byte loads), filters the vertical edges of
// every loaded row at its own columns (the halo rows come out exactly as
// the plane-wide pass leaves them), then the horizontal edges of its
// columns, and writes its own rows and columns: every output pixel is
// written by one CTA, from the same values the two plane-wide passes
// would give it.  Rows and columns outside the plane are loaded clamped
// and never read by a filter: the edges at the plane's borders are not
// filtered.
//
// What bounds it on an H100.  All integer work on 4 bytes per pixel: a
// 1088x1920 luma plane read once and written once is 16.7 MB, about 5 us
// at 3.35 TB/s; the filters are a few hundred integer operations per edge
// and line, a small share of the card's integer rate.  So it is bound by
// bytes.  The first version of this kernel took one launch per direction,
// the plane through memory twice each way, and on vertical edges put a
// warp's 32 lanes on 32 blocks of a row, 64 bytes apart: every load and
// store touched 32 sectors (34.8 us against 7.3 us for the horizontal
// pass, each with a 5.0 us bound).
//
// What the design does about it.  One launch per plane (deblock_planes calls
// it once per plane whose level is above 0): a CTA of 288 threads per TH x
// TW tile (luma 48 x 128, chroma 24 x 64), a warp per block boundary of its
// columns (9 of them, its two borders included).  The load is coalesced: a
// warp takes 4 rows of 8 int4s, 128 bytes of each row; the tile sits in
// shared memory at an odd row stride (LW + 1 words), so the 4 x 8 lanes'
// stores, the vertical pass's lanes (32 rows of one edge column) and the
// horizontal pass's lanes (32 neighbouring columns of one row) all fall on
// 32 different banks.  Each edge is filtered once, by one thread, in place:
// the vertical pass takes an item per (row, block boundary k of the tile,
// its borders included), the block edge there and the interior edge of block
// k, a warp per k and 32 rows (two passes of the CTA over luma's 62 loaded
// rows, one over chroma's 30); the horizontal pass an item per (column,
// block-row boundary).  In place needs no barrier within a pass: by the
// exactness argument above every edge's effective inputs are samples that no
// other edge writes, and the samples two edges write are disjoint (a capped
// edge writes p2..q2 only).  A first fused version gave a thread a whole
// block and both its edges, so every block edge was computed twice; the luma
// plane then took 16.7 us, about the two one-direction passes' integer work.
// Even now that work, not the bytes, is what luma's time follows (PERF.md).
// Last, the tile's own pixels go out as int4 stores, a warp's 4 rows of 128
// bytes each.  The edge and split maps (one byte per 16-grid edge or block)
// go through the read-only cache.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// One block edge of a line, in place: its samples p(TAPS-1)..q(TAPS-1)
// at x[k * step], k < 2 TAPS.  Luma: the 14/8/4-tap chain, capped at 8
// taps unless allow; it writes p5..q5 (capped: p2..q2, the samples a capped
// edge may change).  Chroma: the 6/4-tap chain, p1..q1.
template <int TAPS>
__device__ __forceinline__ void block_edge(int* x, int step, bool allow,
                                           const Thr& t) {
  int v[2 * TAPS];
#pragma unroll
  for (int k = 0; k < 2 * TAPS; ++k) v[k] = x[k * step];
  if constexpr (TAPS == 7) {
    int e[12];
    luma14(v, allow, t, e);
    const int m = allow ? 6 : 3;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if (k >= m) continue;
      x[(TAPS - 1 - k) * step] = e[5 - k];      // p_k
      x[(TAPS + k) * step] = e[6 + k];          // q_k
    }
  } else {
    int e[4];
    chroma6(v, allow, t, e);
#pragma unroll
    for (int k = 0; k < 4; ++k) x[(TAPS - 2 + k) * step] = e[k];
  }
}

// The interior edge of a split block, in place; x: its q0 at x[0].  Luma
// the 8/4-tap chain on p3..q3, writing p2..q2; chroma the 4-tap chain on
// p1..q1.
template <int TAPS>
__device__ __forceinline__ void interior_edge(int* x, int step,
                                              const Thr& t) {
  if constexpr (TAPS == 7) {
    int v[8], e[6];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = x[(k - 4) * step];
    luma8(v, t, e);
#pragma unroll
    for (int k = 0; k < 6; ++k) x[(k - 3) * step] = e[k];
  } else {
    int v[4], e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = x[(k - 2) * step];
    chroma4(v, t, e);
#pragma unroll
    for (int k = 0; k < 4; ++k) x[(k - 2) * step] = e[k];
  }
}

// The tile of one CTA: TH_ x TW_ output pixels, NB_ the block size along
// a line, TAPS_ the samples read on each side of a block edge.
// kernels/deblock.py:deblock_layout mirrors these numbers.
template <int NB_, int TAPS_, int TH_, int TW_>
struct Tile {
  static constexpr int NB = NB_, TAPS = TAPS_, TH = TH_, TW = TW_;
  // a warp per block boundary of the tile's columns, its borders included
  static constexpr int NT = 32 * (TW / NB + 1);
  static constexpr int HL = (TAPS + 3) / 4 * 4;  // halo columns: whole int4s
  static constexpr int RH = TH + 2 * TAPS;       // rows with the halo
  static constexpr int RHP = (RH + 31) / 32 * 32;  // a warp's 32 rows
  static constexpr int LW = TW + 2 * HL;         // loaded columns
  static constexpr int S = LW + 1;               // row stride, odd (words)
  static constexpr int G = LW / 4;               // int4s per loaded row
  static constexpr int GC = (G + 7) / 8;         // a warp's 8 int4s a row
  static constexpr size_t SMEM = (size_t)RH * S * sizeof(int);
  static_assert(TH % NB == 0 && TW % 32 == 0 && S % 2 == 1, "deblock tile");
};

// luma: 16-px blocks, 7 taps, 48 x 128 tiles; chroma: 8, 3, 24 x 64
using LumaTile = Tile<16, 7, 48, 128>;
using ChromaTile = Tile<8, 3, 24, 64>;

template <class L>
__global__ void __launch_bounds__(L::NT) deblock_kernel(
    const int* __restrict__ in, int* __restrict__ out, int h, int w,
    const unsigned char* __restrict__ v_on,
    const unsigned char* __restrict__ h_on,
    const unsigned char* __restrict__ split16, Thr t) {
  constexpr int NB = L::NB, TAPS = L::TAPS, TH = L::TH, TW = L::TW,
                NT = L::NT;
  extern __shared__ int s_tile[];              // RH rows of S words
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int thi = min(TH, h - r0), twi = min(TW, w - c0);
  const int rows = h / NB, cols = w / NB;
  const int tid = threadIdx.x;

  // the tile with its halo, clamped to the plane: a warp per 4 rows of 8
  // int4s (4 x 128 contiguous bytes)
  for (int i = tid; i < (L::RH + 3) / 4 * L::GC * 32; i += NT) {
    const int ch = i >> 5, l = i & 31;
    const int rr = ch / L::GC * 4 + (l >> 3), g = ch % L::GC * 8 + (l & 7);
    if (rr >= L::RH || g >= L::G) continue;
    const int y = clampi(r0 - TAPS + rr, 0, h - 1);
    const int x = clampi(c0 - L::HL + 4 * g, 0, w - 4);
    const int4 v = __ldg(reinterpret_cast<const int4*>(in + (size_t)y * w
                                                       + x));
    int* d = s_tile + rr * L::S + 4 * g;
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
  __syncthreads();

  auto split = [&](int R, int C) {
    return split16 != nullptr && split16[(size_t)R * cols + C] != 0;
  };
  // the vertical edges of every loaded row in the plane, in place: item
  // (k, rr) filters row rr's block edge at column k NB of the tile (k = 0
  // and TW / NB on its borders) and the interior edge of block k; a warp
  // takes 32 rows of one k
#pragma unroll 1
  for (int i = tid; i < (TW / NB + 1) * L::RHP; i += NT) {
    const int k = i / L::RHP, rr = i % L::RHP, y = r0 - TAPS + rr;
    if (rr >= L::RH || y < 0 || y >= h || k * NB > twi) continue;
    const int R = y / NB, C = c0 / NB + k;
    int* q0 = s_tile + rr * L::S + L::HL + k * NB;
    if (C > 0 && C < cols && v_on[(size_t)R * (cols - 1) + C - 1])
      block_edge<TAPS>(q0 - TAPS, 1, !(split(R, C - 1) || split(R, C)), t);
    if (k * NB < twi && split(R, C)) interior_edge<TAPS>(q0 + NB / 2, 1, t);
  }
  __syncthreads();

  // the horizontal edges of the tile's columns, in place: item (k, xc)
  // filters column xc's block edge at the top of block row k (k = 0 and
  // TH / NB on the tile's borders) and the interior edge of block row k
#pragma unroll 1
  for (int i = tid; i < (TH / NB + 1) * TW; i += NT) {
    const int k = i / TW, xc = i % TW;
    if (xc >= twi || k * NB > thi) continue;
    const int R = r0 / NB + k, C = (c0 + xc) / NB;
    int* q0 = s_tile + (TAPS + k * NB) * L::S + L::HL + xc;
    if (R > 0 && R < rows && h_on[(size_t)(R - 1) * cols + C])
      block_edge<TAPS>(q0 - TAPS * L::S, L::S,
                       !(split(R - 1, C) || split(R, C)), t);
    if (k * NB < thi && split(R, C))
      interior_edge<TAPS>(q0 + NB / 2 * L::S, L::S, t);
  }
  __syncthreads();

  // the tile's own pixels out: a warp per 4 rows of 8 int4s
  for (int i = tid; i < TH / 4 * (TW / 32) * 32; i += NT) {
    const int ch = i >> 5, l = i & 31;
    const int rr = ch / (TW / 32) * 4 + (l >> 3);
    const int g = ch % (TW / 32) * 8 + (l & 7);
    if (rr >= thi || 4 * g >= twi) continue;
    const int* src = s_tile + (TAPS + rr) * L::S + L::HL + 4 * g;
    *reinterpret_cast<int4*>(out + (size_t)(r0 + rr) * w + c0 + 4 * g) =
        make_int4(src[0], src[1], src[2], src[3]);
  }
}

template <class L>
int launch(const int* in, int* out, int h, int w, const unsigned char* v_on,
           const unsigned char* h_on, const unsigned char* split16,
           const Thr& t, cudaStream_t stream) {
  auto kernel = deblock_kernel<L>;
  if (L::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((w + L::TW - 1) / L::TW, (h + L::TH - 1) / L::TH);
  kernel<<<grid, L::NT, L::SMEM, stream>>>(in, out, h, w, v_on, h_on,
                                           split16, t);
  return (int)cudaGetLastError();
}

template <class L>
void layout(int* out) {
  out[0] = L::TH; out[1] = L::TW; out[2] = L::TAPS; out[3] = L::HL;
  out[4] = L::S; out[5] = (int)L::SMEM; out[6] = L::NT;
}

}  // namespace

// plane (h, w) int32 -> out (not the same memory, 16-byte aligned);
// v_on: (rows, cols - 1), h_on: (rows - 1, cols) edges of the block grid;
// split16 (rows, cols) or null.
extern "C" int av1_deblock_edges(const int* in, int* out, int h, int w,
                                 int luma, const unsigned char* v_on,
                                 const unsigned char* h_on,
                                 const unsigned char* split16, int limit,
                                 int blimit, int thresh, int bit_depth,
                                 cudaStream_t stream) {
  const Thr t{limit, blimit, thresh, 1 << (bit_depth - 8),
              (1 << bit_depth) - 1};
  return luma ? launch<LumaTile>(in, out, h, w, v_on, h_on, split16, t,
                                 stream)
              : launch<ChromaTile>(in, out, h, w, v_on, h_on, split16, t,
                                   stream);
}

// The tile geometry of luma (1) or chroma (0), for
// kernels/deblock.py:deblock_layout to check its mirror against: out = {TH,
// TW, TAPS, HL, row stride S (words), dynamic shared bytes, threads}.
extern "C" int av1_deblock_layout(int luma, int* out) {
  if (luma) layout<LumaTile>(out);
  else layout<ChromaTile>(out);
  return 0;
}
