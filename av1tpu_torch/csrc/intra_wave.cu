// The wavefront keyframe's diagonal step as two kernels for Hopper.
//
// Replaces the jitted step of av1tpu/models/intra_wave.py (`step`, :383,
// lax.scan'ned over the anti-diagonals d = 2r + c at :569).  This is not a
// pallas_call: XLA fused the step into a few device programs per diagonal,
// where the port's eager loop issued about 16,600 PyTorch operations.  One
// diagonal is now two launches (kernels/intra_wave.py holds the wrappers
// and the plain PyTorch versions, whose arithmetic these kernels repeat):
//
// - wave_luma16: per lane (a 16x16 block of the diagonal), the 13
//   WAVE_MODES candidates at TX_16X16: prediction, forward transform
//   (256-term fp32 dot products), deadzone quantize, rd_zero, dequantize,
//   the integer inverse transform, recon clip, SSE and RateModel bits, the
//   D203 mask and the argmin (first index on ties);
// - wave_sub_chroma: per lane, the winner re-coded at TX_8X8 (4 sub-blocks)
//   and TX_4X4 (16) in raster order, each predicted from the sub-blocks
//   reconstructed before it (sub_chain), the tx-depth choice, U and V
//   DC_PRED coded at 8x8 (DCT_DCT), and the write of the lane into the
//   carried recon, level, mode and tx-depth grids.
//
// What bounds it on an H100.  A 1088x1920 keyframe is 254 diagonals of at
// most 60 lanes, and each diagonal depends on the recon of the two before
// it: the floor is a chain of 508 launches, about 1.3 ms at the ~2.5 us a
// launch costs.  The arithmetic is about 14 GFLOP of fp32 per keyframe
// (13 candidate 256x256 products per 16x16 block, 8,160 blocks; the 8x8,
// 4x4 and chroma products add under 10%), 0.21 ms at the 67 TFLOP/s fp32
// peak; the bytes (source, carried grids, 1.3 MB of tables) are a few MB.
// So the step is bound by its dependency chain and by the serial work
// inside one lane, not by the card's rates.
//
// What the design does about it.  One thread block of 256 threads per
// valid lane (padded lanes are not launched), so a diagonal is one wave
// of at most 60 blocks: under half of the 132 SMs, a first design that is
// simple and right; splitting the candidates across blocks is later work.
// Thread t owns pixel t and coefficient t of the 16x16 block.  The
// candidates are coded one transform group at a time (at most 4 share a
// forward matrix), so each thread reads its column of the group's matrix
// once from L2 for up to 4 dot products.  The sub-block chains keep their
// group's 8x8 and 4x4 matrices in shared memory, since their 20 steps are
// serial.  Every per-block quantity that the plain version reduces (SSE,
// end of block, bits) is a block reduction whose result every thread
// holds, so the decisions need no extra barrier.
//
// Bits.  The plain version rounds every float operation (PyTorch does not
// contract across operations), so every decision expression here is
// written with __fmul_rn, __fadd_rn, __fsub_rn and IEEE division: nvcc
// would otherwise contract a*b + c into an FMA.  SSE is an exact integer;
// floor(log2(a - 14)) of the rate's large magnitudes is 31 - __clz.  The
// inverse transforms wrap in int32 as the plain version's tensors do
// (unsigned arithmetic, arithmetic shifts).  What cannot match: the
// forward dot products and the rate sum are float32 sums in another order
// than cuBLAS's and PyTorch's, so a level may flip by 1 at a rounding
// boundary and a decision may flip at a near-tie (chip_smoke.py counts
// both).  The candidate's prediction in sub_chain is row sub_pred_row[pick]
// of the WAVE_MODES stack, the reference's row, read from a table.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// kernels/intra_wave.py:WaveTabsC, field for field (outside the anonymous
// namespace: the C entry points take it, and must keep external linkage)
struct WaveTabs {
  const float *fwd16, *fwd8, *fwd4;
  const float* step16; const int *q16, *cap16; const float* off16;
  const float* step8; const int *q8, *cap8; const float* off8;
  const float* step4; const int *q4, *cap4; const float* off4;
  const float* stepc; const int *qc, *capc; const float* offc;
  const float *tab16, *skip16; const int* rank16; const float* eob16;
  const float *tab8, *skip8; const int* rank8; const float* eob8;
  const float *tab4, *skip4; const int* rank4; const float* eob4;
  const float* tabc;
  const float *gain16, *gain8, *gain4, *gainc;
  const float* mode_bits; const int8_t* mode_vals;
  const long long *grp_of_pos, *sub_pred_row;
  const int *sm_w, *pred_dr;
  float lam, lam_txd0, gate;
  int bit_depth;
};

namespace {

typedef unsigned int u32;

constexpr int NT = 256;       // threads per block: one per 16x16 pixel
constexpr int NWARP = NT / 32;
constexpr int NPOS = 13;      // candidates (WAVE_MODES)
constexpr int MAXG = 4;       // candidates of one transform type, at most
constexpr int KEEP_ALWAYS = 8;

// AV1 intra mode values (spec enums)
enum { DC = 0, V = 1, H = 2, D45 = 3, D135 = 4, D113 = 5, D157 = 6,
       D203 = 7, D67 = 8, SMOOTH = 9, SMOOTH_V = 10, SMOOTH_H = 11,
       PAETH = 12 };
// models/intra_wave.py:WAVE_MODES: row of the prediction stack -> mode
__constant__ int kWaveModes[NPOS] = {DC, V, H, D45, D67, SMOOTH, SMOOTH_V,
                                     SMOOTH_H, PAETH, D135, D113, D157,
                                     D203};
// round(cos(i * pi / 128) * 4096), the spec's cos128 table
__constant__ int kCos[65] = {
    4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973, 3948,
    3920, 3889, 3857, 3822, 3784, 3745, 3703, 3659, 3612, 3564, 3513, 3461,
    3406, 3349, 3290, 3229, 3166, 3102, 3035, 2967, 2896, 2824, 2751, 2675,
    2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019, 1931, 1842, 1751, 1660,
    1567, 1474, 1380, 1285, 1189, 1092, 995, 897, 799, 700, 601, 501, 401,
    301, 201, 101, 0};
constexpr int SINPI1 = 1321, SINPI2 = 2482, SINPI3 = 3344, SINPI4 = 3803;
// float32(0.87) and float32(3.66): models/intra_wave.py:_TXD_BITS[1:]
constexpr u32 TXD8_BITS = 0x3f5eb852u, TXD4_BITS = 0x406a3d71u;

// ---- integer inverse transforms (ops/transforms.py), wrapping int32 ----

__device__ __forceinline__ u32 rs(u32 x, int n) {
  return n == 0 ? x : (u32)((int)(x + (1u << (n - 1))) >> n);
}

__device__ __forceinline__ u32 btf(int w0, u32 a, int w1, u32 b) {
  return rs((u32)w0 * a + (u32)w1 * b, 12);
}

#define C(i) kCos[i]

__device__ void idct4(const u32* x, u32* o) {
  u32 b0 = x[0], b1 = x[2], b2 = x[1], b3 = x[3];
  u32 s0 = btf(C(32), b0, C(32), b1), s1 = btf(C(32), b0, -C(32), b1);
  u32 s2 = btf(C(48), b2, -C(16), b3), s3 = btf(C(16), b2, C(48), b3);
  o[0] = s0 + s3; o[1] = s1 + s2; o[2] = s1 - s2; o[3] = s0 - s3;
}

__device__ void idct8(const u32* x, u32* o) {
  u32 ev[4] = {x[0], x[2], x[4], x[6]}, e[4];
  idct4(ev, e);
  u32 b4 = x[1], b5 = x[5], b6 = x[3], b7 = x[7];
  u32 s4 = btf(C(56), b4, -C(8), b7), s5 = btf(C(24), b5, -C(40), b6);
  u32 s6 = btf(C(40), b5, C(24), b6), s7 = btf(C(8), b4, C(56), b7);
  u32 t4 = s4 + s5, t5 = s4 - s5, t6 = s7 - s6, t7 = s6 + s7;
  u32 u5 = btf(-C(32), t5, C(32), t6), u6 = btf(C(32), t5, C(32), t6);
  o[0] = e[0] + t7; o[1] = e[1] + u6; o[2] = e[2] + u5; o[3] = e[3] + t4;
  o[4] = e[3] - t4; o[5] = e[2] - u5; o[6] = e[1] - u6; o[7] = e[0] - t7;
}

__device__ void idct16(const u32* x, u32* o) {
  u32 ev[8], e[8];
  for (int i = 0; i < 8; ++i) ev[i] = x[2 * i];
  idct8(ev, e);
  u32 b0 = x[1], b1 = x[9], b2 = x[5], b3 = x[13];
  u32 b4 = x[3], b5 = x[11], b6 = x[7], b7 = x[15];
  u32 s8 = btf(C(60), b0, -C(4), b7), s9 = btf(C(28), b1, -C(36), b6);
  u32 s10 = btf(C(44), b2, -C(20), b5), s11 = btf(C(12), b3, -C(52), b4);
  u32 s12 = btf(C(52), b3, C(12), b4), s13 = btf(C(20), b2, C(44), b5);
  u32 s14 = btf(C(36), b1, C(28), b6), s15 = btf(C(4), b0, C(60), b7);
  u32 t8 = s8 + s9, t9 = s8 - s9, t10 = s11 - s10, t11 = s10 + s11;
  u32 t12 = s12 + s13, t13 = s12 - s13, t14 = s15 - s14, t15 = s14 + s15;
  u32 u9 = btf(-C(16), t9, C(48), t14), u10 = btf(-C(48), t10, -C(16), t13);
  u32 u13 = btf(-C(16), t10, C(48), t13), u14 = btf(C(48), t9, C(16), t14);
  u32 v8 = t8 + t11, v9 = u9 + u10, v10 = u9 - u10, v11 = t8 - t11;
  u32 v12 = t15 - t12, v13 = u14 - u13, v14 = u13 + u14, v15 = t12 + t15;
  u32 w10 = btf(-C(32), v10, C(32), v13), w11 = btf(-C(32), v11, C(32), v12);
  u32 w12 = btf(C(32), v11, C(32), v12), w13 = btf(C(32), v10, C(32), v13);
  u32 odd[8] = {v15, v14, w13, w12, w11, w10, v9, v8};
  for (int i = 0; i < 8; ++i) {
    o[i] = e[i] + odd[i];
    o[8 + i] = e[7 - i] - odd[7 - i];
  }
}

__device__ void iadst4(const u32* x, u32* o) {
  u32 x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
  u32 s0 = (u32)SINPI1 * x0 + (u32)SINPI4 * x2 + (u32)SINPI2 * x3;
  u32 s1 = (u32)SINPI2 * x0 - (u32)SINPI1 * x2 - (u32)SINPI4 * x3;
  u32 s3b = (u32)SINPI3 * x1;
  u32 s2 = (u32)SINPI3 * (x0 - x2 + x3);
  o[0] = rs(s0 + s3b, 12); o[1] = rs(s1 + s3b, 12); o[2] = rs(s2, 12);
  o[3] = rs(s0 + s1 - s3b, 12);
}

__device__ void iadst8(const u32* x, u32* o) {
  u32 b[8] = {x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]};
  u32 s0 = btf(C(4), b[0], C(60), b[1]), s1 = btf(C(60), b[0], -C(4), b[1]);
  u32 s2 = btf(C(20), b[2], C(44), b[3]), s3 = btf(C(44), b[2], -C(20), b[3]);
  u32 s4 = btf(C(36), b[4], C(28), b[5]), s5 = btf(C(28), b[4], -C(36), b[5]);
  u32 s6 = btf(C(52), b[6], C(12), b[7]), s7 = btf(C(12), b[6], -C(52), b[7]);
  u32 t0 = s0 + s4, t1 = s1 + s5, t2 = s2 + s6, t3 = s3 + s7;
  u32 t4 = s0 - s4, t5 = s1 - s5, t6 = s2 - s6, t7 = s3 - s7;
  u32 u4 = btf(C(16), t4, C(48), t5), u5 = btf(C(48), t4, -C(16), t5);
  u32 u6 = btf(-C(48), t6, C(16), t7), u7 = btf(C(16), t6, C(48), t7);
  u32 v0 = t0 + t2, v1 = t1 + t3, v2 = t0 - t2, v3 = t1 - t3;
  u32 v4 = u4 + u6, v5 = u5 + u7, v6 = u4 - u6, v7 = u5 - u7;
  u32 w2 = btf(C(32), v2, C(32), v3), w3 = btf(C(32), v2, -C(32), v3);
  u32 w6 = btf(C(32), v6, C(32), v7), w7 = btf(C(32), v6, -C(32), v7);
  o[0] = v0; o[1] = 0u - v4; o[2] = w6; o[3] = 0u - w2;
  o[4] = w3; o[5] = 0u - w7; o[6] = v5; o[7] = 0u - v1;
}

__device__ void iadst16(const u32* x, u32* o) {
  u32 b[16] = {x[15], x[0], x[13], x[2], x[11], x[4], x[9], x[6],
               x[7], x[8], x[5], x[10], x[3], x[12], x[1], x[14]};
  const int ang[8] = {2, 10, 18, 26, 34, 42, 50, 58};
  u32 s[16];
  for (int i = 0; i < 8; ++i) {
    int a = ang[i];   // cos128 of a and 64 - a, both in [0, 64]
    s[2 * i] = btf(C(a), b[2 * i], C(64 - a), b[2 * i + 1]);
    s[2 * i + 1] = btf(C(64 - a), b[2 * i], -C(a), b[2 * i + 1]);
  }
  u32 t[16];
  for (int i = 0; i < 8; ++i) {
    t[i] = s[i] + s[i + 8];
    t[8 + i] = s[i] - s[i + 8];
  }
  u32 u[16];
  for (int i = 0; i < 8; ++i) u[i] = t[i];
  u[8] = btf(C(8), t[8], C(56), t[9]);
  u[9] = btf(C(56), t[8], -C(8), t[9]);
  u[10] = btf(C(40), t[10], C(24), t[11]);
  u[11] = btf(C(24), t[10], -C(40), t[11]);
  u[12] = btf(-C(56), t[12], C(8), t[13]);
  u[13] = btf(C(8), t[12], C(56), t[13]);
  u[14] = btf(-C(24), t[14], C(40), t[15]);
  u[15] = btf(C(40), t[14], C(24), t[15]);
  u32 v[16];
  for (int i = 0; i < 4; ++i) {
    v[i] = u[i] + u[i + 4];
    v[4 + i] = u[i] - u[i + 4];
    v[8 + i] = u[8 + i] + u[12 + i];
    v[12 + i] = u[8 + i] - u[12 + i];
  }
  u32 w[16];
  for (int i = 0; i < 16; ++i) w[i] = v[i];
  for (int k = 4; k < 16; k += 8) {
    w[k] = btf(C(16), v[k], C(48), v[k + 1]);
    w[k + 1] = btf(C(48), v[k], -C(16), v[k + 1]);
    w[k + 2] = btf(-C(48), v[k + 2], C(16), v[k + 3]);
    w[k + 3] = btf(C(16), v[k + 2], C(48), v[k + 3]);
  }
  u32 y[16];
  for (int k = 0; k < 16; k += 4) {
    y[k] = w[k] + w[k + 2];
    y[k + 1] = w[k + 1] + w[k + 3];
    y[k + 2] = w[k] - w[k + 2];
    y[k + 3] = w[k + 1] - w[k + 3];
  }
  u32 z[16];
  for (int i = 0; i < 16; ++i) z[i] = y[i];
  for (int i = 2; i < 16; i += 4) {
    z[i] = btf(C(32), y[i], C(32), y[i + 1]);
    z[i + 1] = btf(C(32), y[i], -C(32), y[i + 1]);
  }
  const int perm[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
  for (int i = 0; i < 16; ++i)
    o[i] = (i & 1) ? 0u - z[perm[i]] : z[perm[i]];
}

#undef C

// one 1-D inverse of length n (4, 8 or 16), DCT or ADST
__device__ void inv1d(int n, bool adst, const u32* x, u32* o) {
  if (n == 4) {
    if (adst) iadst4(x, o); else idct4(x, o);
  } else if (n == 8) {
    if (adst) iadst8(x, o); else idct8(x, o);
  } else {
    if (adst) iadst16(x, o); else idct16(x, o);
  }
}

// The 2-D inverse of ops/transforms.py:_inverse_2d on nb n x n blocks in
// shared memory (row-major (h, w) each, stride 256): dq is replaced by the
// residual; tmp is scratch.  tx: DCT_DCT, ADST_DCT (vertical ADST),
// DCT_ADST, ADST_ADST.  Every thread of the block must call it.
__device__ void inverse_2d(int n, int tx, int nb, u32* dq, u32* tmp) {
  const int t = threadIdx.x;
  const int row_shift = n == 4 ? 0 : (n == 8 ? 1 : 2);
  const bool h_adst = tx == 2 || tx == 3, v_adst = tx == 1 || tx == 3;
  u32 in[16], out[16];
  if (t < nb * n) {
    const u32* src = dq + (t / n) * 256 + (t % n) * n;
    u32* dst = tmp + (t / n) * 256 + (t % n) * n;
    for (int k = 0; k < n; ++k) in[k] = src[k];
    inv1d(n, h_adst, in, out);
    for (int k = 0; k < n; ++k) dst[k] = rs(out[k], row_shift);
  }
  __syncthreads();
  if (t < nb * n) {
    const u32* src = tmp + (t / n) * 256 + (t % n);
    u32* dst = dq + (t / n) * 256 + (t % n);
    for (int k = 0; k < n; ++k) in[k] = src[k * n];
    inv1d(n, v_adst, in, out);
    for (int k = 0; k < n; ++k) dst[k * n] = rs(out[k], 4);
  }
  __syncthreads();
}

// ---- prediction (models/intra_wave.py:_predict_modes, one pixel) ----

__device__ __forceinline__ int r2(int x, int n) {
  return (x + (1 << (n - 1))) >> n;
}

// Pixel (i, j) of mode `mode` at size n.  above: 2n samples (above and
// above-right), left: 2n (left and below-left); w: SM_WEIGHTS[n]; dr:
// (dx, dy) per mode value.
__device__ int pred_px(int mode, int n, int i, int j, const int* above,
                       const int* left, int corner, bool ha, bool hl,
                       int base, const int* w, const int* dr) {
  const int last = 2 * n - 1;
  switch (mode) {
    case DC: {
      int sa = 0, sl = 0;
      for (int k = 0; k < n; ++k) {
        sa += above[k];
        sl += left[k];
      }
      const int lg = 31 - __clz(n);
      if (ha && hl) return (sa + sl + n) >> (lg + 1);
      if (ha) return (sa + (n >> 1)) >> lg;
      if (hl) return (sl + (n >> 1)) >> lg;
      return base;
    }
    case V:
      return above[j];
    case H:
      return left[i];
    case PAETH: {
      const int a = above[j], l = left[i];
      const int b = a + l - corner;
      const int pa = abs(b - a), pl = abs(b - l), pc = abs(b - corner);
      if (pa <= pl && pa <= pc) return a;
      return pl <= pc ? l : corner;
    }
    case SMOOTH:
      return r2(w[i] * above[j] + (256 - w[i]) * left[n - 1] +
                    w[j] * left[i] + (256 - w[j]) * above[n - 1], 9);
    case SMOOTH_V:
      return r2(w[i] * above[j] + (256 - w[i]) * left[n - 1], 8);
    case SMOOTH_H:
      return r2(w[j] * left[i] + (256 - w[j]) * above[n - 1], 8);
    case D45:
    case D67:
    case D203: {   // zone 1 on the above edge, zone 3 its transpose
      const bool z3 = mode == D203;
      const int* e = z3 ? left : above;
      const int idx = ((z3 ? j : i) + 1) * dr[2 * mode];
      const int pos = (idx >> 6) + (z3 ? i : j);
      if (pos >= last) return e[last];
      const int sh = (idx >> 1) & 0x1F;
      return r2(e[pos] * (32 - sh) + e[min(pos + 1, last)] * sh, 5);
    }
    default: {     // zone 2 (D113, D135, D157): through the corner
      const int dx = dr[2 * mode], dy = dr[2 * mode + 1];
      const int xi = (j << 6) - (i + 1) * dx;
      if ((xi >> 6) >= -1) {
        const int bx = min(max((xi >> 6) + 1, 0), last);
        const int bx1 = min(bx + 1, last);
        const int sh = (xi >> 1) & 0x1F;
        const int g0 = bx == 0 ? corner : above[bx - 1];
        const int g1 = bx1 == 0 ? corner : above[bx1 - 1];
        return r2(g0 * (32 - sh) + g1 * sh, 5);
      }
      const int yi = (i << 6) - (j + 1) * dy;
      const int by = min(max((yi >> 6) + 1, 0), n);
      const int by1 = min(by + 1, n);
      const int sh = (yi >> 1) & 0x1F;
      const int g0 = by == 0 ? corner : left[by - 1];
      const int g1 = by1 == 0 ? corner : left[by1 - 1];
      return r2(g0 * (32 - sh) + g1 * sh, 5);
    }
  }
}

// models/intra_wave.py:_edges_from_blocks for threads k < n: above2n (2n),
// left (n) and, from thread 0, the corner, with the spec's availability
// substitutions.  rec: (rows, cols, n, n) blocks.  Raw samples are read
// only where they are used.
__device__ void load_edges(const int* rec, int cols, int n, int r, int c,
                           bool ha, bool hl, bool ur_ok, int base,
                           int* above2n, int* left, int* corner) {
  const int k = threadIdx.x;
  if (k >= n) return;
  const int nn = n * n;
  const int rm = max(r - 1, 0), cm = max(c - 1, 0);
  const int cp = min(c + 1, cols - 1);
  const int* up = rec + ((size_t)rm * cols + c) * nn + (n - 1) * n;
  const int* lf = rec + ((size_t)r * cols + cm) * nn + (n - 1);
  const int a_sub = hl ? lf[0] : base - 1;      // above when !ha
  const int ak = ha ? up[k] : a_sub;
  const int a_last = ha ? up[n - 1] : a_sub;
  above2n[k] = ak;
  left[k] = hl ? lf[k * n] : (ha ? up[0] : base + 1);
  above2n[n + k] = (ur_ok && ha)
      ? rec[((size_t)rm * cols + cp) * nn + (n - 1) * n + k] : a_last;
  if (k == 0) {
    *corner = (ha && hl) ? rec[((size_t)rm * cols + cm) * nn + nn - 1]
            : (ha ? up[0] : (hl ? lf[0] : base));
  }
}

// ---- quantize, rd_zero and rate (models/intra_v.py, rdoq.py, rates.py) --

// Deadzone quantize of one coefficient, then rd_zero's keep test.
__device__ int quant_rdz(float coef, float step, int cap, float off, int q,
                         const float* tab, float gain, float lam,
                         float gate) {
  const float ca = fabsf(coef);
  const int mag = (int)floorf(__fadd_rn(__fdiv_rn(ca, step), off));
  const int sgn = coef > 0.f ? 1 : (coef < 0.f ? -1 : 0);
  const int lv = min(max(sgn * mag, -cap), cap);
  const int a = abs(lv);
  if (a == 0 || a >= KEEP_ALWAYS) return lv;
  const float t = __fsub_rn(ca, __fmul_rn((float)a, (float)q));
  const float save = __fmul_rn(gain, __fsub_rn(__fmul_rn(ca, ca),
                                               __fmul_rn(t, t)));
  const float bits = __fsub_rn(tab[a], tab[0]);
  const bool keep = save > __fmul_rn(lam, bits);
  const bool above = __fmul_rn(__fmul_rn(gain, ca), ca) > gate;
  return (keep && above) ? lv : 0;
}

// RateModel's bits of one coded coefficient of magnitude a.
__device__ __forceinline__ float coef_bits(int a, const float* tab) {
  if (a <= 15) return tab[a];
  const int fl = 31 - __clz(a - 14);   // floor(log2(a - 14)), a - 14 >= 2
  return __fadd_rn(__fadd_rn(__fsub_rn(tab[15], 1.0f), (float)(2 * fl)),
                   1.0f);
}

// ---- block reductions: every thread gets the result ----

template <int M>
__device__ void block_sum_i(int* v, int* red) {
  for (int m = 0; m < M; ++m)
    for (int o = 16; o; o >>= 1) v[m] += __shfl_xor_sync(~0u, v[m], o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0)
    for (int m = 0; m < M; ++m) red[(threadIdx.x >> 5) * MAXG + m] = v[m];
  __syncthreads();
  for (int m = 0; m < M; ++m) {
    int s = 0;
    for (int w = 0; w < NWARP; ++w) s += red[w * MAXG + m];
    v[m] = s;
  }
}

template <int M>
__device__ void block_max_i(int* v, int* red) {
  for (int m = 0; m < M; ++m)
    for (int o = 16; o; o >>= 1)
      v[m] = max(v[m], __shfl_xor_sync(~0u, v[m], o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0)
    for (int m = 0; m < M; ++m) red[(threadIdx.x >> 5) * MAXG + m] = v[m];
  __syncthreads();
  for (int m = 0; m < M; ++m) {
    int s = 0;
    for (int w = 0; w < NWARP; ++w) s = max(s, red[w * MAXG + m]);
    v[m] = s;
  }
}

template <int M>
__device__ void block_sum_f(float* v, float* red) {
  for (int m = 0; m < M; ++m)
    for (int o = 16; o; o >>= 1)
      v[m] = __fadd_rn(v[m], __shfl_xor_sync(~0u, v[m], o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0)
    for (int m = 0; m < M; ++m) red[(threadIdx.x >> 5) * MAXG + m] = v[m];
  __syncthreads();
  for (int m = 0; m < M; ++m) {
    float s = 0.f;
    for (int w = 0; w < NWARP; ++w) s = __fadd_rn(s, red[w * MAXG + m]);
    v[m] = s;
  }
}

// RateModel's bits of nb blocks at once from each thread's level of
// coefficient threadIdx.x (lv[m]; threads past the block pass active =
// false): txb_skip, end-of-block position and the coded coefficients.
template <int M>
__device__ void rate_bits(const int* lv, bool active, const float* tab,
                          const float* skip, const int* rank,
                          const float* eob_bits, int* ired, float* fred,
                          float* out) {
  const int rk = active ? rank[threadIdx.x] : 0;
  int eob[M];
  for (int m = 0; m < M; ++m) eob[m] = (active && lv[m] != 0) ? rk + 1 : 0;
  block_max_i<M>(eob, ired);
  float bits[M];
  for (int m = 0; m < M; ++m)
    bits[m] = (active && rk < eob[m]) ? coef_bits(abs(lv[m]), tab) : 0.f;
  block_sum_f<M>(bits, fred);
  for (int m = 0; m < M; ++m)
    out[m] = eob[m] == 0 ? skip[1]
                         : __fadd_rn(__fadd_rn(skip[0], eob_bits[eob[m]]),
                                     bits[m]);
}

// ---- wave_luma16 ----

__global__ void __launch_bounds__(NT) wave_luma16_kernel(
    WaveTabs T, const int* __restrict__ src_y, int width,
    const int* __restrict__ rec_y, const long long* __restrict__ R,
    const long long* __restrict__ Cc, const unsigned char* __restrict__ valid,
    const unsigned char* __restrict__ ur, const unsigned char* __restrict__ bl,
    long long* pick_out, int16_t* lv_out, int* rec_out, float* cost_out,
    long long* grp_out) {
  __shared__ int s_above[32], s_left[32], s_corner;
  __shared__ int s_w[28], s_dr[2 * NPOS];
  __shared__ float s_resid[MAXG][256];
  __shared__ u32 s_dq[MAXG * 256], s_tmp[MAXG * 256];
  __shared__ int s_ired[NWARP * MAXG];
  __shared__ float s_fred[NWARP * MAXG];

  const int lane = blockIdx.x, t = threadIdx.x;
  const int cols = width >> 4;
  const int r = (int)R[lane], c = (int)Cc[lane];
  const bool v = valid[lane] != 0;
  const bool ha = r > 0 && v, hl = c > 0 && v;
  const int base = 1 << (T.bit_depth - 1), pix_max = (1 << T.bit_depth) - 1;
  const int i = t >> 4, j = t & 15;
  const int srcv = src_y[(size_t)(r * 16 + i) * width + c * 16 + j];

  if (t < 28) s_w[t] = T.sm_w[t];
  if (t < 2 * NPOS) s_dr[t] = T.pred_dr[t];
  load_edges(rec_y, cols, 16, r, c, ha, hl, ur[lane] != 0, base, s_above,
             s_left, &s_corner);
  __syncthreads();
  if (t < 16) s_left[16 + t] = s_left[15];   // left2n: replicate left[15]
  __syncthreads();

  const float lam = T.lam, gate = T.gate;
  const float step = T.step16[t], off = T.off16[t];
  const int q = T.q16[t], cap = T.cap16[t];
  float best_cost = 0.f;
  int best_pos = -1, best_lv = 0, best_rec = 0;

  for (int pos = 0; pos < NPOS;) {
    const int tx = (int)T.grp_of_pos[pos];
    int ng = 1;
    while (pos + ng < NPOS && ng < MAXG && T.grp_of_pos[pos + ng] == tx) ++ng;
    int pr[MAXG];
    for (int m = 0; m < MAXG; ++m) {
      pr[m] = 0;
      if (m < ng) {
        pr[m] = pred_px(T.mode_vals[pos + m], 16, i, j, s_above, s_left,
                        s_corner, ha, hl, base, s_w + 12, s_dr);
        s_resid[m][t] = (float)(srcv - pr[m]);
      }
    }
    __syncthreads();
    // coefficient t of each candidate: one column of the group's matrix
    const float* F = T.fwd16 + (size_t)tx * 65536 + t;
    float acc[MAXG] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int k = 0; k < 256; ++k) {
      const float f = __ldg(F + k * 256);
      for (int m = 0; m < MAXG; ++m) acc[m] = fmaf(s_resid[m][k], f, acc[m]);
    }
    int lv[MAXG];
    const float gain = T.gain16[tx * 256 + t];
    for (int m = 0; m < MAXG; ++m) {
      lv[m] = m < ng ? quant_rdz(acc[m], step, cap, off, q, T.tab16, gain,
                                 lam, gate) : 0;
      s_dq[m * 256 + t] = (u32)(lv[m] * q);
    }
    __syncthreads();
    inverse_2d(16, tx, ng, s_dq, s_tmp);
    int rec[MAXG], dist[MAXG];
    for (int m = 0; m < MAXG; ++m) {
      rec[m] = min(max(pr[m] + (int)s_dq[m * 256 + t], 0), pix_max);
      const int e = rec[m] - srcv;
      dist[m] = m < ng ? e * e : 0;
    }
    block_sum_i<MAXG>(dist, s_ired);
    float rate[MAXG];
    rate_bits<MAXG>(lv, true, T.tab16, T.skip16, T.rank16, T.eob16, s_ired,
                    s_fred, rate);
    for (int m = 0; m < ng; ++m) {
      float cost = __fadd_rn(
          __int2float_rn(dist[m]),
          __fmul_rn(lam, __fadd_rn(rate[m], T.mode_bits[pos + m])));
      if (T.mode_vals[pos + m] == D203 && bl[lane]) cost = __fadd_rn(
          cost, INFINITY);
      if (best_pos < 0 || cost < best_cost) {
        best_cost = cost;
        best_pos = pos + m;
        best_lv = lv[m];
        best_rec = rec[m];
      }
    }
    pos += ng;
    __syncthreads();
  }
  lv_out[(size_t)lane * 256 + t] = (int16_t)best_lv;
  rec_out[(size_t)lane * 256 + t] = best_rec;
  if (t == 0) {
    pick_out[lane] = best_pos;
    cost_out[lane] = __fadd_rn(best_cost, T.lam_txd0);
    grp_out[lane] = T.grp_of_pos[best_pos];
  }
}

// ---- wave_sub_chroma ----

// What one transform size's chain reads.
struct SubRows {
  const float* step; const int *q, *cap; const float* off;
  const float *tab, *skip; const int* rank; const float* eob;
  const float* gain;   // (4, ns*ns), the lane's group's row is used
};

__global__ void __launch_bounds__(NT) wave_sub_chroma_kernel(
    WaveTabs T, const int* __restrict__ src_y, const int* __restrict__ src_u,
    const int* __restrict__ src_v, int width, int* rec_y, int* rec_u,
    int* rec_v, int16_t* lv_y, int16_t* lv_u, int16_t* lv_v, int8_t* modes,
    int8_t* txds, const long long* __restrict__ R,
    const long long* __restrict__ Cc, const unsigned char* __restrict__ valid,
    const unsigned char* __restrict__ ur, const long long* __restrict__ pick,
    const int16_t* __restrict__ lv16, const int* __restrict__ rec16,
    const float* __restrict__ cost_b, const long long* __restrict__ grp_b) {
  __shared__ int s_above[32], s_left[16], s_corner;
  __shared__ int s_a2[32], s_l2[32], s_co;
  __shared__ int s_w[28], s_dr[2 * NPOS];
  __shared__ int s_src[256];
  __shared__ int s_recb[2][256], s_lvb[2][256];
  __shared__ float s_fwd8[64 * 64], s_fwd4[16 * 16];
  __shared__ float s_resid[256];
  __shared__ u32 s_dq[256], s_tmp[256];
  __shared__ int s_ired[NWARP * MAXG];
  __shared__ float s_fred[NWARP * MAXG];

  const int lane = blockIdx.x, t = threadIdx.x;
  const int cols = width >> 4, cw = width >> 1;
  const int r = (int)R[lane], c = (int)Cc[lane];
  const bool v = valid[lane] != 0;
  const bool ha = r > 0 && v, hl = c > 0 && v;
  const int base = 1 << (T.bit_depth - 1), pix_max = (1 << T.bit_depth) - 1;
  const int p = (int)pick[lane], g = (int)grp_b[lane];
  const int mode = kWaveModes[T.sub_pred_row[p]];
  const float lam = T.lam, gate = T.gate;

  s_src[t] = src_y[(size_t)(r * 16 + (t >> 4)) * width + c * 16 + (t & 15)];
  if (t < 28) s_w[t] = T.sm_w[t];
  if (t < 2 * NPOS) s_dr[t] = T.pred_dr[t];
  for (int k = t; k < 64 * 64; k += NT) s_fwd8[k] = T.fwd8[g * 4096 + k];
  s_fwd4[t] = T.fwd4[g * 256 + t];
  load_edges(rec_y, cols, 16, r, c, ha, hl, ur[lane] != 0, base, s_above,
             s_left, &s_corner);
  __syncthreads();

  float dist_ch[2] = {0.f, 0.f}, rate_ch[2] = {0.f, 0.f};
  for (int ch = 0; ch < 2; ++ch) {
    const int ns = ch == 0 ? 8 : 4, nn = ns * ns, k16 = 16 / ns;
    const float* fwd = ch == 0 ? s_fwd8 : s_fwd4;
    const SubRows S = ch == 0
        ? SubRows{T.step8, T.q8, T.cap8, T.off8, T.tab8, T.skip8, T.rank8,
                  T.eob8, T.gain8}
        : SubRows{T.step4, T.q4, T.cap4, T.off4, T.tab4, T.skip4, T.rank4,
                  T.eob4, T.gain4};
    const int* w = s_w + (ns == 8 ? 4 : 0);
    int* recb = s_recb[ch];
    int* lvb = s_lvb[ch];
    const bool active = t < nn;
    const int si_t = t / ns, sj_t = t % ns;
    for (int si = 0; si < k16; ++si) {
      for (int sj = 0; sj < k16; ++sj) {
        const int y0 = si * ns, x0 = sj * ns;
        if (t < 2 * ns) {
          const int k = t;
          int a, l;
          if (si == 0) {
            a = (sj > 0 && !ha) ? recb[x0 - 1] : s_above[x0 + k];
          } else {
            a = recb[(y0 - 1) * 16 + min(x0 + k, 15)];
          }
          if (sj == 0) {
            l = (si > 0 && !hl) ? recb[(y0 - 1) * 16]
                                : s_left[min(y0 + k, 15)];
          } else {
            l = recb[min(y0 + k, y0 + ns - 1) * 16 + x0 - 1];
          }
          s_a2[k] = a;
          s_l2[k] = l;
          if (k == 0) {
            int co;
            if (si == 0 && sj == 0) co = s_corner;
            else if (si == 0) co = ha ? s_above[x0 - 1] : recb[x0 - 1];
            else if (sj == 0) co = hl ? s_left[y0 - 1] : recb[(y0 - 1) * 16];
            else co = recb[(y0 - 1) * 16 + x0 - 1];
            s_co = co;
          }
        }
        __syncthreads();
        const bool ha2 = si == 0 ? ha : true, hl2 = sj == 0 ? hl : true;
        int pr = 0, sv = 0;
        if (active) {
          pr = pred_px(mode, ns, si_t, sj_t, s_a2, s_l2, s_co, ha2, hl2,
                       base, w, s_dr);
          sv = s_src[(y0 + si_t) * 16 + x0 + sj_t];
          s_resid[t] = (float)(sv - pr);
        }
        __syncthreads();
        int lv[1] = {0};
        if (active) {
          float acc = 0.f;
          for (int k = 0; k < nn; ++k)
            acc = fmaf(s_resid[k], fwd[k * nn + t], acc);
          lv[0] = quant_rdz(acc, S.step[t], S.cap[t], S.off[t], S.q[t],
                            S.tab, S.gain[g * nn + t], lam, gate);
          s_dq[t] = (u32)(lv[0] * S.q[t]);
        }
        __syncthreads();
        inverse_2d(ns, g, 1, s_dq, s_tmp);
        int rec = 0;
        int d2[1] = {0};
        if (active) {
          rec = min(max(pr + (int)s_dq[t], 0), pix_max);
          const int e = rec - sv;
          d2[0] = e * e;
        }
        block_sum_i<1>(d2, s_ired);
        float rate[1];
        rate_bits<1>(lv, active, S.tab, S.skip, S.rank, S.eob, s_ired, s_fred,
                     rate);
        if (active) {
          recb[(y0 + si_t) * 16 + x0 + sj_t] = rec;
          lvb[(y0 + si_t) * 16 + x0 + sj_t] = lv[0];
        }
        dist_ch[ch] = __fadd_rn(dist_ch[ch], __int2float_rn(d2[0]));
        rate_ch[ch] = __fadd_rn(rate_ch[ch], rate[0]);
        __syncthreads();
      }
    }
  }

  // the tx depth: strict <, as the plain version
  const float mbits = T.mode_bits[p], cb = cost_b[lane];
  const float cost8 = __fadd_rn(dist_ch[0], __fmul_rn(lam, __fadd_rn(
      __fadd_rn(rate_ch[0], mbits), __uint_as_float(TXD8_BITS))));
  const float cost4 = __fadd_rn(dist_ch[1], __fmul_rn(lam, __fadd_rn(
      __fadd_rn(rate_ch[1], mbits), __uint_as_float(TXD4_BITS))));
  const int txd = cost8 < fminf(cb, cost4) ? 1 : (cost4 < cb ? 2 : 0);

  // luma write: the chosen depth's recon and levels
  const size_t blk = (size_t)r * cols + c;
  const size_t own = (size_t)lane * 256 + t;
  rec_y[blk * 256 + t] = txd == 1 ? s_recb[0][t]
                       : (txd == 2 ? s_recb[1][t] : rec16[own]);
  lv_y[blk * 256 + t] = txd == 1 ? (int16_t)s_lvb[0][t]
                      : (txd == 2 ? (int16_t)s_lvb[1][t]
                                  : lv16[own]);
  if (t == 0) {
    modes[blk] = T.mode_vals[p];
    txds[blk] = (int8_t)txd;
  }

  // chroma: 8x8 DC_PRED, DCT_DCT, U then V
  for (int pl = 0; pl < 2; ++pl) {
    const int* src_c = pl == 0 ? src_u : src_v;
    int* rec_c = pl == 0 ? rec_u : rec_v;
    int16_t* lv_c = pl == 0 ? lv_u : lv_v;
    if (t < 8) {
      s_a2[t] = ha ? rec_c[((size_t)(r - 1) * cols + c) * 64 + 56 + t] : 0;
      s_l2[t] = hl ? rec_c[((size_t)r * cols + c - 1) * 64 + t * 8 + 7] : 0;
    }
    __syncthreads();
    const bool active = t < 64;
    int dc = base, sv = 0;
    if (active) {
      int sa = 0, sl = 0;
      for (int k = 0; k < 8; ++k) {
        sa += s_a2[k];
        sl += s_l2[k];
      }
      dc = (ha && hl) ? (sa + sl + 8) >> 4
         : (ha ? (sa + 4) >> 3 : (hl ? (sl + 4) >> 3 : base));
      sv = src_c[(size_t)(r * 8 + (t >> 3)) * cw + c * 8 + (t & 7)];
      s_resid[t] = (float)(sv - dc);
    }
    __syncthreads();
    int lv = 0;
    if (active) {
      float acc = 0.f;
      for (int k = 0; k < 64; ++k)
        acc = fmaf(s_resid[k], __ldg(T.fwd8 + k * 64 + t), acc);
      lv = quant_rdz(acc, T.stepc[t], T.capc[t], T.offc[t], T.qc[t], T.tabc,
                     T.gainc[t], lam, gate);
      s_dq[t] = (u32)(lv * T.qc[t]);
    }
    __syncthreads();
    inverse_2d(8, 0, 1, s_dq, s_tmp);
    if (active) {
      rec_c[blk * 64 + t] = min(max(dc + (int)s_dq[t], 0), pix_max);
      lv_c[blk * 64 + t] = (int16_t)lv;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int av1_wave_luma16(const WaveTabs* T, const int* src_y,
                               int width, const int* rec_y,
                               const long long* r, const long long* c,
                               const unsigned char* valid,
                               const unsigned char* ur,
                               const unsigned char* bl, int n_valid,
                               long long* pick, int16_t* lv, int* rec,
                               float* cost_b, long long* grp_b,
                               cudaStream_t stream) {
  wave_luma16_kernel<<<n_valid, NT, 0, stream>>>(
      *T, src_y, width, rec_y, r, c, valid, ur, bl, pick, lv, rec, cost_b,
      grp_b);
  return (int)cudaGetLastError();
}

extern "C" int av1_wave_sub_chroma(
    const WaveTabs* T, const int* src_y, const int* src_u, const int* src_v,
    int width, int* rec_y, int* rec_u, int* rec_v, int16_t* lv_y,
    int16_t* lv_u, int16_t* lv_v, int8_t* modes, int8_t* txds,
    const long long* r, const long long* c, const unsigned char* valid,
    const unsigned char* ur, int n_valid, const long long* pick,
    const int16_t* lv16, const int* rec16, const float* cost_b,
    const long long* grp_b, cudaStream_t stream) {
  wave_sub_chroma_kernel<<<n_valid, NT, 0, stream>>>(
      *T, src_y, src_u, src_v, width, rec_y, rec_u, rec_v, lv_y, lv_u, lv_v,
      modes, txds, r, c, valid, ur, pick, lv16, rec16, cost_b, grp_b);
  return (int)cudaGetLastError();
}
