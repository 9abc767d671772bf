// The integer inverse transforms of av1tpu_torch/ops/transforms.py for the
// CUDA kernels: 1-D DCTs of 4 to 64 points and ADSTs of 4 to 16, with the
// same butterflies and per-stage roundings, and the 2-D inverse with its tx
// types (inverse_2d).  Everything is unsigned 32-bit arithmetic, so
// products and sums wrap as the plain version's int32 tensors do; rs()
// shifts arithmetically.  csrc/intra_wave.cu (the wavefront keyframe),
// csrc/inter_code.cu (the inter residual coder) and csrc/intra_part.cu
// (the partition probe) include it.  Each source is compiled on its own
// (no relocatable device code), so the constant table below is per
// translation unit.

#pragma once

#include <stdint.h>

namespace {

typedef unsigned int u32;

// round(cos(i * pi / 128) * 4096), the spec's cos128 table
__constant__ int kCos[65] = {
    4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973, 3948,
    3920, 3889, 3857, 3822, 3784, 3745, 3703, 3659, 3612, 3564, 3513, 3461,
    3406, 3349, 3290, 3229, 3166, 3102, 3035, 2967, 2896, 2824, 2751, 2675,
    2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019, 1931, 1842, 1751, 1660,
    1567, 1474, 1380, 1285, 1189, 1092, 995, 897, 799, 700, 601, 501, 401,
    301, 201, 101, 0};
constexpr int SINPI1 = 1321, SINPI2 = 2482, SINPI3 = 3344, SINPI4 = 3803;

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

// The odd half of ops/transforms.py:idct32: z from the odd inputs
// xo[j] = x[2 j + 1]; idct32 adds it to idct16 of the even inputs.
__device__ void idct32_odd(const u32* xo, u32* z) {
  const int oi[16] = {0, 8, 4, 12, 2, 10, 6, 14,
                      1, 9, 5, 13, 3, 11, 7, 15};
  const int ang[8][2] = {{62, 2}, {30, 34}, {46, 18}, {14, 50},
                         {54, 10}, {22, 42}, {38, 26}, {6, 58}};
  u32 s[16];
  for (int k = 0; k < 8; ++k) {
    const u32 lo = xo[oi[k]], hi = xo[oi[15 - k]];
    s[k] = btf(C(ang[k][0]), lo, -C(ang[k][1]), hi);
    s[15 - k] = btf(C(ang[k][1]), lo, C(ang[k][0]), hi);
  }
  u32 t[16];
  for (int i = 0; i < 16; i += 4) {
    t[i] = s[i] + s[i + 1];
    t[i + 1] = s[i] - s[i + 1];
    t[i + 2] = s[i + 3] - s[i + 2];
    t[i + 3] = s[i + 2] + s[i + 3];
  }
  u32 u[16];
  for (int i = 0; i < 16; ++i) u[i] = t[i];
  u[1] = btf(-C(8), t[1], C(56), t[14]);
  u[2] = btf(-C(56), t[2], -C(8), t[13]);
  u[13] = btf(-C(8), t[2], C(56), t[13]);
  u[14] = btf(C(56), t[1], C(8), t[14]);
  u[5] = btf(-C(40), t[5], C(24), t[10]);
  u[6] = btf(-C(24), t[6], -C(40), t[9]);
  u[9] = btf(-C(40), t[6], C(24), t[9]);
  u[10] = btf(C(24), t[5], C(40), t[10]);
  const u32 v[16] = {u[0] + u[3], u[1] + u[2], u[1] - u[2], u[0] - u[3],
                     u[7] - u[4], u[6] - u[5], u[5] + u[6], u[4] + u[7],
                     u[8] + u[11], u[9] + u[10], u[9] - u[10], u[8] - u[11],
                     u[15] - u[12], u[14] - u[13], u[13] + u[14],
                     u[12] + u[15]};
  u32 w[16];
  for (int i = 0; i < 16; ++i) w[i] = v[i];
  w[2] = btf(-C(16), v[2], C(48), v[13]);
  w[3] = btf(-C(16), v[3], C(48), v[12]);
  w[12] = btf(C(48), v[3], C(16), v[12]);
  w[13] = btf(C(48), v[2], C(16), v[13]);
  w[4] = btf(-C(48), v[4], -C(16), v[11]);
  w[5] = btf(-C(48), v[5], -C(16), v[10]);
  w[10] = btf(-C(16), v[5], C(48), v[10]);
  w[11] = btf(-C(16), v[4], C(48), v[11]);
  const u32 y[16] = {w[0] + w[7], w[1] + w[6], w[2] + w[5], w[3] + w[4],
                     w[3] - w[4], w[2] - w[5], w[1] - w[6], w[0] - w[7],
                     w[15] - w[8], w[14] - w[9], w[13] - w[10],
                     w[12] - w[11], w[11] + w[12], w[10] + w[13],
                     w[9] + w[14], w[8] + w[15]};
  for (int i = 0; i < 16; ++i) z[i] = y[i];
  for (int i = 4; i < 8; ++i) {
    z[i] = btf(-C(32), y[i], C(32), y[15 - i]);
    z[15 - i] = btf(C(32), y[i], C(32), y[15 - i]);
  }
}

// ops/transforms.py:idct32
__device__ void idct32(const u32* x, u32* o) {
  u32 ev[16], e[16], od[16], z[16];
  for (int i = 0; i < 16; ++i) {
    ev[i] = x[2 * i];
    od[i] = x[2 * i + 1];
  }
  idct16(ev, e);
  idct32_odd(od, z);
  for (int i = 0; i < 16; ++i) {
    o[i] = e[i] + z[15 - i];
    o[16 + i] = e[15 - i] - z[i];
  }
}

__device__ __forceinline__ int brev(int v, int bits) {
  int out = 0;
  for (int i = 0; i < bits; ++i) {
    out = (out << 1) | (v & 1);
    v >>= 1;
  }
  return out;
}

// The odd half of ops/transforms.py:idct64 (the generic odd-half
// recursion; every angle it reads lies in [0, 64], where cos128 is the
// table itself): a from the odd inputs xo[j] = x[2 j + 1]; idct64 adds it
// to idct32 of the even inputs.
__device__ void idct64_odd(const u32* xo, u32* a) {
  u32 b[32];
  for (int k = 0; k < 32; ++k) b[k] = xo[brev(k, 5)];
  for (int k = 0; k < 16; ++k) {
    const int a2 = 2 * brev(k, 5) + 1;
    const u32 lo = b[k], hi = b[31 - k];
    a[k] = btf(C(64 - a2), lo, -C(a2), hi);
    a[31 - k] = btf(C(a2), lo, C(64 - a2), hi);
  }
  for (int g = 4, blk_bits = 3; g <= 32; g *= 2, --blk_bits) {
    const int h = g / 2;
    for (int base = 0; base < 32; base += g) {
      for (int i = 0; i < h / 2; ++i) {
        const u32 lo = a[base + i], hi = a[base + h - 1 - i];
        b[base + i] = lo + hi;
        b[base + h - 1 - i] = lo - hi;
        const u32 lo2 = a[base + h + i], hi2 = a[base + g - 1 - i];
        b[base + h + i] = hi2 - lo2;
        b[base + g - 1 - i] = lo2 + hi2;
      }
    }
    for (int i = 0; i < 32; ++i) a[i] = b[i];
    if (g == 32) {
      for (int i = 8; i < 16; ++i) {
        const u32 lo = b[i], hi = b[31 - i];
        a[i] = btf(-C(32), lo, C(32), hi);
        a[31 - i] = btf(C(32), lo, C(32), hi);
      }
    } else {
      for (int i = 0; i < 16; ++i) {
        const int r = i % g, j = i / g;
        const int aa = g * (2 * brev(j, blk_bits) + 1), bb = 64 - aa;
        const u32 lo = b[i], hi = b[31 - i];
        if (g / 4 <= r && r < g / 2) {
          a[i] = btf(-C(aa), lo, C(bb), hi);
          a[31 - i] = btf(C(bb), lo, C(aa), hi);
        } else if (g / 2 <= r && r < 3 * g / 4) {
          a[i] = btf(-C(bb), lo, -C(aa), hi);
          a[31 - i] = btf(-C(aa), lo, C(bb), hi);
        }
      }
    }
  }
}

// ops/transforms.py:idct64
__device__ void idct64(const u32* x, u32* o) {
  u32 ev[32], e[32], od[32], a[32];
  for (int i = 0; i < 32; ++i) {
    ev[i] = x[2 * i];
    od[i] = x[2 * i + 1];
  }
  idct32(ev, e);
  idct64_odd(od, a);
  for (int i = 0; i < 32; ++i) {
    o[i] = e[i] + a[31 - i];
    o[32 + i] = e[31 - i] - a[i];
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

// One 1-D inverse of N points: DCT, or ADST where `adst` (N = 4, 8, 16).
template <int N>
__device__ __forceinline__ void inv1d(bool adst, const u32* x, u32* o) {
  if constexpr (N == 4) {
    if (adst) iadst4(x, o); else idct4(x, o);
  } else if constexpr (N == 8) {
    if (adst) iadst8(x, o); else idct8(x, o);
  } else if constexpr (N == 16) {
    if (adst) iadst16(x, o); else idct16(x, o);
  } else if constexpr (N == 32) {
    idct32(x, o);
  } else {
    idct64(x, o);
  }
}

// The 2-D inverse of ops/transforms.py:_inverse_2d on nb N x N blocks in
// shared memory: row r of block b starts at buf + b * bstride + r * ld
// (ld >= N).  buf holds the dequantized coefficients and is replaced by the
// residual; tmp, laid out alike, is scratch.  Rows at or past `rows` are
// zero (TX_64X64 codes its top-left 32x32), so their row pass is skipped.
// tx: 0 DCT_DCT, 1 ADST_DCT (vertical ADST), 2 DCT_ADST, 3 ADST_ADST
// (_TX_KIND).  The rows are shifted by _ROW_SHIFT (0 at 4, 1 at 8, 2
// above), the columns by 4.  The block's threads share the rows, then the
// columns; every thread of the block calls it (two barriers).
template <int N>
__device__ void inverse_2d(int tx, int nb, u32* buf, u32* tmp, int bstride,
                           int ld, int rows = N) {
  constexpr int ROW_SHIFT = N == 4 ? 0 : (N == 8 ? 1 : 2);
  const bool h_adst = tx == 2 || tx == 3, v_adst = tx == 1 || tx == 3;
  u32 in[N], out[N];
  for (int r = threadIdx.x; r < nb * N; r += blockDim.x) {
    const u32* src = buf + (r / N) * bstride + (r % N) * ld;
    u32* dst = tmp + (r / N) * bstride + (r % N) * ld;
    if (r % N >= rows) {
      for (int k = 0; k < N; ++k) dst[k] = 0u;
      continue;
    }
    for (int k = 0; k < N; ++k) in[k] = src[k];
    inv1d<N>(h_adst, in, out);
    for (int k = 0; k < N; ++k) dst[k] = rs(out[k], ROW_SHIFT);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < nb * N; c += blockDim.x) {
    const u32* src = tmp + (c / N) * bstride + c % N;
    u32* dst = buf + (c / N) * bstride + c % N;
    for (int k = 0; k < N; ++k) in[k] = src[k * ld];
    inv1d<N>(v_adst, in, out);
    for (int k = 0; k < N; ++k) dst[k * ld] = rs(out[k], 4);
  }
  __syncthreads();
}

}  // namespace
