// The inter step's residual coder after the forward product, as one kernel
// for Hopper: code_blocks.
//
// Replaces the jitted residual coding of av1tpu/models/inter_v.py:
// `_code_nn` (:1022, called for every partition size of `_inter_partition`,
// :1091), the TX_64X64 luma merge (:1236-1250) and the fast preset's
// `_code_plane_inter` (:852).  This is not a pallas_call: XLA fused each
// site into a few device programs, where the port's eager version issued
// about 100 PyTorch operations per site (kernels/inter_code.py holds the
// wrapper and the plain PyTorch version, whose arithmetic this kernel
// repeats).  The forward product stays a cuBLAS matmul outside: the JAX
// package computes it as a plain product too (:1037, :1240).  Per
// transform block of a batch, at one size n:
//
// - the deadzone quantize (models/intra_v.py:quantize_coefs) and
//   rdoq.rd_zero's prune with the frame lambda and the optional noise gate;
// - the dequantize sign(lv) * ((|lv| * q) >> dq_shift) (dq_shift 1 at
//   32x32, 2 for TX_64X64, whose 32x32 coded levels sit in the top-left of
//   a 64x64 block);
// - the integer inverse DCT at n (itx.cuh), the recon clip, the integer
//   SSE as float32 (summed in int32 and wrapping, as the reference's
//   jnp.sum: only a 10-bit 64x64 block with an SSE of 2^31 or more wraps),
//   the skip SSE sum((src - pred)^2) in float32;
// - where asked, rates.RateModel's bits (scan rank, end of block, the
//   magnitude table, the Golomb closed form above 15, txb_skip).
//
// What bounds it on an H100.  A 1088x1920 quality inter frame codes eight
// batches (16x16 luma, 8x8 chroma, 8x8 and 4x4 sub-blocks, the 32 and 64
// merges), about 2 M coefficients and 3 M pixels each way: tens of
// megabytes, a few microseconds at 3.35 TB/s each.  The integer inverse is
// about 20 to 60 operations per pixel, well under a millisecond at the
// card's integer rate.  So the launches are bound by bytes.
//
// What the design does about it.  The first version of this kernel gave
// a CTA of 256 threads one transform block at n >= 16 (16 or 4 at n = 4
// and 8), and the inverse one thread per row, then per column: 16 to 64
// of the 256 threads worked through the butterflies.  Giving every thread
// a line (256 / n blocks per CTA) measured slower on the main path's
// batches: the work per element outside the inverse (the quantize's IEEE
// division, rd_zero and the rate per coefficient; the recon; five sums
// per block) is what the launches spend there, most blocks having no
// level.  So a CTA takes the number of blocks that measured best at each
// size (Layout<N>::NB: 64, 32, 8, 2 and 2 at n = 4 to 64; PERF.md,
// code_blocks per site, which also times batches whose every block
// carries levels), each thread the same elements of each of its blocks
// as a thread of the first version had of its one.  Two threads per
// 64-point line (the even and the odd half of idct64 on two warps,
// meeting in shared memory) measured no faster either, so a line keeps
// one thread.  What is new:
// - a block without a nonzero level skips its inverse (its residual is
//   the zeros it holds; chip_smoke.py phase 7c prints their share);
// - the per-block sums of a thread's several blocks share one transposed
//   butterfly (log2 NV shuffles fewer per step) that pairs the first
//   version's lanes in its order;
// - the coefficients go to shared memory first, all loads in flight, and
//   the levels stay there for the rate, so no value lives in a register
//   across the division's slow-path calls (which spilled at n = 64);
// - the CTA sends its source and prediction lines to L2
//   (prefetch.global.L2) before it quantizes; the inverse runs in place
//   on one buffer of n + 1 words per row (an odd stride puts a warp's
//   rows, and its columns, on 32 banks), at TX_64X64 over the 32 coded
//   rows with the zero inputs folded away.

// Bits.  The plain version rounds every float operation, so the quantize,
// rd_zero's c*c - t*t and save > lam*bits, and the rate are written with
// __fmul_rn/__fadd_rn/__fsub_rn and IEEE division (nvcc would contract
// a*b + c into an FMA).  floor(log2(a - 14)) is 31 - __clz.  The SSE is an
// integer sum; the inverse wraps in int32 as the plain version's tensors
// do.  The skip SSE and the rate are float32 sums in another order than
// PyTorch's (exact while the skip SSE's partial sums stay under 2^24, as
// they always do for 8-bit blocks up to 16x16), so a skip or merge
// decision may flip at a near-tie; chip_smoke.py counts them.  Each is
// summed in the first version's order (a thread's elements of a block in
// turn, the warp's butterfly, the block's warps in order): a thread of
// this layout takes that version's thread's elements of each of its
// blocks, so the sums, and the streams, are the same bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "itx.cuh"

// kernels/inter_code.py:CodeTabsC, field for field
struct CodeTabs {
  const float *step, *dq_scale, *off, *gain;
  const int *q, *cap;
  const float *tab, *skip, *eob;
  const int* rank;
  float lam, gate;
  int n, dq_shift, has_gate, with_rate, pix_max;
};

namespace {

constexpr int KEEP_ALWAYS = 8;

// Deadzone quantize of one coefficient, then rd_zero's keep test.
__device__ int quant_rdz(float coef, const CodeTabs& T, int j) {
  const float ca = fabsf(coef);
  const int mag = (int)floorf(__fadd_rn(__fdiv_rn(ca, T.step[j]), T.off[j]));
  const int sgn = coef > 0.f ? 1 : (coef < 0.f ? -1 : 0);
  const int cap = T.cap[j];
  const int lv = min(max(sgn * mag, -cap), cap);
  const int a = abs(lv);
  if (a == 0 || a >= KEEP_ALWAYS) return lv;
  const float g = T.gain[j];
  const float t = __fsub_rn(ca, __fmul_rn((float)a, T.dq_scale[j]));
  const float save = __fmul_rn(g, __fsub_rn(__fmul_rn(ca, ca),
                                            __fmul_rn(t, t)));
  const float bits = __fsub_rn(T.tab[a], T.tab[0]);
  bool keep = save > __fmul_rn(T.lam, bits);
  if (T.has_gate) keep = keep && __fmul_rn(__fmul_rn(g, ca), ca) > T.gate;
  return keep ? lv : 0;
}

// RateModel's bits of one coded coefficient of magnitude a.
__device__ __forceinline__ float coef_bits(int a, const float* tab) {
  if (a <= 15) return tab[a];
  const int fl = 31 - __clz(a - 14);   // floor(log2(a - 14)), a - 14 >= 2
  return __fadd_rn(__fadd_rn(__fsub_rn(tab[15], 1.0f), (float)(2 * fl)),
                   1.0f);
}

struct FAdd {
  __device__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};
struct UAdd {
  __device__ u32 operator()(u32 a, u32 b) const { return a + b; }
};
struct IMax {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

constexpr int NT = 256;     // threads per CTA

// Layout<N>: NB blocks of N x N per CTA.  Each per-block sum keeps the
// first version's order, whose CTA gave a block VT = min(NC, 256) threads:
// thread t summed its elements t + VT m in turn, the warp's butterfly
// joined a warp's threads, then the block's warps were added in order.
// Here thread t takes the same elements of each of its NV blocks blk(v).
template <int N>
struct Layout {
  // transform blocks per CTA (measured: PERF.md, code_blocks per site;
  // kernels/inter_code.py:CODE_BLOCKS_PER_CTA mirrors them)
  static constexpr int NB = N == 4 ? 64 : N == 8 ? 32 : N == 16 ? 8 : 2;
  static constexpr int CW = N < 32 ? N : 32;       // coded width
  static constexpr int NC = CW * CW, NP = N * N;
  static constexpr int LD = N + 1;                 // shared row stride (odd)
  static constexpr int BS = N * LD;                // a block's words
  static constexpr int VT = NC < NT ? NC : NT;     // threads per block
  static constexpr int NV = NB * VT / NT;          // blocks per thread
  static constexpr int EPL = NC / VT, PPL = NP / VT;
  static constexpr int W = VT < 32 ? VT : 32;      // a butterfly's lanes
  static constexpr int RED = VT > 32 ? NV * NT / 32 : 0;   // scratch words
  static constexpr size_t SMEM = (size_t)NB * (BS + NC) * sizeof(u32);
  static_assert(NB * VT % NT == 0 && NV >= 1 && (NV & (NV - 1)) == 0 &&
                NV <= W, "code_blocks layout");
  static_assert(SMEM <= 48 * 1024, "the default dynamic shared memory");
  __device__ static int blk(int v) {
    return VT == NT ? v : (int)threadIdx.x / VT + v * (NT / VT);
  }
  __device__ static int elem(int m) { return (int)threadIdx.x % VT + VT * m; }
};

// One step of the butterfly at lane offset O on H values per lane, then
// the rest.  While H > 1 it is transposed: a lane with bit O set keeps
// the upper half of its values and trades the lower half with lane ^ O,
// so each value still meets its own partner (the plain butterfly's pairs,
// in its order) with H / 2 shuffles, not H.
template <int O, int H, typename V, typename Op>
__device__ __forceinline__ void butterfly(V* v, Op op, int lane) {
  if constexpr (O > 0) {
    if constexpr (H > 1) {
      const bool up = lane & O;
#pragma unroll
      for (int k = 0; k < H / 2; ++k) {
        const V send = up ? v[k] : v[k + H / 2];
        const V keep = up ? v[k + H / 2] : v[k];
        v[k] = op(keep, __shfl_xor_sync(~0u, send, O));
      }
      butterfly<O / 2, H / 2>(v, op, lane);
    } else {
      v[0] = op(v[0], __shfl_xor_sync(~0u, v[0], O));
      butterfly<O / 2, 1>(v, op, lane);
    }
  }
}

// The per-block sums of each of a thread's NV values (one per block):
// the butterfly over W lanes, which leaves block v's warp sum in the lanes
// (lane % W) / (W / NV) == v, then the block's warps in order.  out[b]
// gets local block b's sum; every thread sees it after the call.  red:
// Layout<N>::RED words of scratch.
template <int N, typename V, typename Op>
__device__ void block_reduce(V (&v)[Layout<N>::NV], V* out, V* red, Op op) {
  using L = Layout<N>;
  constexpr int W = L::W, NV = L::NV, NW = NT / 32;
  const int t = threadIdx.x, lane = t & 31;
  butterfly<W / 2, NV>(v, op, lane);
  const int s = (lane % W) / (W / NV);             // this lane's block
  const bool holder = lane % (W / NV) == 0;
  if constexpr (L::VT <= 32) {
    if (holder) out[t / L::VT + s * (NT / L::VT)] = v[0];
  } else {
    if (holder) red[s * NW + (t >> 5)] = v[0];
    __syncthreads();
    constexpr int PER = NT / L::VT, WPB = L::VT / 32;   // blocks per slot
    if (t < L::NB) {
      const V* r = red + (t / PER) * NW + (t % PER) * WPB;
      V acc = r[0];
#pragma unroll
      for (int k = 1; k < WPB; ++k) acc = op(acc, r[k]);
      out[t] = acc;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// One 1-D inverse DCT of N points on a line of the shared buffer, in place:
// inputs p[k * step], k < K (the rest zero), outputs shifted right by SH.
template <int N, int K, int SH>
__device__ __forceinline__ void inv_line(u32* p, int step) {
  u32 in[N], out[N];
#pragma unroll
  for (int k = 0; k < N; ++k) in[k] = k < K ? p[k * step] : 0u;
  inv1d<N>(false, in, out);
#pragma unroll
  for (int k = 0; k < N; ++k) p[k * step] = rs(out[k], SH);
}

template <int N>
__global__ void __launch_bounds__(NT) code_blocks_kernel(
    CodeTabs T, const float* __restrict__ coefs, const int* __restrict__ src,
    const int* __restrict__ pred, int nblocks, int* __restrict__ lv_out,
    int* __restrict__ rec_out, float* __restrict__ dist_out,
    float* __restrict__ rate_out, float* __restrict__ dskip_out) {
  using L = Layout<N>;
  constexpr int NB = L::NB, CW = L::CW, NC = L::NC, NP = L::NP, LD = L::LD,
                BS = L::BS, NV = L::NV;
  extern __shared__ u32 s_buf[];                 // NB blocks of N x LD
  __shared__ u32 s_red[L::RED > 0 ? L::RED : 1];
  __shared__ u32 s_dist[NB];
  __shared__ float s_dskip[NB], s_bits[NB];
  __shared__ int s_eob[NB];
  __shared__ int s_nz[NB];                       // a nonzero level

  const int t = threadIdx.x;
  __builtin_assume(t < NT);
  const int b0 = blockIdx.x * NB;
  const int nb = min(NB, nblocks - b0);          // blocks of this CTA

  // the CTA's source and prediction lines on their way to L2 while it
  // quantizes and inverts
  for (int i = t; i < nb * NP / 32; i += NT) {
    prefetch_l2(src + (size_t)b0 * NP + 32 * i);
    prefetch_l2(pred + (size_t)b0 * NP + 32 * i);
  }
  if (CW < N)                                    // TX_64X64: zero the rest
    for (int p = t; p < NB * BS; p += NT) s_buf[p] = 0u;
  for (int b = t; b < NB; b += NT) s_nz[b] = 0;
  __syncthreads();

  // quantize, rd_zero, dequantize into shared memory; each thread's
  // levels also go to s_lv for the rate
  int* s_lv = reinterpret_cast<int*>(s_buf + NB * BS);   // NB x NC levels
  // the coefficients into s_lv (as bits), all loads in flight at once
#pragma unroll
  for (int s = 0; s < NV; ++s)
#pragma unroll
    for (int m = 0; m < L::EPL; ++m)
      s_lv[L::blk(s) * NC + L::elem(m)] = L::blk(s) < nb
          ? __float_as_int(coefs[(size_t)(b0 + L::blk(s)) * NC + L::elem(m)])
          : 0;
  int eob[NV];
#pragma unroll
  for (int s = 0; s < NV; ++s) {
    eob[s] = 0;
#pragma unroll
    for (int m = 0; m < L::EPL; ++m) {
      const int b = L::blk(s), j = L::elem(m);
      int lv = 0;
      if (b < nb) {
        lv = quant_rdz(__int_as_float(s_lv[b * NC + j]), T, j);
        lv_out[(size_t)(b0 + b) * NC + j] = lv;
        if (lv != 0) {
          s_nz[b] = 1;
          if (T.with_rate) eob[s] = max(eob[s], T.rank[j] + 1);
        }
      }
      s_lv[b * NC + j] = lv;
      const int dq = (int)(((u32)abs(lv) * (u32)T.q[j]) >> T.dq_shift);
      s_buf[b * BS + (j / CW) * LD + j % CW] = (u32)(lv < 0 ? -dq : dq);
    }
  }

  // RateModel: end of block, then the coded coefficients' bits
  if (T.with_rate) {
    block_reduce<N>(eob, s_eob, reinterpret_cast<int*>(s_red), IMax());
    float bits[NV];
#pragma unroll
    for (int s = 0; s < NV; ++s) {
      bits[s] = 0.f;
      const int b = L::blk(s), e = s_eob[b];
      if (e == 0) continue;                      // no coded coefficient
#pragma unroll
      for (int m = 0; m < L::EPL; ++m)
        if (T.rank[L::elem(m)] < e)
          bits[s] = __fadd_rn(bits[s], coef_bits(abs(s_lv[b * NC + L::elem(m)]),
                                                 T.tab));
    }
    block_reduce<N>(bits, s_bits, reinterpret_cast<float*>(s_red), FAdd());
    for (int b = t; b < nb; b += NT)
      rate_out[b0 + b] = s_eob[b] == 0
          ? T.skip[1] : __fadd_rn(__fadd_rn(T.skip[0], T.eob[s_eob[b]]),
                                   s_bits[b]);
  } else {
    __syncthreads();
  }

  // the inverse DCT in place, a thread per line: the coded rows (TX_64X64:
  // 32 rows of 32 nonzero inputs), shifted by _ROW_SHIFT, then the columns.
  // A block without a nonzero level is skipped: its residual is the zeros
  // it holds (every butterfly and rounding of zeros gives zero).
  constexpr int ROW_SHIFT = N == 4 ? 0 : (N == 8 ? 1 : 2);
  for (int line = t; line < NB * CW; line += NT)
    if (s_nz[line / CW])
      inv_line<N, CW, ROW_SHIFT>(s_buf + (line / CW) * BS + (line % CW) * LD,
                                 1);
  __syncthreads();
  for (int line = t; line < NB * N; line += NT)
    if (s_nz[line / N])
      inv_line<N, N, 4>(s_buf + (line / N) * BS + line % N, LD);
  __syncthreads();

  // recon, SSE (int32, wrapping) and skip SSE
  u32 dist[NV];
  float dskip[NV];
#pragma unroll
  for (int s = 0; s < NV; ++s) {
    const int b = L::blk(s);
    dist[s] = 0u;
    dskip[s] = 0.f;
    if (b >= nb) continue;
#pragma unroll
    for (int m = 0; m < L::PPL; ++m) {
      const int idx = L::elem(m);
      const size_t g = (size_t)(b0 + b) * NP + idx;
      const int sv = src[g], pr = pred[g];
      const int r = (int)s_buf[b * BS + (idx / N) * LD + idx % N];
      const int rec = min(max(pr + r, 0), T.pix_max);
      rec_out[g] = rec;
      const int e = rec - sv, d = sv - pr;
      dist[s] += (u32)(e * e);
      dskip[s] = __fadd_rn(dskip[s], (float)(d * d));
    }
  }
  block_reduce<N>(dist, s_dist, s_red, UAdd());
  block_reduce<N>(dskip, s_dskip, reinterpret_cast<float*>(s_red), FAdd());
  for (int b = t; b < nb; b += NT) {
    dist_out[b0 + b] = __int2float_rn((int)s_dist[b]);   // int32, wrapped
    dskip_out[b0 + b] = s_dskip[b];
  }
}

template <int N>
int launch(const CodeTabs& T, const float* coefs, const int* src,
           const int* pred, int nblocks, int* lv, int* rec, float* dist,
           float* rate, float* dskip, cudaStream_t stream) {
  using L = Layout<N>;
  code_blocks_kernel<N><<<(nblocks + L::NB - 1) / L::NB, NT, L::SMEM,
                          stream>>>(T, coefs, src, pred, nblocks, lv, rec,
                                    dist, rate, dskip);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int av1_code_blocks(const CodeTabs* T, const float* coefs,
                               const int* src, const int* pred, int nblocks,
                               int* lv, int* rec, float* dist, float* rate,
                               float* dskip, cudaStream_t stream) {
  switch (T->n) {
    case 4: return launch<4>(*T, coefs, src, pred, nblocks, lv, rec, dist,
                             rate, dskip, stream);
    case 8: return launch<8>(*T, coefs, src, pred, nblocks, lv, rec, dist,
                             rate, dskip, stream);
    case 16: return launch<16>(*T, coefs, src, pred, nblocks, lv, rec, dist,
                               rate, dskip, stream);
    case 32: return launch<32>(*T, coefs, src, pred, nblocks, lv, rec, dist,
                               rate, dskip, stream);
    case 64: return launch<64>(*T, coefs, src, pred, nblocks, lv, rec, dist,
                               rate, dskip, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch layout of size n, for kernels/inter_code.py:code_layout to
// check its mirror against: out = {blocks per CTA, threads per CTA,
// dynamic shared bytes, static shared bytes (cudaFuncGetAttributes)}.
extern "C" int av1_code_blocks_layout(int n, int* out) {
  cudaFuncAttributes a;
  cudaError_t e;
  switch (n) {
#define LAYOUT_CASE(N)                                                  \
    case N:                                                             \
      e = cudaFuncGetAttributes(&a, code_blocks_kernel<N>);             \
      out[0] = Layout<N>::NB;                                           \
      out[2] = (int)Layout<N>::SMEM;                                    \
      break;
    LAYOUT_CASE(4) LAYOUT_CASE(8) LAYOUT_CASE(16) LAYOUT_CASE(32)
    LAYOUT_CASE(64)
#undef LAYOUT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  out[1] = NT;
  out[3] = (int)a.sharedSizeBytes;
  return (int)e;
}
