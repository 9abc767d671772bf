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
// card's integer rate.  So the launches are bound by bytes, and by the
// serial butterflies of the 32- and 64-point inverses inside one block.
//
// What the design does about it.  One block of 256 threads per transform
// block at n >= 16 (each thread owns 1, 4 or 16 pixels and 1 or 4
// coefficients), and 16 or 4 transform blocks per block at n = 4 and 8, so
// every block has 256 pixels or more.  The dequantized levels go to shared
// memory; the rows and then the columns of the inverse are one thread
// each, on a padded stride (n + 1) so that a row's reads do not collide in
// one bank.  Per transform block, SSE, skip SSE, end of block and bits are
// tree reductions (warp shuffles, then one value per warp in shared
// memory) in a fixed order, so a run repeats its bits.
//
// Bits.  The plain version rounds every float operation, so the quantize,
// rd_zero's c*c - t*t and save > lam*bits, and the rate are written with
// __fmul_rn/__fadd_rn/__fsub_rn and IEEE division (nvcc would contract
// a*b + c into an FMA).  floor(log2(a - 14)) is 31 - __clz.  The SSE is an
// integer sum; the inverse wraps in int32 as the plain version's tensors
// do.  What cannot match: the skip SSE and the rate are float32
// sums in another order than PyTorch's (exact while the skip SSE's partial
// sums stay under 2^24, as they always do for 8-bit blocks up to 16x16),
// so a skip or merge decision may flip at a near-tie; chip_smoke.py counts
// them.

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

constexpr int NT = 256;
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
struct LAdd {
  __device__ long long operator()(long long a, long long b) const {
    return a + b;
  }
};
struct IMax {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

// Reduction over segments of SEG consecutive threads (a power of two, 16
// to NT): warp shuffles, then the segment's warp values in order.  Every
// thread gets its segment's result.  red: NT / 32 values of scratch.
template <int SEG, typename V, typename Op>
__device__ V seg_reduce(V v, V* red, Op op) {
  constexpr int W = SEG < 32 ? SEG : 32;
  for (int o = W / 2; o; o >>= 1) v = op(v, __shfl_xor_sync(~0u, v, o));
  if (SEG <= 32) return v;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int first = (threadIdx.x / SEG) * (SEG / 32);
  V s = red[first];
  for (int k = 1; k < SEG / 32; ++k) s = op(s, red[first + k]);
  return s;
}

template <int N>
__global__ void __launch_bounds__(NT) code_blocks_kernel(
    CodeTabs T, const float* __restrict__ coefs, const int* __restrict__ src,
    const int* __restrict__ pred, int nblocks, int* lv_out, int* rec_out,
    float* dist_out, float* rate_out, float* dskip_out) {
  constexpr int NB = N <= 16 ? NT / (N * N) : 1;   // transform blocks
  constexpr int CW = N < 32 ? N : 32;              // coded width
  constexpr int NC = CW * CW, NP = N * N;
  constexpr int LD = N + 1;                        // shared row stride
  constexpr int EPT = NB * NC / NT;                // coefficients / thread
  constexpr int PPT = NB * NP / NT;                // pixels / thread
  constexpr int SEG = N <= 16 ? NP : NT;           // threads per block
  __shared__ u32 s_dq[NB * N * LD], s_tmp[NB * N * LD];
  __shared__ float s_fred[NT / 32];
  __shared__ long long s_lred[NT / 32];
  __shared__ int s_ired[NT / 32];

  const int t = threadIdx.x;
  const int b0 = blockIdx.x * NB;
  const bool valid = b0 + t / SEG < nblocks;   // this thread's block

  // quantize, rd_zero, dequantize into shared memory
  if (CW < N) {
    for (int p = t; p < NB * N * LD; p += NT) s_dq[p] = 0u;
    __syncthreads();
  }
  int lvr[EPT];
  for (int k = 0; k < EPT; ++k) {
    const int e = t + k * NT, blk = e / NC, j = e % NC;
    int lv = 0;
    if (valid) {
      const size_t g = (size_t)(b0 + blk) * NC + j;
      lv = quant_rdz(coefs[g], T, j);
      lv_out[g] = lv;
    }
    lvr[k] = lv;
    const int a = abs(lv);
    const int dq = (int)(((u32)a * (u32)T.q[j]) >> T.dq_shift);
    s_dq[blk * N * LD + (j / CW) * LD + j % CW] = (u32)(lv < 0 ? -dq : dq);
  }
  __syncthreads();

  // the inverse DCT (TX_64X64: rows 32..63 are zero)
  inverse_2d<N>(0, NB, s_dq, s_tmp, N * LD, LD, CW);

  // recon, SSE and skip SSE
  long long dist = 0;
  float dskip = 0.f;
  for (int k = 0; k < PPT; ++k) {
    const int p = t + k * NT, blk = p / NP, idx = p % NP;
    if (!valid) break;
    const size_t g = (size_t)(b0 + blk) * NP + idx;
    const int s = src[g], pr = pred[g];
    const int r = (int)s_dq[blk * N * LD + (idx / N) * LD + idx % N];
    const int rec = min(max(pr + r, 0), T.pix_max);
    rec_out[g] = rec;
    const int e = rec - s, d = s - pr;
    dist += (long long)(e * e);
    dskip = __fadd_rn(dskip, (float)(d * d));
  }
  dist = seg_reduce<SEG>(dist, s_lred, LAdd());
  dskip = seg_reduce<SEG>(dskip, s_fred, FAdd());
  const int bi = b0 + t / SEG;
  const bool writer = valid && t % SEG == 0;
  if (writer) {
    dist_out[bi] = __int2float_rn((int)(u32)dist);   // int32, wrapped
    dskip_out[bi] = dskip;
  }
  if (!T.with_rate) return;

  // RateModel: end of block, then the coded coefficients' bits
  int eob = 0;
  for (int k = 0; k < EPT; ++k) {
    const int j = (t + k * NT) % NC;
    if (lvr[k] != 0) eob = max(eob, T.rank[j] + 1);
  }
  eob = seg_reduce<SEG>(eob, s_ired, IMax());
  float bits = 0.f;
  for (int k = 0; k < EPT; ++k) {
    const int j = (t + k * NT) % NC;
    if (T.rank[j] < eob) bits = __fadd_rn(bits, coef_bits(abs(lvr[k]),
                                                           T.tab));
  }
  bits = seg_reduce<SEG>(bits, s_fred, FAdd());
  if (writer) {
    rate_out[bi] = eob == 0 ? T.skip[1]
                            : __fadd_rn(__fadd_rn(T.skip[0], T.eob[eob]),
                                        bits);
  }
}

template <int N>
int launch(const CodeTabs& T, const float* coefs, const int* src,
           const int* pred, int nblocks, int* lv, int* rec, float* dist,
           float* rate, float* dskip, cudaStream_t stream) {
  constexpr int NB = N <= 16 ? NT / (N * N) : 1;
  code_blocks_kernel<N><<<(nblocks + NB - 1) / NB, NT, 0, stream>>>(
      T, coefs, src, pred, nblocks, lv, rec, dist, rate, dskip);
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
