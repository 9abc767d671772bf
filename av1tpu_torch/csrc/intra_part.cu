// The quality preset's partition probe as four kernels for Hopper:
// part_chain, part_pred, part_code and part_merge.
//
// Replaces the jitted probe of av1tpu/models/intra_part.py
// (`encode_intra_part`, :639: `_encode_luma_part` :131 with its lax.scans
// at :175 and :335, `_encode_chroma_dual` :351 with its scans at :402 and
// :488).  This is not a pallas_call: XLA fused each scan step into a few
// device programs, where the port's eager version issued about 319,000
// PyTorch operations per 1088x1920 frame (83% of them the eager inverse
// transforms).  kernels/intra_part.py holds the wrappers and the plain
// PyTorch versions, whose arithmetic these kernels repeat:
//
// - part_chain: the first block row's serial chains, a cluster per plane
//   (luma 16x16 DCT_DCT without rd_zero, :167-176; U and V 8x8 ADST_DCT
//   with rd_zero, :397-403): per column the flat prediction from the
//   carried pixel, the forward product, the quantize, the dequantize, the
//   2-D inverse, the recon and the carry of rec[0, n - 1];
// - part_pred: a stage's candidates from the row above (the last row of
//   the recon coded so far): V, D45 and D67 from the above edge with
//   above-right (`_edges` :73, intra_v._directional_pred) at the luma 16
//   and 32 sites, V_PRED alone at the luma 64 and every chroma site; the
//   residuals (float32, the forward product's operand) and the
//   predictions (int32);
// - part_code: after the forward product (a cuBLAS matmul outside, as the
//   JAX package leaves it to XLA), per column the deadzone quantize and
//   rd_zero of every candidate, the coefficient-domain distortion times
//   1/_RATIO and log2_rate plus the mode bits, the argmin (first index on
//   a tie), the dequantize (lv*q, or >>1 at 32 and >>2 at 64 with the
//   coded 32x32 top-left), the 2-D inverse, the recon clip and, at the
//   64 site, the pixel SSE (int32, wrapping) and its cost;
// - part_merge: the split decisions of one half of a superblock row, per
//   superblock column: the 16s against the 32 (luma: cost_16s < cost32;
//   chroma: luma's split grid), the losing levels zeroed, the winner's
//   recon in the frame, the selection's pixel SSE and rate (the region's
//   cost); after the second half, the 64 against its four 32-regions
//   (luma: cost_sub < cost64; chroma: luma's split64) the same way.
//
// What bounds it on an H100.  A 1088x1920 probed frame is about 0.5 GB of
// fp32 forward-product operations (done by cuBLAS), about 40 MB of
// candidate residuals and coefficients through device memory, and some
// 30 M integer butterfly operations: tens of microseconds at the card's
// rates.  The floor is the dependency chain: the first row's 120 serial
// columns (each a 256-deep chain of dependent FMAs per coefficient, the
// quantize, an exchange and the 2-D inverse), and
// per superblock row eight dependent stages per plane (pred, product,
// code at the top 16-row with the 32 and 64, then at the bottom 16-row,
// the merge, and again for the second 32-row), about 20 launches of a few
// microseconds.
//
// What the design does about it.  Every launch takes every site that the
// stage codes (U and V together), as a list of jobs in the kernel's
// parameters; the outputs go straight into the frame's level, mode, split
// and recon grids, so the row above a stage is a row of the recon plane
// and nothing is copied between stages.
//
// part_pred and part_merge.  Each launch moves a few hundred KB and does
// almost no arithmetic (a 1088x1920 probed frame: 52.6 us of bytes for
// part_pred's 134 launches, 25.4 us for part_merge's 66, PERF.md), so a
// launch costs its fixed overhead and its longest chain of dependent
// memory round trips.  Their first versions lost most of that: part_pred
// launched a CTA per (candidate, column) on a (max columns x jobs) grid,
// about half of it empty, each CTA reloading the edge and the source
// between two dependent round trips with 4-byte stores; part_merge ran 30
// (chroma 60) CTAs, each walking seven dependent steps through device
// memory per region (copy the winner, read it back for the SSE, read the
// levels, three two-barrier sums, write the cost, read it back for the
// 64, then 2-byte zeroing).  Now:
// - both launch with programmatic stream serialization (griddepcontrol):
//   a launch starts while its predecessor finishes, loads what no kernel
//   still running writes (part_pred its source band; part_merge the luma
//   source, the big site's band and cost, the first half's region costs),
//   then waits; part_chain and part_merge let their dependents start at
//   once (launch_dependents), so the next kernel's loads overlap their
//   tails; part_code does not (its dependents' CTAs, resident early, cost
//   the probe's sequence more than their early loads saved: PERF.md);
// - part_pred: a flat grid of exactly the jobs' CTAs, the 64 site first;
//   a thread takes a 16-byte quad of a column and builds every candidate
//   of it from one edge load and one source load, 16-byte stores of pred
//   and resid; 16 8x8 or 4 16x16 columns share a CTA, so no warp idles;
// - part_merge: a cluster of MERGE_CL = 2 CTAs per superblock column, one
//   per region of the half; after the wait one cp.async burst brings the
//   costs, both candidates' recon of the region and (luma) the small and
//   mid levels; the split is decided first, the loser zeroed, the SSE and
//   the rates taken in shared memory (nothing the CTA writes is read
//   back), one barrier for all five sums; with do_big the two region
//   costs meet in both CTAs' shared memory behind one cluster barrier,
//   both decide the 64 from the same terms, and each writes its half of
//   the window, the levels and the splits once; every store 16 bytes.
// What still bounds them: the launch itself and, after the wait, one
// round trip for the inputs; part_merge's do_big launches a second one
// for the cluster barrier.
//
// part_chain.  A plane's 120 columns are a chain through one carried
// pixel.  Read through the cache by one CTA, the luma forward matrix (256
// KB) would cross one SM from L2 every column, a dependent 1 KB row at a
// time: about 9.9 us a column, 1.19 ms a probed 1088x1920 frame.  So each
// plane is a cluster of CHAIN_CL CTAs, each holding a quarter of the
// forward matrix (64 KB for luma) in shared memory, loaded once; per
// column only the chain is on the critical path: the residual from the
// carried edge (the source is in registers two columns ahead), each
// CTA's slice of coefficients from shared memory (the product fully
// unrolled, so its loads run ahead of the FMAs), the quantize with the
// position's table entries held in registers, the dequantized slice sent
// into every CTA of the cluster (st.async into the block of the column's
// parity, completing on that block's mbarrier: no cluster barrier, whose
// release would wait for the column's global stores and prefetches),
// then in every CTA the 2-D inverse and the next edge; each CTA writes
// its positions' levels and recon.  About 1.9 us a luma column against
// 0.52 us of dependent FMAs (PERF.md): the inverse, the quantize and the
// exchange's round trip take the rest.  Each coefficient keeps the first
// version's sum, fmaf over k = 0..nn-1 in order from 0 on one thread, so
// every level and pixel is the first version's bit for bit.
//
// part_code.  A launch fills 30 to 420 CTAs, so it costs as long as its
// slowest CTA's chain of dependent steps, not its bytes.  Its first
// version gave every column a CTA on a (max columns x jobs) grid: the
// 64-point inverse (64 lines of a serial idct64 each holding 128 words)
// set 105 registers for every site, two CTAs per SM, so a launch of more
// than 264 CTAs ran in two waves, the 64 and 32 columns last; an 8x8
// column waited on five round trips to memory in turn (coefficients, the
// rate table, the dequantizer, the prediction, the source).  Per 1088x1920
// probed frame 1.53 ms, against 5.9 us for a launch of trivial 8x8
// columns and 23.2 us for the 16+32+64 launch (PERF.md, part_code per
// launch kind).  Now:
// - a flat grid of exactly the jobs' CTAs, the 64 columns first, then the
//   32, 16 and 8, so the longest chains start first and no CTA is empty;
//   four 8x8 columns share a CTA (two warps each), so no launch overfills
//   the card's resident CTAs;
// - each column sends its candidates' coefficients to shared memory by
//   cp.async, all in flight at once, then their predictions (and at the
//   64 its source band), which arrive while it quantizes; the site's
//   table entries at its positions go to registers in one burst and the
//   rate table's first entries (the only ones rd_zero reads) to shared
//   memory: the quantize and the recon wait on no load in turn;
// - a column whose chosen candidate has no level skips its inverse (its
//   residual is 0; most 16x16 and 8x8 columns of the main path: PERF.md),
//   and TX_64X64 no longer zeroes its block: the inverse reads only the
//   coded 32 x 32;
// - the 32- and 64-point lines run as two halves on two warps each
//   (itx.cuh's idct16 / idct32 of the even inputs, idct32_odd /
//   idct64_odd of the odd ones), meeting in shared memory, where every
//   thread adds them: no thread holds a 64-point line, and a 64 column's
//   passes run on 64 and 128 threads instead of 32 and 64;
// - the 8x8 and 16x16 inverses stay inverse_2d (a thread per line).
//
// Bits.  part_merge's rates keep the first version's order (element p of
// the small pair or of the mid block on thread p mod 256 as its
// (p div 256)-th addend, the warps' butterflies, then the warps in order;
// the loser's zeroed levels, which that version added as +0.0, are left
// out), so every region cost and decision is the first version's bit for
// bit.  part_code's sums keep the first version's order: element
// e = m * nc + j of a column on thread e mod 256 as its (e div 256)-th
// addend, the warps' butterflies, then the warps in order (at 8x8 a
// column's two warps: the other six added +0.0 to sums that are not
// negative); its outputs are the first version's bit for bit.
// Every float expression of a decision is written with __fmul_rn,
// __fadd_rn, __fsub_rn and IEEE division (nvcc would contract a*b + c into
// an FMA); log2f is the library's (no fast math), as torch.log2 on the
// card.  The SSEs are integer sums.  What cannot match: the per-candidate
// distortion and rate and the region's rate are float32 sums in another
// order than PyTorch's, and part_chain's forward product in another order
// than cuBLAS's, so a level may flip by 1 at a rounding boundary and a
// decision may flip at a near-tie (chip_smoke.py phase 7e counts both).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>

#include <cooperative_groups.h>

#include "itx.cuh"

namespace cg = cooperative_groups;

// kernels/intra_part.py:PartSiteC, field for field, as each job struct
// below (av1_part_layout lets the wrapper check that; outside the anonymous
// namespace: the C entry points take them, and must keep external linkage)
struct PartSite {
  const float *step, *off, *gain, *tab;   // gain, tab null: no rd_zero
  const int *q, *cap;
  float lam, inv_ratio;
  int n, tx, dq_shift, nm, cost, pix_max;  // cost: 0 none, 1 coefficient
                                           // domain, 2 pixel domain
};

// kernels/intra_part.py:ChainJobC
struct ChainJob {
  PartSite s;
  const float* fwdt;     // (n*n, n*n): coefs = resid @ fwdt
  const int* src;        // the plane's first n rows
  int16_t* lv;           // (cols, n*n): row 0 of the level grid
  int* rec;              // the recon plane's first n rows
  int cols, width, edge0;
};

// kernels/intra_part.py:PredJobC
struct PredJob {
  const int* bottom;     // the row above the site, `width` pixels
  const int* src;        // the site's band of the source: n rows
  const uint8_t* av;     // (cols,) above-right available; null: V_PRED only
  float* resid;          // (nm * cols, n*n): candidate m of column c at
  int* pred;             // row m * cols + c
  int n, nm, cols, width;
};

// kernels/intra_part.py:CodeJobC
struct CodeJob {
  PartSite s;
  const float* coefs;    // (nm * cols, nc), nc = min(n, 32)^2
  const int* pred;       // (nm * cols, n*n)
  const int* src;        // the site's band of the source (pixel cost)
  int16_t* lv;           // (cols, nc): the chosen candidate's levels
  int* rec;              // the chosen candidate's recon: a band of n rows
  int8_t* modes;         // (cols,) or null
  float* cost;           // (cols,) or null
  float* rate;           // (nm, cols) each candidate's log2 rate, or null
  int cols, width;
};

// kernels/intra_part.py:MergeJobC
struct MergeJob {
  int16_t *lv_s, *lv_m, *lv_b;  // the plane's level grids: small (ns),
                                // mid (2 ns), big (32x32 coded)
  int* recon;                   // the plane's recon
  const int* src;               // the plane's source (luma: the SSE)
  const int *rec_m, *rec_b;     // the mid site's recon band of this half,
                                // the big site's (do_big)
  uint8_t *split, *split64;     // luma writes them, chroma reads luma's
  const float *cost_s, *cost_m, *cost_b;  // luma; null for chroma
  float* cost_region;           // luma: (2, cols_m), this row's halves
  float lam, lam_split;
  int ns, width, sb_row, half, do_big;
};

namespace {

constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;
constexpr int MAXJ = 6;          // jobs per launch: U and V, 3 sites each
constexpr int KEEP_ALWAYS = 8;   // rdoq._KEEP_ALWAYS
// part_chain: CTAs per plane (a cluster), each holding a quarter of the
// forward matrix, and threads per CTA (a luma coefficient each)
constexpr int CHAIN_CL = 4;
constexpr int CHAIN_NT = 256 / CHAIN_CL;

struct ChainJobs { ChainJob j[3]; };
// part_pred's and part_code's jobs, heaviest size first, and each job's
// first CTA of the flat grid (first[count] .. first[MAXJ]: the grid's end)
struct PredJobs { PredJob j[MAXJ]; int first[MAXJ + 1]; };
struct CodeJobs { CodeJob j[MAXJ]; int first[MAXJ + 1]; };
struct MergeJobs { MergeJob j[2]; };
// part_merge: CTAs per superblock column (a cluster), one per region (the
// 32x32, chroma 16x16, blocks of the half)
constexpr int MERGE_CL = 2;

// the candidates' mode values and mode bits (intra_part._mode_rdo: V, then
// intra_v._RDO_MODES' D45 and D67)
__constant__ int8_t kModeVals[3] = {1, 3, 8};
__constant__ float kModeBits[3] = {0.f, 4.f, 4.f};
__constant__ int kModeDx[3] = {0, 64, 27};

// The deadzone quantize of one coefficient (intra_v.quantize_with_offsets),
// then rdoq.rd_zero's keep test where the site has a rate table (tab: at
// least its first KEEP_ALWAYS entries; null: no rd_zero), from the table
// entries of its position: step, off, cap and gain.
__device__ __forceinline__ int quant_rdz_at(float coef, float step, float off,
                                            int cap, float gain,
                                            const float* tab, float lam) {
  const float ca = fabsf(coef);
  const int mag = (int)floorf(__fadd_rn(__fdiv_rn(ca, step), off));
  const int sgn = coef > 0.f ? 1 : (coef < 0.f ? -1 : 0);
  const int lv = min(max(sgn * mag, -cap), cap);
  const int a = abs(lv);
  if (tab == nullptr || a == 0 || a >= KEEP_ALWAYS) return lv;
  const float t = __fsub_rn(ca, __fmul_rn((float)a, step));
  const float save = __fmul_rn(gain, __fsub_rn(__fmul_rn(ca, ca),
                                               __fmul_rn(t, t)));
  const float bits = __fsub_rn(tab[a], tab[0]);
  return save > __fmul_rn(lam, bits) ? lv : 0;
}

// intra_v.log2_rate of one level: 2 + log2(1 + |l|) where l != 0
__device__ __forceinline__ float level_rate(int lv) {
  if (lv == 0) return 0.f;
  return __fadd_rn(2.f, log2f(__fadd_rn(1.f, (float)abs(lv))));
}

// The dequantize sign(lv) * ((|lv| * q) >> shift) as int32 bits.
__device__ __forceinline__ u32 dequant(int lv, int q, int shift) {
  const u32 d = ((u32)abs(lv) * (u32)q) >> shift;
  return lv < 0 ? 0u - d : d;
}

__device__ __forceinline__ float sum2(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ long long sum2(long long a, long long b) {
  return a + b;
}

// Sums of K values over the W * 32 threads of a column group (W warps from
// warp (warp / W) * W; W = NW: the whole block), in a fixed order: warp
// butterflies, then the group's warps in order.  For float sums that are
// not negative a group of fewer warps gives the same bits as the whole
// block would with +0.0 in its other warps; integer sums are exact in any
// order.  Every thread of the block calls it and gets its group's sums;
// red: K * NW.
template <int K, class T>
__device__ void group_sum(T* v, T* red, int W) {
  for (int k = 0; k < K; ++k)
    for (int o = 16; o; o >>= 1)
      v[k] = sum2(v[k], __shfl_xor_sync(~0u, v[k], o));
  __syncthreads();
  const int warp = threadIdx.x >> 5, g0 = warp / W * W;
  if ((threadIdx.x & 31) == 0)
    for (int k = 0; k < K; ++k) red[k * NW + warp] = v[k];
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    T s = red[k * NW + g0];
    for (int w = 1; w < W; ++w) s = sum2(s, red[k * NW + g0 + w]);
    v[k] = s;
  }
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most PENDING of the thread's committed groups are in flight
template <int PENDING>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// ---- programmatic dependent launch ----

// A kernel launched with the programmatic-stream-serialization attribute
// may start while the previous kernel of the stream still runs (once that
// kernel's CTAs have all called launch_dependents, or ended).  Until
// wait_primary it may read only what no kernel still running writes, and
// it writes nothing.  After wait_primary the previous kernel has ended and
// its stores are visible, and so has every earlier one: a kernel ends only
// after its own wait, and one launched without the attribute starts only
// after every earlier one has ended.  Without the attribute both are
// no-ops.
__device__ __forceinline__ void wait_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

// One half of a 1-D inverse DCT of N points (N = 32, 64) on a line of
// shared memory, inputs src[k * step] for k < K (the rest zero): the even
// half, idct{N/2} of the even inputs, into dst[0 .. N/2), or (ODD) the odd
// half, idct{N}_odd of the odd inputs, into dst[N/2 .. N).
template <int N, int K, bool ODD>
__device__ __forceinline__ void half_line(const u32* src, int step,
                                          u32* dst) {
  constexpr int H = N / 2;
  u32 in[H], out[H];
#pragma unroll
  for (int k = 0; k < H; ++k)
    in[k] = 2 * k + ODD < K ? src[(2 * k + ODD) * step] : 0u;
  if constexpr (ODD) {
    if constexpr (N == 32) idct32_odd(in, out);
    else idct64_odd(in, out);
  } else {
    if constexpr (N == 32) idct16(in, out);
    else idct32(in, out);
  }
#pragma unroll
  for (int k = 0; k < H; ++k) dst[ODD * H + k] = out[k];
}

// The 2-D inverse DCT of one N x N block (N = 32, 64) in shared memory at
// row stride LD = N + 1: the top-left 32 x 32 holds the dequantized levels
// (the rest is never read: TX_64X64 codes 32 x 32) and is replaced by the
// residual.  Each line's two halves run on two warps (even and odd halves
// on different warps, so no warp diverges) into `half` (lines at stride
// LD), and then every thread adds them: idct32's and idct64's butterflies
// and roundings, and _ROW_SHIFT 2 and 4, as inverse_2d applies them.
template <int N>
__device__ void inverse_split(u32* buf, u32* half) {
  constexpr int K = 32, H = N / 2, LD = N + 1;
  const int t = threadIdx.x;
  if (t < K) half_line<N, K, false>(buf + t * LD, 1, half + t * LD);
  else if (t < 2 * K)
    half_line<N, K, true>(buf + (t - K) * LD, 1, half + (t - K) * LD);
  __syncthreads();
  for (int p = t; p < K * H; p += NT) {      // the coded rows
    const int r = p / H, i = p % H;
    const u32* hr = half + r * LD;
    buf[r * LD + i] = rs(hr[i] + hr[2 * H - 1 - i], 2);
    buf[r * LD + H + i] = rs(hr[H - 1 - i] - hr[H + i], 2);
  }
  __syncthreads();
  if (t < N) half_line<N, K, false>(buf + t, LD, half + t * LD);
  else if (t < 2 * N)
    half_line<N, K, true>(buf + t - N, LD, half + (t - N) * LD);
  __syncthreads();
  for (int p = t; p < N * H; p += NT) {      // every column
    const int col = p / H, i = p % H;
    const u32* hc = half + col * LD;
    buf[i * LD + col] = rs(hc[i] + hc[2 * H - 1 - i], 4);
    buf[(H + i) * LD + col] = rs(hc[H - 1 - i] - hc[H + i], 4);
  }
  __syncthreads();
}

// part_code's layout at size N: COLS columns per CTA (four 8x8 columns
// share one, each on two warps), VT threads per column, MAXK coefficients
// per thread, and the dynamic shared memory of a CTA: per column the block
// and its scratch (N x (N + 1) words each), the candidates' predictions
// and, for the pixel cost, the source, and the candidates' coefficients.
// kernels/intra_part.py:code_ctas and code_smem mirror it.
template <int N>
struct CodeLayout {
  static constexpr int COLS = N == 8 ? 4 : 1, VT = NT / COLS;
  static constexpr int CW = N < 32 ? N : 32, NC = CW * CW, NP = N * N;
  static constexpr int LD = N + 1, BUF = N * LD;
  // the candidates' coefficients per thread: nm is 1 at 8 and 64
  static constexpr int MAXK = ((N == 8 || N == 64 ? 1 : 3) * NC + VT - 1)
                              / VT;
  // a thread's coefficient positions: j = tl + q VT, q < JQ
  static constexpr int JQ = NC >= VT ? NC / VT : 1;
  static constexpr int smem(int nm, int cost) {
    return 4 * COLS * (2 * BUF + nm * NP + (cost == 2 ? NP : 0) + nm * NC);
  }
};

// ---- part_chain: a cluster of CHAIN_CL CTAs per plane walks its first
// block row ----

// part_chain's dynamic shared memory for a plane of n x n blocks, in
// words: this CTA's slice of the forward matrix (every row, n*n / CHAIN_CL
// columns), the residual, the dequantized block of each column parity,
// the inverse's scratch and rd_zero's first table entries.
__host__ __device__ constexpr int chain_words(int n) {
  return n * n * (n * n / CHAIN_CL) + n * n + 3 * n * (n + 1) + KEEP_ALWAYS;
}

// part_chain's exchange.  Each column's dequantized slices go to every CTA
// of the cluster by st.async, each word completing (4 bytes) on the
// receiving CTA's mbarrier of the column's parity, which expects the whole
// block: a CTA waits on its own mbarrier for the block, and on no
// barrier of the cluster.  A cluster barrier would release every memory
// access before it, so each column would wait for its own global stores
// and prefetches; an mbarrier's wait waits only for the block.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bars_visible() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this CTA's arrival on its mbarrier with the phase's bytes to come
__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT_BLOCK:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n"
      "@P1 bra DONE_BLOCK;\n"
      "bra WAIT_BLOCK;\n"
      "DONE_BLOCK:\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// *dst = v in CTA `rank` of the cluster, completing on its *bar
__device__ __forceinline__ void send_word(u32* dst, u32 v,
                                          unsigned long long* bar, int rank) {
  uint32_t d, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d) : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(b) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];\n" ::"r"(d), "r"(v), "r"(b) : "memory");
}

// this thread's reads of a block done before a peer's next st.async to it
__device__ __forceinline__ void reads_before_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One plane's chain on the cluster: CTA `rank` codes the positions
// [rank * SL, (rank + 1) * SL), a thread each, from its slice of the
// forward matrix in shared memory; each column's dequantized slices meet
// in every CTA's block of that column's parity, where every CTA runs the
// 2-D inverse and takes the next edge.  A CTA sends column c + 2 into a
// peer's block of parity c only after that peer's slice of column c + 1
// has reached it, which the peer sent after its last read of the block:
// two blocks and their mbarriers suffice.
template <int N>
__device__ void chain_plane(const ChainJob& C, float* smem,
                            unsigned long long* bars) {
  constexpr int NN = N * N, SL = NN / CHAIN_CL, LD = N + 1, BUF = N * LD;
  constexpr int PER = (NN + CHAIN_NT - 1) / CHAIN_NT;   // sources a thread
  static_assert(SL <= CHAIN_NT && SL % 4 == 0, "a coefficient a thread");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), t = threadIdx.x;
  const PartSite& S = C.s;
  float* s_fwd = smem;                  // NN rows x SL columns
  float* s_res = s_fwd + NN * SL;
  u32* s_dq = reinterpret_cast<u32*>(s_res + NN);   // two blocks
  u32* s_tmp = s_dq + 2 * BUF;
  float* s_tab = reinterpret_cast<float*>(s_tmp + BUF);
  for (int e = t; e < NN * SL / 4; e += CHAIN_NT) {
    const int k = e / (SL / 4), q4 = e % (SL / 4);
    reinterpret_cast<float4*>(s_fwd)[e] = __ldg(
        reinterpret_cast<const float4*>(C.fwdt + (size_t)k * NN + rank * SL)
        + q4);
  }
  const bool rdz = S.tab != nullptr;
  if (rdz && t < KEEP_ALWAYS) s_tab[t] = S.tab[t];
  if (t == 0) {
    bar_init(bars);
    bar_init(bars + 1);
    bars_visible();
  }
  // the position this thread codes and its table entries, in registers
  const bool coder = t < SL;
  const int pos = rank * SL + t, at = (pos / N) * LD + pos % N;
  float step = 0.f, off = 0.f, gain = 0.f;
  int cap = 0, q = 0;
  if (coder) {
    step = S.step[pos];
    off = S.off[pos];
    cap = S.cap[pos];
    q = S.q[pos];
    if (rdz) gain = S.gain[pos];
  }
  // the source of a column: element e = t + r CHAIN_NT (row e / N, column
  // e % N of the block), two columns ahead in registers
  const int cols = C.cols;
  auto fetch = [&](int col, int* x) {
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int e = t + r * CHAIN_NT;
      if (e < NN && col < cols)
        x[r] = __ldg(C.src + (size_t)(e / N) * C.width + col * N + e % N);
    }
  };
  int edge = C.edge0;
  auto column = [&](int c, int* x) {
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int e = t + r * CHAIN_NT;
      if (e < NN) s_res[e] = (float)(x[r] - edge);
    }
    __syncthreads();
    const int b = c & 1;
    u32* buf = s_dq + b * BUF;
    if (t == 0) bar_expect(bars + b, 4 * NN);
    int lv = 0;
    if (coder) {
      // coefficient pos: column pos of the forward matrix, in order
      float acc = 0.f;
      const float* f = s_fwd + t;
#pragma unroll      // the loads run ahead of the chain
      for (int k = 0; k < NN; k += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(s_res + k);
        acc = fmaf(r4.x, f[(k + 0) * SL], acc);
        acc = fmaf(r4.y, f[(k + 1) * SL], acc);
        acc = fmaf(r4.z, f[(k + 2) * SL], acc);
        acc = fmaf(r4.w, f[(k + 3) * SL], acc);
      }
      lv = quant_rdz_at(acc, step, off, cap, gain, rdz ? s_tab : nullptr,
                        S.lam);
      const u32 dq = (u32)lv * (u32)q;
#pragma unroll
      for (int r = 0; r < CHAIN_CL; ++r) send_word(buf + at, dq, bars + b, r);
    }
    // off the chain: the level out, the source of column c + 2
    if (coder) C.lv[(size_t)c * NN + pos] = (int16_t)lv;
    fetch(c + 2, x);
    bar_wait(bars + b, (c >> 1) & 1);
    inverse_2d<N>(S.tx, 1, buf, s_tmp, 0, LD);
    if (coder)
      C.rec[(size_t)(pos / N) * C.width + c * N + pos % N] =
          min(max(edge + (int)buf[at], 0), S.pix_max);
    edge = min(max(edge + (int)buf[N - 1], 0), S.pix_max);  // rec[0, N-1]
    reads_before_async();
  };
  int xa[PER], xb[PER];
  fetch(0, xa);
  fetch(1, xb);
  cluster.sync();   // the slices, tables and mbarriers in place everywhere
  for (int c = 0; c < cols; c += 2) {
    column(c, xa);
    if (c + 1 < cols) column(c + 1, xb);
  }
  cluster.sync();   // no CTA leaves while a peer may still send to it
}

__global__ void __launch_bounds__(CHAIN_NT) part_chain_kernel(ChainJobs J) {
  launch_dependents();
  extern __shared__ __align__(16) float s_chain[];
  __shared__ unsigned long long s_bars[2];    // the blocks' mbarriers
  const ChainJob& C = J.j[blockIdx.x / CHAIN_CL];
  if (C.s.n == 16) chain_plane<16>(C, s_chain, s_bars);
  else chain_plane<8>(C, s_chain, s_bars);
}

// ---- part_pred: a flat grid of the jobs' CTAs, a column's candidates in
// one CTA ----

// part_pred's layout at size N: a thread takes the 16-byte quads u of a
// column's block (pixels 4u .. 4u + 3 in raster order) and builds every
// candidate of each; COLS columns share a CTA (16 at 8x8, 4 at 16x16, so
// that every thread has a quad), PER quads a thread (4 at 64x64).
// kernels/intra_part.py:PRED_COLS and pred_ctas mirror it.
template <int N>
struct PredLayout {
  static constexpr int QUADS = N * N / 4;
  static constexpr int COLS = QUADS >= NT ? 1 : NT / QUADS;
  static constexpr int PER = QUADS > NT ? QUADS / NT : 1;
  static_assert(COLS * 2 * N <= NT, "a thread per edge pixel");
};

// COLS columns of one job from column c0: quad u = t + k NT of the CTA is
// quad u % QUADS of column c0 + u / QUADS.  Before the wait the source
// quads go to registers (nothing in the stream writes the source); after
// it, the edges (the row above is the recon the previous kernel wrote)
// go to shared memory in one coalesced load, and every candidate of each
// quad is stored as 16-byte pieces of pred and resid.
template <int N>
__device__ void pred_columns(const PredJob& P, int c0, int* ae) {
  using L = PredLayout<N>;
  constexpr int LAST = 2 * N - 1;
  const int t = threadIdx.x, cols = P.cols, W = P.width;
  int4 src[L::PER];
  int c[L::PER], p4[L::PER];
#pragma unroll
  for (int k = 0; k < L::PER; ++k) {
    const int u = t + k * NT;
    c[k] = c0 + u / L::QUADS;
    p4[k] = u % L::QUADS;
    if (c[k] < cols)
      src[k] = __ldg(reinterpret_cast<const int4*>(
          P.src + (size_t)(4 * p4[k] / N) * W + c[k] * N + 4 * p4[k] % N));
  }
  // intra_part._edges: edge pixel e of column ec, above-right replicated
  // where it is not available (the row is padded with its last pixel)
  const int ec = c0 + t / (2 * N), e = t % (2 * N);
  const bool edge = t < L::COLS * 2 * N && ec < cols;
  const bool avail = edge && (e < N || (P.av != nullptr && P.av[ec]));
  wait_primary();
  if (edge)
    ae[t] = __ldcg(P.bottom + (avail ? min(ec * N + e, W - 1)
                                     : ec * N + N - 1));
  __syncthreads();
#pragma unroll
  for (int k = 0; k < L::PER; ++k) {
    if (c[k] >= cols) continue;
    const int* a = ae + (c[k] - c0) * 2 * N;
    const int i = 4 * p4[k] / N, j0 = 4 * p4[k] % N;
    const int sv[4] = {src[k].x, src[k].y, src[k].z, src[k].w};
    for (int m = 0; m < P.nm; ++m) {
      const int dx = kModeDx[m];
      int pr[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + q;
        if (m == 0) {
          pr[q] = a[j];
        } else {   // intra_v._directional_pred: zone 1 on the above edge
          const int idx = (i + 1) * dx, pos = (idx >> 6) + j;
          if (pos >= LAST) {
            pr[q] = a[LAST];
          } else {
            const int sh = (idx >> 1) & 0x1F;
            pr[q] = (a[pos] * (32 - sh) + a[pos + 1] * sh + 16) >> 5;
          }
        }
      }
      const size_t row = ((size_t)m * cols + c[k]) * N * N + 4 * p4[k];
      *reinterpret_cast<int4*>(P.pred + row) =
          make_int4(pr[0], pr[1], pr[2], pr[3]);
      *reinterpret_cast<float4*>(P.resid + row) = make_float4(
          (float)(sv[0] - pr[0]), (float)(sv[1] - pr[1]),
          (float)(sv[2] - pr[2]), (float)(sv[3] - pr[3]));
    }
  }
}

__global__ void __launch_bounds__(NT) part_pred_kernel(PredJobs J) {
  int k = 0;
  while (k + 1 < MAXJ && (int)blockIdx.x >= J.first[k + 1]) ++k;
  const PredJob& P = J.j[k];
  __shared__ int ae[NT];           // the CTA's columns' edges, 2N each
  const int b = blockIdx.x - J.first[k];
  switch (P.n) {
    case 8: pred_columns<8>(P, PredLayout<8>::COLS * b, ae); break;
    case 16: pred_columns<16>(P, PredLayout<16>::COLS * b, ae); break;
    case 32: pred_columns<32>(P, b, ae); break;
    default: pred_columns<64>(P, b, ae); break;
  }
}

// ---- part_code: a CTA per column of a site (per four at 8x8) ----

// One CTA's columns of one job: COLS columns from c0, column g on threads
// [g VT, (g + 1) VT).
template <int N>
__device__ void code_columns(const CodeJob& C, int c0, float* s_tab,
                             float* s_red, long long* s_lred) {
  using L = CodeLayout<N>;
  constexpr int CW = L::CW, NC = L::NC, NP = L::NP, LD = L::LD,
                BUF = L::BUF, VT = L::VT;
  const PartSite& S = C.s;
  const int t = threadIdx.x, g = t / VT, tl = t % VT, nm = S.nm;
  const int c = c0 + g;
  const bool live = c < C.cols;
  extern __shared__ __align__(16) u32 s_dyn[];
  u32* s_buf = s_dyn + g * BUF;                      // COLS blocks, then
  u32* s_half = s_dyn + L::COLS * BUF;               // their scratch,
  int* s_pred = reinterpret_cast<int*>(s_dyn + 2 * L::COLS * BUF)
                + g * nm * NP;                       // the candidates,
  int* s_src = reinterpret_cast<int*>(s_dyn + 2 * L::COLS * BUF)
               + L::COLS * nm * NP + g * NP;         // the source,
  float* s_coef = reinterpret_cast<float*>(s_dyn + 2 * L::COLS * BUF)
                  + L::COLS * (nm + (S.cost == 2)) * NP
                  + g * nm * NC;                     // the coefficients

  // every candidate's coefficients, all in flight at once; then, on their
  // way while the column quantizes, its predictions and, for the pixel
  // cost, the source band
  if (live)
    for (int i = tl; i < nm * NC / 4; i += VT) {
      const int m = i / (NC / 4), q = 4 * (i % (NC / 4));
      copy16(s_coef + m * NC + q,
             C.coefs + ((size_t)m * C.cols + c) * NC + q);
    }
  copy_commit();
  if (live) {
    for (int i = tl; i < nm * NP / 4; i += VT) {
      const int m = i / (NP / 4), q = 4 * (i % (NP / 4));
      copy16(s_pred + m * NP + q, C.pred + ((size_t)m * C.cols + c) * NP + q);
    }
    if (S.cost == 2)
      for (int i = tl; i < NP / 4; i += VT) {
        const int p = 4 * i;
        copy16(s_src + p, C.src + (size_t)(p / N) * C.width + c * N + p % N);
      }
  }
  copy_commit();
  if (S.tab != nullptr && t < KEEP_ALWAYS) s_tab[t] = S.tab[t];
  // the site's tables at the thread's positions, all loads in flight
  float stp[L::JQ], off[L::JQ], gn[L::JQ];
  int cap[L::JQ], qv[L::JQ];
#pragma unroll
  for (int q = 0; q < L::JQ; ++q) {
    const int j = tl + q * VT;
    stp[q] = S.step[j];
    off[q] = S.off[j];
    cap[q] = S.cap[j];
    qv[q] = S.q[j];
    gn[q] = S.gain != nullptr ? S.gain[j] : 0.f;
  }
  copy_wait<1>();                // the coefficients
  __syncthreads();
  const float* tab = S.tab != nullptr ? s_tab : nullptr;

  // every candidate's levels; element e = m * NC + j of the column on its
  // thread tl = e mod VT, as its (e div VT)-th addend
  int lvr[L::MAXK];
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};   // dist, then rate
#pragma unroll
  for (int k = 0; k < L::MAXK; ++k) {
    const int e = tl + k * VT, q = k % L::JQ;
    lvr[k] = 0;
    if (!live || e >= nm * NC) continue;
    const int m = e / NC;
    const float coef = s_coef[e];
    const int lv = quant_rdz_at(coef, stp[q], off[q], cap[q], gn[q], tab,
                                S.lam);
    lvr[k] = lv;
    const float d = __fsub_rn(coef, __fmul_rn((float)lv, stp[q]));
    const float rt = level_rate(lv);
#pragma unroll
    for (int mm = 0; mm < 3; ++mm) {    // m in registers: no local memory
      if (mm != m) continue;
      acc[mm] = __fadd_rn(acc[mm], __fmul_rn(d, d));
      acc[3 + mm] = __fadd_rn(acc[3 + mm], rt);
    }
  }
  if (S.cost != 0 || C.rate != nullptr) group_sum<6>(acc, s_red, VT / 32);

  // the argmin over the candidates, strict < (the first on a tie)
  int best = 0;
  float best_cost = 0.f;
  if (S.cost == 1) {
    for (int m = 0; m < 3; ++m) {
      if (m >= nm) break;
      const float dist = __fmul_rn(acc[m], S.inv_ratio);
      const float rate = __fadd_rn(acc[3 + m], kModeBits[m]);
      const float cost = __fadd_rn(dist, __fmul_rn(S.lam, rate));
      if (m == 0 || cost < best_cost) {
        best = m;
        best_cost = cost;
      }
    }
  }

  // the chosen candidate's levels out, dequantized into shared memory
  int nz = 0;
#pragma unroll
  for (int k = 0; k < L::MAXK; ++k) {
    const int e = tl + k * VT;
    if (e >= nm * NC || e / NC != best) continue;
    const int j = e % NC;
    if (live) C.lv[(size_t)c * NC + j] = (int16_t)lvr[k];
    s_buf[(j / CW) * LD + j % CW] = dequant(lvr[k], qv[k % L::JQ],
                                            S.dq_shift);
    nz |= lvr[k];
  }
  // no level in any column of the CTA: every residual is 0, no inverse
  if (__syncthreads_or(nz)) {
    if constexpr (N <= 16)
      inverse_2d<N>(S.tx, L::COLS, s_dyn, s_half, BUF, LD);
    else
      inverse_split<N>(s_buf, s_half);
    nz = 1;
  }
  copy_wait<0>();                // the predictions and the source
  __syncthreads();

  // recon; the pixel SSE where the site's cost is pixel-domain
  const int* pred = s_pred + best * NP;
  long long sse[1] = {0};
  if (live)
    for (int p = tl; p < NP; p += VT) {
      const int i = p / N, j = p % N;
      const int r = nz ? (int)s_buf[i * LD + j] : 0;
      const int rec = min(max(pred[p] + r, 0), S.pix_max);
      C.rec[(size_t)i * C.width + c * N + j] = rec;
      if (S.cost == 2) {
        const int e = rec - s_src[p];
        sse[0] += e * e;
      }
    }
  if (S.cost == 2) {
    group_sum<1>(sse, s_lred, VT / 32);
    // summed in int32, wrapping, as the reference's jnp.sum
    best_cost = __fadd_rn(__int2float_rn((int)(u32)sse[0]),
                          __fmul_rn(S.lam, acc[3]));
  }
  if (!live) return;
  if (tl == 0) {
    if (C.modes != nullptr) C.modes[c] = kModeVals[best];
    if (C.cost != nullptr) C.cost[c] = best_cost;
  }
  if (C.rate != nullptr)
    for (int m = 0; m < 3; ++m)
      if (m < nm && tl == m) C.rate[(size_t)m * C.cols + c] = acc[3 + m];
}

__global__ void __launch_bounds__(NT) part_code_kernel(CodeJobs J) {
  int k = 0;
  while (k + 1 < MAXJ && (int)blockIdx.x >= J.first[k + 1]) ++k;
  const CodeJob& C = J.j[k];
  __shared__ float s_tab[KEEP_ALWAYS];
  __shared__ float s_red[6 * NW];
  __shared__ long long s_lred[NW];
  const int b = blockIdx.x - J.first[k];
  switch (C.s.n) {
    case 8:
      code_columns<8>(C, CodeLayout<8>::COLS * b, s_tab, s_red, s_lred);
      break;
    case 16: code_columns<16>(C, b, s_tab, s_red, s_lred); break;
    case 32: code_columns<32>(C, b, s_tab, s_red, s_lred); break;
    default: code_columns<64>(C, b, s_tab, s_red, s_lred); break;
  }
}

// ---- part_merge: a cluster of MERGE_CL CTAs per superblock column ----

// part_merge's shared memory, at luma's sizes (chroma uses the first part
// of each array): the region's source and its recon as the small blocks
// coded it (luma: the SSE), the mid site's recon of the region, this CTA's
// half of the big site's window (do_big), the region's small and mid
// levels (luma: the rates), the warps' partial sums and the half's two
// region costs (luma, do_big: one from each CTA of the cluster).
struct MergeSmem {
  int src[1024], small[1024], mid[1024], big[2048];
  int16_t lvs[1024], lvm[1024];
  float red[3 * NW];
  unsigned ired[2 * NW];
  float cost[MERGE_CL];
};

// cp.async of `quads` 16-byte pieces of a window at *g (its rows `stride`
// elements apart, q pieces a row) into *s, row after row
template <class T>
__device__ __forceinline__ void stage_window(T* s, const T* g, size_t stride,
                                             int quads, int q) {
  constexpr int E = 16 / sizeof(T);
  for (int p = threadIdx.x; p < quads; p += NT)
    copy16(s + E * p, g + (size_t)(p / q) * stride + E * (p % q));
}

// zero nr rows (from r0) of a level grid of `cols` blocks of nc int16 a
// row, blocks c0 .. c0 + nbk - 1 of each, 16 bytes a store
__device__ void zero_levels(int16_t* grid, int cols, int nc, int r0, int nr,
                            int c0, int nbk) {
  const int q = nbk * nc / 8;
  for (int p = threadIdx.x; p < nr * q; p += NT)
    *reinterpret_cast<int4*>(grid + ((size_t)(r0 + p / q) * cols + c0) * nc
                             + 8 * (p % q)) = make_int4(0, 0, 0, 0);
}

// the nr x nx window at row r0, column x0 of the recon from shared memory
// (rows of nx words), 16 bytes a store
__device__ void store_window(int* recon, const int* win, int width, int r0,
                             int nr, int x0, int nx) {
  const int q = nx / 4;
  for (int p = threadIdx.x; p < nr * q; p += NT)
    *reinterpret_cast<int4*>(recon + (size_t)(r0 + p / q) * width + x0
                             + 4 * (p % q)) =
        *reinterpret_cast<const int4*>(win + 4 * p);
}

// barrier.cluster in two halves: the arrival (relaxed: orders nothing, or
// release) and the wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// CTA k of a cluster takes region cm = 2C + k of superblock column C in
// mid row R (the half): its split decision, the loser's levels zeroed, the
// winner's recon, the region's cost (luma); with do_big, its half of the
// 64 (chroma 32) decision's writes, the 64 decided by both CTAs from the
// two region costs exchanged in shared memory.
__global__ void __launch_bounds__(NT) part_merge_kernel(MergeJobs J) {
  __shared__ __align__(16) MergeSmem S;
  const MergeJob& M = J.j[blockIdx.y];
  const int ns = M.ns, nm = 2 * ns, nb = 4 * ns, W = M.width;
  const int cols_s = W / ns, cols_m = W / nm, cols_b = W / nb;
  const int ncs = ns * ns, ncm = nm * nm;
  const int C = blockIdx.x / MERGE_CL, t = threadIdx.x;
  if (C >= cols_b) {      // both CTAs of the cluster
    wait_primary();
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.block_rank(), cm = 2 * C + k;
  const int s = M.sb_row, R = 2 * s + M.half;
  const bool luma = M.cost_m != nullptr, big = M.do_big != 0;
  const bool exchange = luma && big;
  const int q = nm / 4, rq = nm * q;    // a region row's and its quads
  if (exchange) cluster_arrive_relaxed();   // the peer has started by the
                                            // wait before the exchange
  // before the wait, what the stream's previous kernel does not write: the
  // source, the big site's recon and cost (its half-0 stage) and the first
  // half's region costs (its merge)
  if (luma)
    stage_window(S.src, M.src + (size_t)R * nm * W + cm * nm, W, rq, q);
  if (big) stage_window(S.big, M.rec_b + cm * nm, W, nb * q, q);
  copy_commit();
  float r0a = 0.f, r0b = 0.f, cost_b = 0.f;
  if (exchange) {
    r0a = __ldcg(M.cost_region + 2 * C);
    r0b = __ldcg(M.cost_region + 2 * C + 1);
    cost_b = __ldcg(M.cost_b + C);
  }
  launch_dependents();
  wait_primary();

  // one burst: the split's inputs, both candidates' recon of the region
  // and (luma) their levels
  float c0a = 0.f, c0b = 0.f, c1a = 0.f, c1b = 0.f, cmid = 0.f;
  bool split = false, split64 = true;
  if (luma) {
    c0a = __ldcg(M.cost_s + 2 * cm);
    c0b = __ldcg(M.cost_s + 2 * cm + 1);
    c1a = __ldcg(M.cost_s + cols_s + 2 * cm);
    c1b = __ldcg(M.cost_s + cols_s + 2 * cm + 1);
    cmid = __ldcg(M.cost_m + cm);
    stage_window(S.small, M.recon + (size_t)R * nm * W + cm * nm, W, rq, q);
    // the rows 2R and 2R + 1 of the small grid, blocks 2cm and 2cm + 1
    stage_window(S.lvs, M.lv_s + ((size_t)2 * R * cols_s + 2 * cm) * ncs,
                 (size_t)cols_s * ncs, 2 * 2 * ncs / 8, 2 * ncs / 8);
    stage_window(S.lvm, M.lv_m + ((size_t)R * cols_m + cm) * ncm, 0,
                 ncm / 8, ncm / 8);
  } else {
    split = __ldcg(M.split + (size_t)R * cols_m + cm) != 0;
    if (big) split64 = __ldcg(M.split64 + (size_t)s * cols_b + C) != 0;
  }
  stage_window(S.mid, M.rec_m + cm * nm, W, rq, q);
  copy_commit();
  if (luma)    // the 16s (8s) against the 32 (16), as row32_step
    split = __fadd_rn(__fadd_rn(__fadd_rn(c0a, c0b), __fadd_rn(c1a, c1b)),
                      M.lam_split) < cmid;
  // the loser's levels, zero whatever the 64 decides
  if (split) zero_levels(M.lv_m, cols_m, ncm, R, 1, cm, 1);
  else zero_levels(M.lv_s, cols_s, ncs, 2 * R, 2, 2 * cm, 2);
  copy_wait<0>();
  __syncthreads();

  if (luma) {
    // the selection's pixel SSE, left and right small column apart, and
    // its rate in the parent kernel's order: element p of the small pair
    // (or of the mid block) on thread p mod NT as its (p div NT)-th
    // addend, then group_sum's order (the loser's zeroed levels added
    // +0.0 there, which leaves every sum as it is)
    const int* sel = split ? S.small : S.mid;
    unsigned sse[2] = {0u, 0u};
    for (int p = t; p < rq; p += NT) {
      const int4 a = *reinterpret_cast<const int4*>(sel + 4 * p);
      const int4 b = *reinterpret_cast<const int4*>(S.src + 4 * p);
      const int e0 = a.x - b.x, e1 = a.y - b.y, e2 = a.z - b.z,
                e3 = a.w - b.w;
      const unsigned e = e0 * e0 + e1 * e1 + e2 * e2 + e3 * e3;
      if (4 * (p % q) < ns) sse[0] += e;
      else sse[1] += e;
    }
    float rt[3] = {0.f, 0.f, 0.f};      // left 16s, right 16s, the 32
    if (split) {
      for (int p = t; p < 2 * 2 * ncs; p += NT) {
        const int side = p / (2 * ncs), r = p % (2 * ncs) / ncs;
        const float v = level_rate(S.lvs[r * 2 * ncs + side * ncs
                                         + p % ncs]);
        if (side == 0) rt[0] = __fadd_rn(rt[0], v);
        else rt[1] = __fadd_rn(rt[1], v);
      }
    } else {
      for (int p = t; p < ncm; p += NT)
        rt[2] = __fadd_rn(rt[2], level_rate(S.lvm[p]));
    }
    const int warp = t >> 5;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      for (int o = 16; o; o >>= 1)
        rt[i] = __fadd_rn(rt[i], __shfl_xor_sync(~0u, rt[i], o));
    sse[0] = __reduce_add_sync(~0u, sse[0]);
    sse[1] = __reduce_add_sync(~0u, sse[1]);
    if ((t & 31) == 0) {
      for (int i = 0; i < 3; ++i) S.red[i * NW + warp] = rt[i];
      S.ired[warp] = sse[0];
      S.ired[NW + warp] = sse[1];
    }
    __syncthreads();
    float cost = 0.f;
    if (t == 0) {
      long long e[2] = {0, 0};
      for (int i = 0; i < 3; ++i) {
        float v = S.red[i * NW];
        for (int w = 1; w < NW; ++w) v = __fadd_rn(v, S.red[i * NW + w]);
        rt[i] = v;
      }
      for (int w = 0; w < NW; ++w) {
        e[0] += S.ired[w];
        e[1] += S.ired[NW + w];
      }
      const float d = __fadd_rn(__ll2float_rn(e[0]), __ll2float_rn(e[1]));
      cost = __fadd_rn(d, __fmul_rn(M.lam, __fadd_rn(__fadd_rn(rt[0], rt[1]),
                                                     rt[2])));
      M.cost_region[(size_t)M.half * cols_m + cm] = cost;
    }
    if (exchange) {
      // the two region costs meet in both CTAs, and both decide the 64
      // from the same terms in sb_step's order
      cluster_wait();
      if (t == 0) {
        S.cost[k] = cost;
        *cluster.map_shared_rank(S.cost + k, k ^ 1) = cost;
      }
      cluster_arrive();
      cluster_wait();
      split64 = __fadd_rn(__fadd_rn(__fadd_rn(r0a, r0b),
                                    __fadd_rn(S.cost[0], S.cost[1])),
                          M.lam_split) < cost_b;
      if (k == 0 && t == 0) M.split64[(size_t)s * cols_b + C] = split64;
    }
  }

  if (!big || split64) {     // the region's selection stands
    if (!split) store_window(M.recon, S.mid, W, R * nm, nm, cm * nm, nm);
    if (luma && t == 0) M.split[(size_t)R * cols_m + cm] = split;
    if (big) {   // the 64's (chroma 32's) levels, half a CTA
      int16_t* lb = M.lv_b + ((size_t)s * cols_b + C) * 1024 + k * 512;
      for (int p = t; p < 512 / 8; p += NT)
        *reinterpret_cast<int4*>(lb + 8 * p) = make_int4(0, 0, 0, 0);
    }
    return;
  }
  // the 64 (chroma 32) wins: this CTA's columns of the superblock's small
  // and mid levels zeroed (those of row R's loser already are), the splits
  // cleared, the big site's recon
  zero_levels(M.lv_s, cols_s, ncs, 4 * s, split ? 4 : 2, 2 * cm, 2);
  zero_levels(M.lv_m, cols_m, ncm, 2 * s, split ? 1 : 2, cm, 1);
  if (luma && t < 2) M.split[(size_t)(2 * s + t) * cols_m + cm] = 0;
  store_window(M.recon, S.big, W, s * nb, nb, cm * nm, nm);
}

int err() { return (int)cudaGetLastError(); }

// part_chain's launch of 1 to 3 jobs (8x8 or 16x16 sites): a cluster of
// CHAIN_CL CTAs per job, the most dynamic shared memory any job needs.
// False for jobs the kernel does not take.
bool chain_config(const ChainJob* jobs, int count, ChainJobs& J,
                  cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg,
                  cudaStream_t stream) {
  if (count < 1 || count > 3) return false;
  int words = 0;
  for (int k = 0; k < count; ++k) {
    if (jobs[k].s.n != 8 && jobs[k].s.n != 16) return false;
    J.j[k] = jobs[k];
    words = max(words, chain_words(jobs[k].s.n));
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CHAIN_CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(CHAIN_CL * count);
  cfg->blockDim = dim3(CHAIN_NT);
  cfg->dynamicSmemBytes = 4 * words;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return true;
}

// A site's CTAs and dynamic shared bytes (CodeLayout)
int code_ctas(const CodeJob& j) {
  const int cols = j.s.n == 8 ? CodeLayout<8>::COLS : 1;
  return (j.cols + cols - 1) / cols;
}

int code_smem(const CodeJob& j) {
  switch (j.s.n) {
    case 8: return CodeLayout<8>::smem(j.s.nm, j.s.cost);
    case 16: return CodeLayout<16>::smem(j.s.nm, j.s.cost);
    case 32: return CodeLayout<32>::smem(j.s.nm, j.s.cost);
    default: return CodeLayout<64>::smem(j.s.nm, j.s.cost);
  }
}

// The jobs heaviest size first (stable), so that the CTAs of the slowest
// columns start first; the flat grid covers exactly the jobs' CTAs.
// Returns the grid's CTAs; *smem gets the launch's dynamic shared bytes.
int code_plan(const CodeJob* jobs, int count, CodeJobs& J, int* smem) {
  int order[MAXJ], n = 0;
  for (int size = 64; size >= 8; size /= 2)
    for (int k = 0; k < count; ++k)
      if (jobs[k].s.n == size) order[n++] = k;
  int total = 0;
  *smem = 0;
  for (int k = 0; k < n; ++k) {
    J.j[k] = jobs[order[k]];
    J.first[k] = total;
    total += code_ctas(J.j[k]);
    *smem = max(*smem, code_smem(J.j[k]));
  }
  for (int k = n; k <= MAXJ; ++k) J.first[k] = total;
  return n == count ? total : -1;
}

// part_pred's CTAs for one job (PredLayout)
int pred_ctas(const PredJob& j) {
  const int cols = j.n == 8 ? PredLayout<8>::COLS
                 : j.n == 16 ? PredLayout<16>::COLS : 1;
  return (j.cols + cols - 1) / cols;
}

// part_pred's flat grid, as code_plan: the jobs heaviest size first (the
// 64 site's CTAs start first).  Returns the grid's CTAs, -1 for a job of
// another size.
int pred_plan(const PredJob* jobs, int count, PredJobs& J) {
  int n = 0, total = 0;
  for (int size = 64; size >= 8; size /= 2)
    for (int k = 0; k < count; ++k)
      if (jobs[k].n == size) {
        J.j[n] = jobs[k];
        J.first[n++] = total;
        total += pred_ctas(jobs[k]);
      }
  for (int k = n; k <= MAXJ; ++k) J.first[k] = total;
  return n == count ? total : -1;
}

// A launch that may start during its predecessor's tail (wait_primary),
// in clusters of `cluster` CTAs along x where cluster > 1.
void pdl_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                dim3 grid, int cluster, cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(NT);
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = cluster > 1 ? 2 : 1;
}

// part_merge's launch: a cluster of MERGE_CL CTAs per superblock column of
// the widest job, a row of the grid per job.  False for jobs it does not
// take (1 or 2 jobs, 8 or 16 small blocks).
bool merge_config(const MergeJob* jobs, int count, MergeJobs& J,
                  cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg,
                  cudaStream_t stream) {
  if (count < 1 || count > 2) return false;
  int cols_b = 1;
  for (int k = 0; k < count; ++k) {
    if (jobs[k].ns != 8 && jobs[k].ns != 16) return false;
    J.j[k] = jobs[k];
    cols_b = max(cols_b, jobs[k].width / (4 * jobs[k].ns));
  }
  pdl_config(cfg, attr, dim3(MERGE_CL * cols_b, count), MERGE_CL, stream);
  return true;
}

__global__ void empty_kernel() {
  launch_dependents();
  wait_primary();
}

}  // namespace

extern "C" int av1_part_chain(const ChainJob* jobs, int count,
                              cudaStream_t stream) {
  ChainJobs J;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  if (!chain_config(jobs, count, J, &attr, &cfg, stream))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t smem = cudaFuncSetAttribute(
      part_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      4 * chain_words(16));
  if (smem != cudaSuccess) return (int)smem;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, part_chain_kernel, J);
  if (e != cudaSuccess) return (int)e;
  return err();
}

// part_chain's launch of these jobs, for kernels/intra_part.py:chain_layout
// to check its mirror against: out = {CTAs, CTAs per cluster, threads per
// CTA, dynamic shared bytes}.
extern "C" int av1_part_chain_layout(const ChainJob* jobs, int count,
                                     int* out) {
  ChainJobs J;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  if (!chain_config(jobs, count, J, &attr, &cfg, nullptr))
    return (int)cudaErrorInvalidValue;
  out[0] = (int)cfg.gridDim.x;
  out[1] = CHAIN_CL;
  out[2] = (int)cfg.blockDim.x;
  out[3] = (int)cfg.dynamicSmemBytes;
  return 0;
}

extern "C" int av1_part_pred(const PredJob* jobs, int count,
                             cudaStream_t stream) {
  if (count < 1 || count > MAXJ) return (int)cudaErrorInvalidValue;
  PredJobs J;
  const int total = pred_plan(jobs, count, J);
  if (total < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  pdl_config(&cfg, attr, dim3(total), 1, stream);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, part_pred_kernel, J);
  if (e != cudaSuccess) return (int)e;
  return err();
}

// part_pred's launch of these jobs, for kernels/intra_part.py:pred_ctas to
// check its mirror against: out = {CTAs, threads per CTA, launch
// attributes, programmatic stream serialization allowed}.
extern "C" int av1_part_pred_layout(const PredJob* jobs, int count,
                                    int* out) {
  if (count < 1 || count > MAXJ) return (int)cudaErrorInvalidValue;
  PredJobs J;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  pdl_config(&cfg, attr, dim3(pred_plan(jobs, count, J)), 1, nullptr);
  out[0] = (int)cfg.gridDim.x;
  out[1] = (int)cfg.blockDim.x;
  out[2] = (int)cfg.numAttrs;
  out[3] = (int)attr[0].val.programmaticStreamSerializationAllowed;
  return 0;
}

extern "C" int av1_part_code(const CodeJob* jobs, int count,
                             cudaStream_t stream) {
  if (count < 1 || count > MAXJ) return (int)cudaErrorInvalidValue;
  CodeJobs J;
  int smem;
  const int total = code_plan(jobs, count, J, &smem);
  if (total < 1) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      part_code_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      CodeLayout<64>::smem(1, 2));
  if (attr != cudaSuccess) return (int)attr;
  part_code_kernel<<<total, NT, smem, stream>>>(J);
  return err();
}

// part_code's launch of these jobs, for kernels/intra_part.py:code_ctas
// and code_smem to check their mirrors against: out = {CTAs, dynamic
// shared bytes, static shared bytes (cudaFuncGetAttributes)}.
extern "C" int av1_part_code_layout(const CodeJob* jobs, int count,
                                    int* out) {
  if (count < 1 || count > MAXJ) return (int)cudaErrorInvalidValue;
  CodeJobs J;
  out[0] = code_plan(jobs, count, J, &out[1]);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, part_code_kernel);
  out[2] = (int)a.sharedSizeBytes;
  return (int)e;
}

extern "C" int av1_part_merge(const MergeJob* jobs, int count,
                              cudaStream_t stream) {
  MergeJobs J;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  if (!merge_config(jobs, count, J, attr, &cfg, stream))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, part_merge_kernel, J);
  if (e != cudaSuccess) return (int)e;
  return err();
}

// part_merge's launch of these jobs, for kernels/intra_part.py:
// merge_layout to check its mirror against: out = {CTAs along x, rows
// (jobs), CTAs per cluster, threads per CTA, static shared bytes
// (cudaFuncGetAttributes), launch attributes}.
extern "C" int av1_part_merge_layout(const MergeJob* jobs, int count,
                                     int* out) {
  MergeJobs J;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  if (!merge_config(jobs, count, J, attr, &cfg, nullptr))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, part_merge_kernel);
  out[0] = (int)cfg.gridDim.x;
  out[1] = (int)cfg.gridDim.y;
  out[2] = (int)attr[1].val.clusterDim.x;
  out[3] = (int)cfg.blockDim.x;
  out[4] = (int)a.sharedSizeBytes;
  out[5] = (int)cfg.numAttrs;
  return (int)e;
}

// `count` launches of a kernel that does nothing (one CTA; with `pdl` the
// probe's launch attribute, and then it triggers and waits as part_pred
// does): the floor of a launch, which chip_smoke.py's phase 7e times.
extern "C" int av1_part_empty(int count, int pdl, cudaStream_t stream) {
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  pdl_config(&cfg, attr, dim3(1), 1, stream);
  cfg.blockDim = dim3(32);
  cfg.numAttrs = pdl ? 1 : 0;
  for (int i = 0; i < count; ++i) {
    const cudaError_t e = cudaLaunchKernelEx(&cfg, empty_kernel);
    if (e != cudaSuccess) return (int)e;
  }
  return err();
}

// The job structs' layout, which kernels/intra_part.py checks against its
// ctypes mirrors once when it loads the library: a line "Struct size" per
// struct and "Struct.field offset" per field.  Writes at most `cap` bytes
// with their terminating zero; returns the length of the whole text.
extern "C" int av1_part_layout(char* out, int cap) {
  struct At { const char* name; size_t at; };
#define S(T) {#T, sizeof(T)}
#define F(T, f) {#T "." #f, offsetof(T, f)}
  static const At v[] = {
      S(PartSite), F(PartSite, step), F(PartSite, off), F(PartSite, gain),
      F(PartSite, tab), F(PartSite, q), F(PartSite, cap), F(PartSite, lam),
      F(PartSite, inv_ratio), F(PartSite, n), F(PartSite, tx),
      F(PartSite, dq_shift), F(PartSite, nm), F(PartSite, cost),
      F(PartSite, pix_max),
      S(ChainJob), F(ChainJob, s), F(ChainJob, fwdt), F(ChainJob, src),
      F(ChainJob, lv), F(ChainJob, rec), F(ChainJob, cols),
      F(ChainJob, width), F(ChainJob, edge0),
      S(PredJob), F(PredJob, bottom), F(PredJob, src), F(PredJob, av),
      F(PredJob, resid), F(PredJob, pred), F(PredJob, n), F(PredJob, nm),
      F(PredJob, cols), F(PredJob, width),
      S(CodeJob), F(CodeJob, s), F(CodeJob, coefs), F(CodeJob, pred),
      F(CodeJob, src), F(CodeJob, lv), F(CodeJob, rec), F(CodeJob, modes),
      F(CodeJob, cost), F(CodeJob, rate), F(CodeJob, cols),
      F(CodeJob, width),
      S(MergeJob), F(MergeJob, lv_s), F(MergeJob, lv_m), F(MergeJob, lv_b),
      F(MergeJob, recon), F(MergeJob, src), F(MergeJob, rec_m),
      F(MergeJob, rec_b), F(MergeJob, split), F(MergeJob, split64),
      F(MergeJob, cost_s), F(MergeJob, cost_m), F(MergeJob, cost_b),
      F(MergeJob, cost_region), F(MergeJob, lam), F(MergeJob, lam_split),
      F(MergeJob, ns), F(MergeJob, width), F(MergeJob, sb_row),
      F(MergeJob, half), F(MergeJob, do_big)};
#undef S
#undef F
  int len = 0;
  for (const At& x : v)
    len += snprintf(out + len, cap > len ? cap - len : 0, "%s %d\n", x.name,
                    (int)x.at);
  return len;
}
