// The wavefront keyframe as one persistent kernel for Hopper, wave_key.
//
// Replaces the jitted step of av1tpu/models/intra_wave.py (`step`, :383,
// lax.scan'ned over the anti-diagonals d = 2r + c at :569).  This is not a
// pallas_call: XLA fused the step into a few device programs per diagonal.
// One launch codes every 16x16 block ("lane") of the diagonals [d0, d1);
// kernels/intra_wave.py holds the wrapper and the plain PyTorch version,
// whose arithmetic this kernel repeats.  Per lane:
//
// - luma: the 13 WAVE_MODES candidates at TX_16X16: prediction, forward
//   transform (256-term fp32 dot products), deadzone quantize, rd_zero,
//   dequantize, the integer inverse transform, recon clip, SSE and
//   RateModel bits, the D203 mask and the argmin (first index on ties);
// - the winner re-coded at TX_8X8 (4 sub-blocks) and TX_4X4 (16) in raster
//   order, each predicted from the sub-blocks reconstructed before it
//   (sub_chain), and the tx-depth choice;
// - U and V DC_PRED coded at 8x8 (DCT_DCT), and the write of the lane into
//   the carried recon, level, mode and tx-depth grids.
//
// What bounds it on an H100.  A 1088x1920 keyframe is 254 diagonals, 8,160
// lanes, and a lane reads the recon of its left, above and above-right
// neighbours, two of which lie on the diagonal before it: the keyframe is
// a chain of 254 dependent lanes, whatever the card's width.  The
// arithmetic is about 14.4 GFLOP of fp32 (13 candidate 256x256 products
// per lane; the 8x8, 4x4 and chroma products add 3%), 0.215 ms at the 67
// TFLOP/s fp32 peak; device memory moves a few MB (the source, the grids,
// 1.4 MB of tables).  What a lane waits for is its SM's intake and its
// serial chains: the lane's four forward matrices, 1 MB, stream from L2
// through shared memory (one SM took 256 KB in about 7 us on the card,
// whatever the copy: one bulk copy per tile, more and smaller ones, or
// every thread's 16-byte cp.async), and the 16 sub-blocks of the 4x4
// chain code one after another.  So the keyframe costs 254 lane
// latencies in a row, and enough lanes must be in flight that a diagonal
// of 60 waits for no free CTA.
//
// The persistent design.  The grid is as many clusters of four 256-thread
// CTAs as can be resident at once (cudaOccupancyMaxActiveClusters: two
// CTAs per SM, 128 registers and about 100 KB of shared memory each, 62
// clusters on the H100), never more than the range's lanes.  A cluster
// takes lanes from a global ticket counter in the order of the schedule
// (the valid lanes of models/intra_wave.py:_diagonals, diagonal after
// diagonal), waits on the ready flags of the lane's left, above and
// above-right blocks (those of diagonals >= d0: earlier ones were coded
// by an earlier launch; the corner follows, since the left block waited
// on it), codes the lane and publishes its flag.  Lanes of neighbouring
// diagonals overlap freely: no grid-wide barrier.  The wrapper zeroes the
// flags and the counter on the stream before each launch; the kernel
// allocates nothing.
//
// Deadlock freedom.  A cluster takes a ticket only while it runs, and only
// after finishing its previous lane, so every ticket taken is held by a
// running cluster until its lane is published.  A lane waits only on lanes
// of earlier diagonals, which have smaller tickets.  By induction on the
// ticket, the smallest unpublished ticket waits on nothing unpublished, so
// its cluster makes progress: no cycle, whatever the number of clusters or
// the order the hardware runs them in.  (Sizing the grid to what is
// resident keeps idle clusters from queueing behind spinning ones.)
//
// Memory order.  Rank 0's writes of a lane precede a __syncthreads; then
// its thread 0 fences (__threadfence) and stores the flag with release
// semantics at device scope (cuda::atomic_ref).  In every CTA of a waiting
// cluster, thread 0 loads the flags with acquire semantics and fences, and
// a __syncthreads hands the order on to the CTA.  The carried grids that
// another lane wrote are read with __ldcg (L2, never a stale L1 line);
// only the source and the tables, constant during the launch, go through
// __ldg.  Within a cluster, values cross shared memory (DSMEM) between
// cluster barriers (barrier.cluster arrive.release / wait.acquire).
//
// Inside a lane.  The cluster's four CTAs code the four transform groups of
// _TX_GROUPS (2, 4, 4 and 3 candidates) side by side, rank k the k-th
// group: thread t owns pixel t and coefficient t of each of its group's
// candidates.  Each CTA streams its group's forward matrix (256 KB)
// through a ring of three 16 KB k-tiles in shared memory, filled by bulk
// copies (cp.async.bulk, one thread) that complete on mbarriers; the ring
// runs on across lanes, so the next lane's first tiles load while this
// one finishes.  The candidates' costs meet in rank 0's shared memory
// (one cluster barrier); each CTA keeps its candidates' levels and recon
// until the next lane's ticket barrier, and rank 0 reads the winner's
// through DSMEM when it writes the lane.  Rank 0 takes the argmin and runs
// five pieces at once on their own warps, each synchronised by its own
// named barrier (bar.sync id, n) or __syncwarp: the 8x8 chain (2 warps),
// the 4x4 chain (1 warp), U (2 warps), V (2 warps) and the 4x4 chain's
// SSE and rate (1 warp); chroma reads only the neighbours' chroma recon,
// so it does not wait on the luma chains.  The 4x4 chain codes its 16
// sub-blocks in the block's own wavefront order (10 steps of two, the
// product and the inverse in registers across the half-warp) and hands
// each step to the rates warp through a block-scope release/acquire
// counter; the rates are summed in raster order.  The forward matrices of
// the sub-blocks stay in shared memory for the launch: the four 4x4 ones
// in rank 0, and each group's 8x8 one in the CTA of that group, which
// rank 0 reads through DSMEM (all four in rank 0, 64 KB more, allowed one
// CTA per SM: 30 clusters, half a diagonal in flight).  Every small table
// the pieces read is in shared memory too.
//
// Bits.  The levels, decisions and recon equal those of the two
// per-diagonal kernels this one replaced (wave_luma16 and
// wave_sub_chroma, one launch each per diagonal), bit for bit:
// - each coefficient's product is the same fmaf chain over k = 0..255 in
//   order, by one thread, from the same values (a matrix element from
//   shared memory instead of L2);
// - every reduction is the warp butterfly, then the piece's warps in index
//   order from 0 (int 0, float 0.f), as block_sum_f summed the block's 8
//   warps; the warps a piece no longer has held zeros there, and adding
//   +0.f changes no bit (every summed value is >= +0); integer sums are
//   exact in any order;
// - every decision expression is written with __fmul_rn, __fadd_rn,
//   __fsub_rn and IEEE division (nvcc would otherwise contract a*b + c
//   into an FMA), with the argmin over positions in order, strict <;
// - the inverse transforms are itx.cuh's 1-D transforms on the same
//   values; which thread runs which row does not change a result;
// - a 4x4 sub-block reads only its left, above, above-right and corner
//   sub-blocks, which both orders code before it, and the chain's SSE
//   and rate are summed in raster order from the same per-sub-block
//   values (each half-warp's butterfly skips the xor-16 stage, in which
//   the raster chain added the idle half's +0.f).
// Against the plain version (cuBLAS products and PyTorch's sums in another
// order) a level may flip by 1 at a rounding boundary and a decision at a
// near-tie (chip_smoke.py phase 7b counts both).  The candidate's
// prediction in sub_chain is row sub_pred_row[pick] of the WAVE_MODES
// stack, the reference's row, read from a table.

#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "itx.cuh"

namespace cg = cooperative_groups;

// Phase stamps for tools/wave_stamps.py, which builds this file with
// -DWAVE_STAMPS: WAVE_STAMP(tk, k, cond) then writes the GPU's nanosecond
// clock (%globaltimer, common to every SM) as stamp k of lane tk where
// cond holds, and av1_wave_stamps copies the stamps out.  Otherwise it is
// empty and the kernel is the program's.
#ifdef WAVE_STAMPS
#define WAVE_MAX_STAMPED 16384
__device__ unsigned long long g_wave_stamp[WAVE_MAX_STAMPED][9];
#define WAVE_STAMP(tk, k, cond)                                        \
  do {                                                                 \
    if ((cond) && (tk) < WAVE_MAX_STAMPED) {                           \
      unsigned long long t_;                                           \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));           \
      g_wave_stamp[tk][k] = t_;                                        \
    }                                                                  \
  } while (0)
extern "C" int av1_wave_stamps(unsigned long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_wave_stamp,
                                   sizeof(unsigned long long) * 9 * n);
}
#else
#define WAVE_STAMP(tk, k, cond) \
  do {                          \
  } while (0)
#endif

// kernels/intra_wave.py:WaveTabsC, field for field (outside the anonymous
// namespace: the C entry point takes it, and must keep external linkage)
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

constexpr int NT = 256;       // threads per CTA: one per 16x16 pixel
constexpr int NWG = 4;        // CTAs per cluster: one per transform group
constexpr int NPOS = 13;      // candidates (WAVE_MODES)
constexpr int MAXG = 4;       // candidates of one transform type, at most
constexpr int KEEP_ALWAYS = 8;
constexpr int NTAB = 16;      // magnitudes whose bits the rate reads
constexpr int KT = 16;        // rows of fwd16 per k-tile (16 KB)
constexpr int STAGES = 3;     // k-tiles in flight per CTA (48 KB)
constexpr int NTILE = 256 / KT;
constexpr uint32_t TILE_BYTES = KT * 256 * sizeof(float);
// named barriers (0 is __syncthreads): the pieces of the sub-block phase
constexpr int BAR_C8 = 1, BAR_U = 2, BAR_V = 3;

// AV1 intra mode values (spec enums)
enum { DC = 0, V = 1, H = 2, D45 = 3, D135 = 4, D113 = 5, D157 = 6,
       D203 = 7, D67 = 8, SMOOTH = 9, SMOOTH_V = 10, SMOOTH_H = 11,
       PAETH = 12 };
// models/intra_wave.py:WAVE_MODES: row of the prediction stack -> mode
__constant__ int kWaveModes[NPOS] = {DC, V, H, D45, D67, SMOOTH, SMOOTH_V,
                                     SMOOTH_H, PAETH, D135, D113, D157,
                                     D203};
// float32(0.87) and float32(3.66): models/intra_wave.py:_TXD_BITS[1:]
constexpr u32 TXD8_BITS = 0x3f5eb852u, TXD4_BITS = 0x406a3d71u;

// ---- thread groups: a CTA or a piece of the sub-block phase ----

// lt: the thread's index in the group (its coefficient); n: the group's
// threads, whole warps; id: its named barrier (one warp: __syncwarp; the
// whole CTA: __syncthreads).
struct Grp {
  int lt, n, id;
  __device__ __forceinline__ void sync() const {
    if (n == 32) {
      __syncwarp();
    } else if (n == NT) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
    }
  }
};

// ---- shared memory ----

// One transform size's rows, copied from WaveTabs: quantizer, rd_zero's
// gains per tx type, the RateModel's bits (magnitudes < NTAB), skip, end of
// block and scan ranks.  Sized for 8x8; 4x4 and chroma use the front.
struct Rows {
  float step[64], off[64];
  int q[64], cap[64];
  float gain[4][64];
  float tab[NTAB], skip[2], eob[65];
  int rank[64];
};

struct LumaRows {  // the luma candidates' rate and mode tables
  float tab[NTAB], skip[2], eob[257];
  int rank[256];
  float mode_bits[NPOS];
  int mode_vals[NPOS], grp[NPOS], sub_row[NPOS];
};

struct Chain {     // the 8x8 sub-block chain
  float resid[64];
  u32 dq[64], tmp[64];
  int recb[256], lvb[256];
  int a2[16], l2[16], co;
  int dred[2 * MAXG], ired[2 * MAXG];    // the SSE's, the end of block's
  float fred[2 * MAXG];
  float dist, rate;
};

struct Chain4 {    // the 4x4 chain: two sub-blocks at a time
  int recb[256], lvb[256];
  int a2[2][8], l2[2][8], co[2];
  int sse[16];                           // per sub-block, raster order
  float rate[16];
  float dist, rate_sum;
  int steps;                             // wavefront steps coded so far
};

struct Chroma {    // one chroma plane's 8x8 block
  int a[8], l[8];
  float resid[64];
  u32 dq[64], tmp[64];
};

struct Smem {
  unsigned long long full[STAGES];         // k-tile arrived (mbarriers)
  alignas(16) float tile[STAGES][KT * 256];
  float4 resid[256];     // per k the group's <= 4 candidates' residuals;
                         // also the inverse's scratch
  u32 dq[MAXG * 256];
  int dred[8 * MAXG], ired[8 * MAXG];      // SSE, end of block
  float fred[8 * MAXG];
  int src[256];
  int above[32], left[32], corner;
  int w[28], dr[2 * NPOS];
  LumaRows ly;
  int ticket;
  alignas(16) float fwd8[64 * 64];         // this CTA's group's 8x8 matrix
  int16_t lvc[MAXG][256];                  // this CTA's candidates' levels
  int recc[MAXG][256];                     // and recon
  // rank 0's: the candidates' costs, and the sub-block phase
  float cost[NPOS];
  alignas(16) float fwd4[4][16 * 16];
  Rows r8, r4, rc;
  Chain c8;
  Chain4 c4;
  Chroma ch[2];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

// k-tile `kt` of the matrix F (256 x 256) into dst, completing on bar.
// The issuing thread has passed the CTA's barrier after every thread's
// last read of dst; the proxy fence orders those reads before the async
// write.
__device__ __forceinline__ void tile_load(float* dst, const float* F, int kt,
                                          uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(TILE_BYTES) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(F + (size_t)kt * KT * 256), "r"(TILE_BYTES),
      "r"(bar) : "memory");
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

// models/intra_wave.py:_edges_from_blocks for threads k < 16: above2n
// (32), left (16) and, from thread 0, the corner, with the spec's
// availability substitutions.  rec: (rows, cols, 16, 16) blocks written by
// earlier lanes of this launch, read through L2.
__device__ void load_edges(int k, const int* rec, int cols, int r, int c,
                           bool ha, bool hl, bool ur_ok, int base,
                           int* above2n, int* left, int* corner) {
  constexpr int n = 16, nn = 256;
  const int rm = max(r - 1, 0), cm = max(c - 1, 0);
  const int cp = min(c + 1, cols - 1);
  const int* up = rec + ((size_t)rm * cols + c) * nn + (n - 1) * n;
  const int* lf = rec + ((size_t)r * cols + cm) * nn + (n - 1);
  const int a_sub = hl ? __ldcg(lf) : base - 1;      // above when !ha
  const int ak = ha ? __ldcg(up + k) : a_sub;
  const int a_last = ha ? __ldcg(up + n - 1) : a_sub;
  above2n[k] = ak;
  left[k] = hl ? __ldcg(lf + k * n) : (ha ? __ldcg(up) : base + 1);
  above2n[n + k] = (ur_ok && ha)
      ? __ldcg(rec + ((size_t)rm * cols + cp) * nn + (n - 1) * n + k)
      : a_last;
  if (k == 0) {
    *corner = (ha && hl) ? __ldcg(rec + ((size_t)rm * cols + cm) * nn + nn - 1)
            : (ha ? __ldcg(up) : (hl ? __ldcg(lf) : base));
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

// ---- group reductions: every thread of the group gets the result ----
// Integers: the warp's redux (exact), then the group's warps.  Floats: the
// warp butterfly, then the group's warps in index order from 0.f.  red:
// MAXG slots per warp, a buffer that no other reduction between two of
// the group's barriers uses (so one barrier suffices).  A one-warp group
// skips the second step: adding its one value to 0 changes no bit (the
// floats summed are >= +0).

template <int M, bool MAX>
__device__ void grp_reduce_i(const Grp& g, int* v, int* red) {
  for (int m = 0; m < M; ++m)
    v[m] = MAX ? __reduce_max_sync(~0u, v[m]) : __reduce_add_sync(~0u, v[m]);
  if (g.n == 32) return;
  if ((g.lt & 31) == 0)
    for (int m = 0; m < M; ++m) red[(g.lt >> 5) * MAXG + m] = v[m];
  g.sync();
  for (int m = 0; m < M; ++m) {
    int s = 0;
    for (int w = 0; w < g.n / 32; ++w)
      s = MAX ? max(s, red[w * MAXG + m]) : s + red[w * MAXG + m];
    v[m] = s;
  }
}

template <int M>
__device__ void grp_sum_f(const Grp& g, float* v, float* red) {
  for (int m = 0; m < M; ++m)
    for (int o = 16; o; o >>= 1)
      v[m] = __fadd_rn(v[m], __shfl_xor_sync(~0u, v[m], o));
  if (g.n == 32) return;
  if ((g.lt & 31) == 0)
    for (int m = 0; m < M; ++m) red[(g.lt >> 5) * MAXG + m] = v[m];
  g.sync();
  for (int m = 0; m < M; ++m) {
    float s = 0.f;
    for (int w = 0; w < g.n / 32; ++w) s = __fadd_rn(s, red[w * MAXG + m]);
    v[m] = s;
  }
}

// RateModel's bits of M blocks at once from each thread's level of
// coefficient g.lt (lv[m]; threads past the block pass active = false):
// txb_skip, end-of-block position and the coded coefficients.
template <int M>
__device__ void rate_bits(const Grp& g, const int* lv, bool active,
                          const float* tab, const float* skip,
                          const int* rank, const float* eob_bits, int* ired,
                          float* fred, float* out) {
  const int rk = active ? rank[g.lt] : 0;
  int eob[M];
  for (int m = 0; m < M; ++m) eob[m] = (active && lv[m] != 0) ? rk + 1 : 0;
  grp_reduce_i<M, true>(g, eob, ired);
  float bits[M];
  for (int m = 0; m < M; ++m)
    bits[m] = (active && rk < eob[m]) ? coef_bits(abs(lv[m]), tab) : 0.f;
  grp_sum_f<M>(g, bits, fred);
  for (int m = 0; m < M; ++m)
    out[m] = eob[m] == 0 ? skip[1]
                         : __fadd_rn(__fadd_rn(skip[0], eob_bits[eob[m]]),
                                     bits[m]);
}

// itx.cuh's inverse_2d on a thread group (the same rows and columns, the
// same 1-D transforms and shifts; the group's barrier in place of the
// block's).
template <int N>
__device__ void inverse_2d_grp(const Grp& g, int tx, int nb, u32* buf,
                               u32* tmp, int bstride, int ld) {
  constexpr int ROW_SHIFT = N == 4 ? 0 : (N == 8 ? 1 : 2);
  const bool h_adst = tx == 2 || tx == 3, v_adst = tx == 1 || tx == 3;
  u32 in[N], out[N];
  for (int r = g.lt; r < nb * N; r += g.n) {
    const u32* src = buf + (r / N) * bstride + (r % N) * ld;
    u32* dst = tmp + (r / N) * bstride + (r % N) * ld;
    for (int k = 0; k < N; ++k) in[k] = src[k];
    inv1d<N>(h_adst, in, out);
    for (int k = 0; k < N; ++k) dst[k] = rs(out[k], ROW_SHIFT);
  }
  g.sync();
  for (int c = g.lt; c < nb * N; c += g.n) {
    const u32* src = tmp + (c / N) * bstride + c % N;
    u32* dst = buf + (c / N) * bstride + c % N;
    for (int k = 0; k < N; ++k) in[k] = src[k * ld];
    inv1d<N>(v_adst, in, out);
    for (int k = 0; k < N; ++k) dst[k * ld] = rs(out[k], 4);
  }
  g.sync();
}

// ---- rank 0's pieces of a lane ----

// The winner's mode re-coded at TX_NSxNS (sub_chain): the sub-blocks in
// raster order, each predicted from the recon before it.  R: the size's
// rows; fwd: group grp's matrix.
template <int NS>
__device__ void sub_chain(const Grp& g, Smem& S, Chain& C, const Rows& R,
                          const float* fwd, int grp, int mode, bool ha,
                          bool hl, int base, int pix_max, float lam,
                          float gate) {
  constexpr int nn = NS * NS, k16 = 16 / NS;
  const int t = g.lt;
  const bool active = t < nn;
  const int si_t = t / NS, sj_t = t % NS;
  const int* w = S.w + (NS == 8 ? 4 : 0);
  float dist = 0.f, rate_sum = 0.f;
  for (int si = 0; si < k16; ++si) {
    for (int sj = 0; sj < k16; ++sj) {
      const int y0 = si * NS, x0 = sj * NS;
      if (t < 2 * NS) {
        const int k = t;
        int a, l;
        if (si == 0) {
          a = (sj > 0 && !ha) ? C.recb[x0 - 1] : S.above[x0 + k];
        } else {
          a = C.recb[(y0 - 1) * 16 + min(x0 + k, 15)];
        }
        if (sj == 0) {
          l = (si > 0 && !hl) ? C.recb[(y0 - 1) * 16]
                              : S.left[min(y0 + k, 15)];
        } else {
          l = C.recb[min(y0 + k, y0 + NS - 1) * 16 + x0 - 1];
        }
        C.a2[k] = a;
        C.l2[k] = l;
        if (k == 0) {
          int co;
          if (si == 0 && sj == 0) co = S.corner;
          else if (si == 0) co = ha ? S.above[x0 - 1] : C.recb[x0 - 1];
          else if (sj == 0) co = hl ? S.left[y0 - 1] : C.recb[(y0 - 1) * 16];
          else co = C.recb[(y0 - 1) * 16 + x0 - 1];
          C.co = co;
        }
      }
      g.sync();
      const bool ha2 = si == 0 ? ha : true, hl2 = sj == 0 ? hl : true;
      int pr = 0, sv = 0;
      if (active) {
        pr = pred_px(mode, NS, si_t, sj_t, C.a2, C.l2, C.co, ha2, hl2, base,
                     w, S.dr);
        sv = S.src[(y0 + si_t) * 16 + x0 + sj_t];
        C.resid[t] = (float)(sv - pr);
      }
      g.sync();
      int lv[1] = {0};
      if (active) {
        float acc = 0.f;
        for (int k = 0; k < nn; ++k) acc = fmaf(C.resid[k], fwd[k * nn + t],
                                                acc);
        lv[0] = quant_rdz(acc, R.step[t], R.cap[t], R.off[t], R.q[t], R.tab,
                          R.gain[grp][t], lam, gate);
        C.dq[t] = (u32)(lv[0] * R.q[t]);
      }
      g.sync();
      inverse_2d_grp<NS>(g, grp, 1, C.dq, C.tmp, 256, NS);
      int rec = 0;
      int d2[1] = {0};
      if (active) {
        rec = min(max(pr + (int)C.dq[t], 0), pix_max);
        const int e = rec - sv;
        d2[0] = e * e;
      }
      grp_reduce_i<1, false>(g, d2, C.dred);
      float rate[1];
      rate_bits<1>(g, lv, active, R.tab, R.skip, R.rank, R.eob, C.ired,
                   C.fred, rate);
      if (active) {
        C.recb[(y0 + si_t) * 16 + x0 + sj_t] = rec;
        C.lvb[(y0 + si_t) * 16 + x0 + sj_t] = lv[0];
      }
      dist = __fadd_rn(dist, __int2float_rn(d2[0]));
      rate_sum = __fadd_rn(rate_sum, rate[0]);
      g.sync();
    }
  }
  if (t == 0) {
    C.dist = dist;
    C.rate = rate_sum;
  }
}

__device__ __forceinline__ u32 pick4(const u32* a, int k) {
  return k == 0 ? a[0] : (k == 1 ? a[1] : (k == 2 ? a[2] : a[3]));
}

// The 4x4 chain on one warp.  A sub-block reads the recon of its left,
// above, above-right and corner sub-blocks only, as a lane of the frame
// does, so the 16 sub-blocks go in the frame's wavefront order, d = 2si +
// sj: 10 steps of at most two sub-blocks, one per half-warp (lane & 15 is
// the coefficient).  Every sub-block's prediction, product, levels and
// recon are those of the raster chain; the residuals and levels cross the
// half-warp by shuffles (the 2-D inverse is integer, so which lane runs
// which row does not change a value).  After each step the chain
// publishes C.steps (release, block scope) for chain4_rates.
__device__ void sub_chain4(Smem& S, Chain4& C, const Rows& R,
                           const float* fwd, int grp, int mode, bool ha,
                           bool hl, int base, int pix_max, float lam,
                           float gate) {
  const Grp g{(int)(threadIdx.x & 31), 32, 0};
  const int h = g.lt >> 4, t = g.lt & 15, hb = h << 4;
  const int si_t = t >> 2, sj_t = t & 3;
  const bool h_adst = grp == 2 || grp == 3, v_adst = grp == 1 || grp == 3;
  const int* w = S.w;
  for (int d = 0; d < 10; ++d) {
    // this step's sub-blocks: si ascending; half h takes the h-th
    const int si_lo = d < 4 ? 0 : (d - 2) >> 1;
    const int si_hi = min(d >> 1, 3);
    const int nb = si_hi - si_lo + 1;
    const bool on = h < nb;
    const int si = si_lo + h, sj = d - 2 * si;
    const int y0 = si * 4, x0 = sj * 4;
    if (on && t < 8) {
      const int k = t;
      int a, l;
      if (si == 0) {
        a = (sj > 0 && !ha) ? C.recb[x0 - 1] : S.above[x0 + k];
      } else {
        a = C.recb[(y0 - 1) * 16 + min(x0 + k, 15)];
      }
      if (sj == 0) {
        l = (si > 0 && !hl) ? C.recb[(y0 - 1) * 16]
                            : S.left[min(y0 + k, 15)];
      } else {
        l = C.recb[min(y0 + k, y0 + 3) * 16 + x0 - 1];
      }
      C.a2[h][k] = a;
      C.l2[h][k] = l;
      if (k == 0) {
        int co;
        if (si == 0 && sj == 0) co = S.corner;
        else if (si == 0) co = ha ? S.above[x0 - 1] : C.recb[x0 - 1];
        else if (sj == 0) co = hl ? S.left[y0 - 1] : C.recb[(y0 - 1) * 16];
        else co = C.recb[(y0 - 1) * 16 + x0 - 1];
        C.co[h] = co;
      }
    }
    g.sync();
    const bool ha2 = si == 0 ? ha : true, hl2 = sj == 0 ? hl : true;
    int pr = 0, sv = 0;
    float resid = 0.f;
    if (on) {
      pr = pred_px(mode, 4, si_t, sj_t, C.a2[h], C.l2[h], C.co[h], ha2, hl2,
                   base, w, S.dr);
      sv = S.src[(y0 + si_t) * 16 + x0 + sj_t];
      resid = (float)(sv - pr);
    }
    // the product, the residuals from the half's lanes (every lane of the
    // warp takes part in the shuffles)
    float acc = 0.f;
    for (int k = 0; k < 16; ++k)
      acc = fmaf(__shfl_sync(~0u, resid, hb + k), fwd[k * 16 + t], acc);
    int lv = 0;
    if (on)
      lv = quant_rdz(acc, R.step[t], R.cap[t], R.off[t], R.q[t], R.tab,
                     R.gain[grp][t], lam, gate);
    const u32 dq = (u32)(lv * R.q[t]);
    // the 2-D inverse in registers: row si_t's four levels, then column
    // sj_t's four row outputs, from the half's lanes (the row shift is 0)
    u32 x[4], o[4];
    for (int k = 0; k < 4; ++k)
      x[k] = __shfl_sync(~0u, dq, hb + 4 * si_t + k);
    inv1d<4>(h_adst, x, o);
    const u32 row = pick4(o, sj_t);
    for (int k = 0; k < 4; ++k)
      x[k] = __shfl_sync(~0u, row, hb + 4 * k + sj_t);
    inv1d<4>(v_adst, x, o);
    if (on) {
      C.recb[(y0 + si_t) * 16 + x0 + sj_t] =
          min(max(pr + (int)rs(pick4(o, si_t), 4), 0), pix_max);
      C.lvb[(y0 + si_t) * 16 + x0 + sj_t] = lv;
    }
    g.sync();
    if (g.lt == 0) {
      cuda::atomic_ref<int, cuda::thread_scope_block> steps(C.steps);
      steps.store(d + 1, cuda::memory_order_release);
    }
  }
}

// The 4x4 chain's SSE and rate on another warp, two sub-blocks at a time
// as the chain codes them, summed in raster order as the raster chain
// summed them: each half's butterfly skips the xor-16 stage, which in the
// raster chain added the idle half's +0.f.
__device__ void chain4_rates(Smem& S, Chain4& C, const Rows& R) {
  const int lane = (int)(threadIdx.x & 31), h = lane >> 4, t = lane & 15;
  const int si_t = t >> 2, sj_t = t & 3;
  cuda::atomic_ref<int, cuda::thread_scope_block> steps(C.steps);
  for (int q = 0; q < 8; ++q) {
    // sub-blocks 2q and 2q + 1 (raster), coded at steps 2si + sj
    const int last = max(2 * (q >> 1) + ((2 * q) & 3),
                         2 * (q >> 1) + ((2 * q + 1) & 3));
    if (lane == 0)
      while (steps.load(cuda::memory_order_acquire) <= last) {
      }
    __syncwarp();
    const int sb = 2 * q + h;
    const int px = ((sb >> 2) * 4 + si_t) * 16 + (sb & 3) * 4 + sj_t;
    const int lv = C.lvb[px];
    const int e = C.recb[px] - S.src[px];
    int sse = e * e;
    const int rk = R.rank[t];
    int eob = lv != 0 ? rk + 1 : 0;
    for (int o = 8; o; o >>= 1) {
      sse += __shfl_xor_sync(~0u, sse, o);
      eob = max(eob, __shfl_xor_sync(~0u, eob, o));
    }
    float bits = rk < eob ? coef_bits(abs(lv), R.tab) : 0.f;
    for (int o = 8; o; o >>= 1)
      bits = __fadd_rn(bits, __shfl_xor_sync(~0u, bits, o));
    if (t == 0) {
      C.sse[sb] = sse;
      C.rate[sb] = eob == 0 ? R.skip[1]
                            : __fadd_rn(__fadd_rn(R.skip[0], R.eob[eob]),
                                        bits);
    }
  }
  __syncwarp();
  if (lane == 0) {
    float dist = 0.f, rate_sum = 0.f;
    for (int sb = 0; sb < 16; ++sb) {
      dist = __fadd_rn(dist, __int2float_rn(C.sse[sb]));
      rate_sum = __fadd_rn(rate_sum, C.rate[sb]);
    }
    C.dist = dist;
    C.rate_sum = rate_sum;
    steps.store(0, cuda::memory_order_relaxed);   // for the next lane
  }
}

// One chroma plane's 8x8 DC_PRED block, DCT_DCT (dct8: its matrix),
// coded and written (64 threads).
__device__ void chroma_block(const Grp& g, Smem& S, Chroma& P,
                             const float* dct8, const int* src_c,
                             int* rec_c, int16_t* lv_c, int cw, int cols,
                             int r, int c, bool ha, bool hl, int base,
                             int pix_max, float lam, float gate) {
  const Rows& R = S.rc;
  const int t = g.lt;
  if (t < 8) {
    P.a[t] = ha ? __ldcg(rec_c + ((size_t)(r - 1) * cols + c) * 64 + 56 + t)
                : 0;
    P.l[t] = hl ? __ldcg(rec_c + ((size_t)r * cols + c - 1) * 64 + t * 8 + 7)
                : 0;
  }
  g.sync();
  int sa = 0, sl = 0;
  for (int k = 0; k < 8; ++k) {
    sa += P.a[k];
    sl += P.l[k];
  }
  const int dc = (ha && hl) ? (sa + sl + 8) >> 4
               : (ha ? (sa + 4) >> 3 : (hl ? (sl + 4) >> 3 : base));
  const int sv = __ldg(src_c + (size_t)(r * 8 + (t >> 3)) * cw + c * 8 +
                       (t & 7));
  P.resid[t] = (float)(sv - dc);
  g.sync();
  float acc = 0.f;
  for (int k = 0; k < 64; ++k) acc = fmaf(P.resid[k], dct8[k * 64 + t],
                                          acc);
  const int lv = quant_rdz(acc, R.step[t], R.cap[t], R.off[t], R.q[t], R.tab,
                           R.gain[0][t], lam, gate);
  P.dq[t] = (u32)(lv * R.q[t]);
  g.sync();
  inverse_2d_grp<8>(g, 0, 1, P.dq, P.tmp, 256, 8);
  const size_t blk = (size_t)r * cols + c;
  rec_c[blk * 64 + t] = min(max(dc + (int)P.dq[t], 0), pix_max);
  lv_c[blk * 64 + t] = (int16_t)lv;
}

// ---- wave_key ----

// Block (r, c)'s waits: left (r, c-1) and above-right (r-1, c+1) lie on
// diagonal d-1, above (r-1, c) on d-2; blocks of diagonals before d0 are
// done already.  kernels/intra_wave.py's tests walk the same rule.
__device__ __forceinline__ void wait_ready(int* flags, int cols, int r,
                                           int c, int d0) {
  const int d = 2 * r + c;
  const int rr[3] = {r, r - 1, r - 1}, cc[3] = {c - 1, c, c + 1};
  const int dd[3] = {d - 1, d - 2, d - 1};
  for (int k = 0; k < 3; ++k) {
    if (rr[k] < 0 || cc[k] < 0 || cc[k] >= cols || dd[k] < d0) continue;
    cuda::atomic_ref<int, cuda::thread_scope_device> f(
        flags[rr[k] * cols + cc[k]]);
    while (f.load(cuda::memory_order_acquire) == 0) __nanosleep(32);
  }
  __threadfence();
}

// n copies of src into dst by the CTA's threads.
template <class D, class S_>
__device__ __forceinline__ void copy_rows(D* dst, const S_* src, int n) {
  for (int k = threadIdx.x; k < n; k += NT) dst[k] = (D)src[k];
}

__device__ void load_rows(Rows& R, int n, const float* step, const int* q,
                          const int* cap, const float* off, const float* gain,
                          int ngain, const float* tab, const float* skip,
                          const int* rank, const float* eob) {
  copy_rows(R.step, step, n);
  copy_rows(R.q, q, n);
  copy_rows(R.cap, cap, n);
  copy_rows(R.off, off, n);
  for (int k = threadIdx.x; k < ngain * n; k += NT)
    R.gain[k / n][k % n] = gain[k];
  copy_rows(R.tab, tab, NTAB);
  if (skip) copy_rows(R.skip, skip, 2);
  if (rank) copy_rows(R.rank, rank, n);
  if (eob) copy_rows(R.eob, eob, n + 1);
}

// One lane schedule entry: r | c << 12 | ur << 24 | bl << 25
// (kernels/intra_wave.py:WaveSchedule).
__global__ void __launch_bounds__(NT, 2) wave_key_kernel(
    WaveTabs T, const int* __restrict__ src_y, const int* __restrict__ src_u,
    const int* __restrict__ src_v, int height, int width, int* rec_y,
    int* rec_u, int* rec_v, int16_t* lv_y, int16_t* lv_u, int16_t* lv_v,
    int8_t* modes, int8_t* txds, const int* __restrict__ lanes, int n,
    int d0, int* flags) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int gi = (int)cluster.block_rank();     // this CTA's group
  Smem& S0 = *cluster.map_shared_rank(&S, 0);   // rank 0's, through DSMEM
  const int tid = threadIdx.x, lt = tid;
  const Grp G{lt, NT, 0};
  const int cols = width >> 4, cw = width >> 1;
  int* counter = flags + (height >> 4) * cols;
  const int base = 1 << (T.bit_depth - 1), pix_max = (1 << T.bit_depth) - 1;
  const float lam = T.lam, gate = T.gate;

  // this CTA's transform group: the gi-th run of grp_of_pos
  int start = -1, ng = 0;
  for (int p = 0, run = -1; p < NPOS; ++p) {
    if (p == 0 || T.grp_of_pos[p] != T.grp_of_pos[p - 1]) ++run;
    if (run == gi) {
      if (start < 0) start = p;
      ++ng;
    }
  }
  const int tx = ng ? (int)T.grp_of_pos[start] : 0;
  const float* F = T.fwd16 + (size_t)tx * 65536;
  // stage s's mbarrier is at full + 8 * s
  const uint32_t full = smem_addr(&S.full[0]);

  if (lt == 0 && ng) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   ::"r"(full + 8 * s), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // once per CTA: the tables it reads, in shared memory
  copy_rows(S.w, T.sm_w, 28);
  copy_rows(S.dr, T.pred_dr, 2 * NPOS);
  copy_rows(S.ly.tab, T.tab16, NTAB);
  copy_rows(S.ly.skip, T.skip16, 2);
  copy_rows(S.ly.eob, T.eob16, 257);
  copy_rows(S.ly.rank, T.rank16, 256);
  copy_rows(S.ly.mode_bits, T.mode_bits, NPOS);
  copy_rows(S.ly.mode_vals, T.mode_vals, NPOS);
  copy_rows(S.ly.grp, T.grp_of_pos, NPOS);
  copy_rows(S.ly.sub_row, T.sub_pred_row, NPOS);
  for (int k = tid; k < 64 * 64 / 4; k += NT)   // the cluster holds all 4
    reinterpret_cast<float4*>(&S.fwd8[0])[k] =
        __ldg(reinterpret_cast<const float4*>(T.fwd8 + tx * 4096) + k);
  if (gi == 0) {
    if (tid < 4 * 16 * 16 / 4)
      reinterpret_cast<float4*>(&S.fwd4[0][0])[tid] =
          __ldg(reinterpret_cast<const float4*>(T.fwd4) + tid);
    load_rows(S.r8, 64, T.step8, T.q8, T.cap8, T.off8, T.gain8, 4, T.tab8,
              T.skip8, T.rank8, T.eob8);
    load_rows(S.r4, 16, T.step4, T.q4, T.cap4, T.off4, T.gain4, 4, T.tab4,
              T.skip4, T.rank4, T.eob4);
    load_rows(S.rc, 64, T.stepc, T.qc, T.capc, T.offc, T.gainc, 1, T.tabc,
              nullptr, nullptr, nullptr);
    if (tid == 0) S.c4.steps = 0;
  }
  __syncthreads();
  // the ring's first tiles (the ring runs on from lane to lane: every
  // lane reads the matrix's NTILE tiles in order)
  unsigned it = 0;                  // tiles consumed by this CTA
  if (lt == 0 && ng)
    for (int s = 0; s < STAGES; ++s)
      tile_load(S.tile[s], F, s, full + 8 * s);

  const float step = T.step16[lt], off = T.off16[lt];
  const int q = T.q16[lt], cap = T.cap16[lt];
  const float gain = T.gain16[tx * 256 + lt];
  const int i = lt >> 4, j = lt & 15;

  for (;;) {
    if (gi == 0 && tid == 0) S.ticket = atomicAdd(counter, 1);
    cluster.sync();                 // the ticket, in rank 0
    const int tk = S0.ticket;
    if (tk >= n) break;
    WAVE_STAMP(tk, 0, tid == 0 && gi == 0);   // ticket taken
    const int e = lanes[tk];
    const int r = e & 0xfff, c = (e >> 12) & 0xfff;
    const bool ur = (e >> 24) & 1, bl = (e >> 25) & 1;
    const bool ha = r > 0, hl = c > 0;
    if (tid == 0) wait_ready(flags, cols, r, c, d0);
    __syncthreads();
    WAVE_STAMP(tk, 1, tid == 0 && gi == 0);   // the neighbours' flags seen

    // ---- luma: this CTA's candidates at TX_16X16 ----
    S.src[tid] = __ldg(src_y + (size_t)(r * 16 + i) * width + c * 16 + j);
    if (tid < 16)
      load_edges(tid, rec_y, cols, r, c, ha, hl, ur, base, S.above, S.left,
                 &S.corner);
    __syncthreads();
    if (tid < 16) S.left[16 + tid] = S.left[15];  // left2n: replicate
    __syncthreads();
    const int srcv = S.src[lt];
    int lv[MAXG] = {0, 0, 0, 0}, rec[MAXG] = {0, 0, 0, 0};
    if (ng) {
      int pr[MAXG];
      float res[MAXG];
      for (int m = 0; m < MAXG; ++m) {
        pr[m] = 0;
        res[m] = 0.f;
        if (m < ng) {
          pr[m] = pred_px(S.ly.mode_vals[start + m], 16, i, j, S.above,
                          S.left, S.corner, ha, hl, base, S.w + 12, S.dr);
          res[m] = (float)(srcv - pr[m]);
        }
      }
      S.resid[lt] = make_float4(res[0], res[1], res[2], res[3]);
      G.sync();
      // coefficient lt of each candidate: k = 0..255 in order, one fmaf
      // chain per candidate, the matrix's rows from the ring
      float acc[MAXG] = {0.f, 0.f, 0.f, 0.f};
      for (int kt = 0; kt < NTILE; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(full + 8 * s, (it / STAGES) & 1);
        const float* Ft = S.tile[s] + lt;
        const float4* R = &S.resid[kt * KT];
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          const float f = Ft[kk * 256];
          const float4 rk = R[kk];
          acc[0] = fmaf(rk.x, f, acc[0]);
          acc[1] = fmaf(rk.y, f, acc[1]);
          acc[2] = fmaf(rk.z, f, acc[2]);
          acc[3] = fmaf(rk.w, f, acc[3]);
        }
        G.sync();                   // every thread is done with tile s
        if (lt == 0)
          tile_load(S.tile[s], F, (it + STAGES) % NTILE, full + 8 * s);
      }
      WAVE_STAMP(tk, 2, lt == 0 && gi == 1);  // the product's end
      for (int m = 0; m < MAXG; ++m) {
        lv[m] = m < ng ? quant_rdz(acc[m], step, cap, off, q, S.ly.tab, gain,
                                   lam, gate) : 0;
        S.dq[m * 256 + lt] = (u32)(lv[m] * q);
      }
      G.sync();
      inverse_2d_grp<16>(G, tx, ng, S.dq, reinterpret_cast<u32*>(S.resid),
                         256, 16);
      int dist[MAXG];
      for (int m = 0; m < MAXG; ++m) {
        rec[m] = min(max(pr[m] + (int)S.dq[m * 256 + lt], 0), pix_max);
        const int d = rec[m] - srcv;
        dist[m] = m < ng ? d * d : 0;
        if (m < ng) {
          S.lvc[m][lt] = (int16_t)lv[m];
          S.recc[m][lt] = rec[m];
        }
      }
      grp_reduce_i<MAXG, false>(G, dist, S.dred);
      float rate[MAXG];
      rate_bits<MAXG>(G, lv, true, S.ly.tab, S.ly.skip, S.ly.rank, S.ly.eob,
                      S.ired, S.fred, rate);
      if (lt == 0) {
        for (int m = 0; m < ng; ++m) {
          float cost = __fadd_rn(
              __int2float_rn(dist[m]),
              __fmul_rn(lam, __fadd_rn(rate[m], S.ly.mode_bits[start + m])));
          if (S.ly.mode_vals[start + m] == D203 && bl)
            cost = __fadd_rn(cost, INFINITY);
          S0.cost[start + m] = cost;
        }
      }
    }
    // every candidate's cost in rank 0; each CTA keeps its candidates'
    // levels and recon until the next lane's ticket barrier
    cluster.sync();
    if (gi != 0) continue;
    // the argmin over positions in order, strict < (first index on ties)
    int p = 0;
    float best = S.cost[0];
    for (int k = 1; k < NPOS; ++k) {
      if (S.cost[k] < best) {
        best = S.cost[k];
        p = k;
      }
    }

    // ---- rank 0: 8x8 chain, 4x4 chain, U, V on their own warps ----
    WAVE_STAMP(tk, 3, tid == 0);              // the pieces start
    const int g = S.ly.grp[p];
    const int mode = kWaveModes[S.ly.sub_row[p]];
    const int warp = tid >> 5;
    // the 8x8 matrices of the winner's group and of DCT_DCT (chroma), in
    // the shared memory of the CTAs that coded those groups
    int run_p = 0, start_p = 0, run_dct = S.ly.grp[0] == 0 ? 0 : -1;
    for (int k = 1, run = 0, first = 0; k < NPOS; ++k) {
      if (S.ly.grp[k] != S.ly.grp[k - 1]) {
        ++run;
        first = k;
      }
      if (k == p) {
        run_p = run;
        start_p = first;
      }
      if (run_dct < 0 && S.ly.grp[k] == 0) run_dct = run;
    }
    const float* f8 = cluster.map_shared_rank(&S.fwd8[0], run_p);
    const float* dct8 = cluster.map_shared_rank(&S.fwd8[0], run_dct);
    if (warp < 2) {
      sub_chain<8>(Grp{tid, 64, BAR_C8}, S, S.c8, S.r8, f8, g, mode,
                   ha, hl, base, pix_max, lam, gate);
      WAVE_STAMP(tk, 4, tid == 0);            // the 8x8 chain's end
    } else if (warp == 2) {
      sub_chain4(S, S.c4, S.r4, S.fwd4[g], g, mode, ha, hl, base, pix_max,
                 lam, gate);
      WAVE_STAMP(tk, 5, tid == 64);           // the 4x4 chain's end
    } else if (warp < 5) {
      chroma_block(Grp{tid - 96, 64, BAR_U}, S, S.ch[0], dct8, src_u, rec_u,
                   lv_u, cw, cols, r, c, ha, hl, base, pix_max, lam, gate);
      WAVE_STAMP(tk, 6, tid == 96);           // U's end
    } else if (warp < 7) {
      chroma_block(Grp{tid - 160, 64, BAR_V}, S, S.ch[1], dct8, src_v, rec_v,
                   lv_v, cw, cols, r, c, ha, hl, base, pix_max, lam, gate);
    } else {
      chain4_rates(S, S.c4, S.r4);
      WAVE_STAMP(tk, 8, tid == 224);          // the 4x4 rates' end
    }
    __syncthreads();

    // the tx depth: strict <, as the plain version; then the luma write
    const float mbits = S.ly.mode_bits[p];
    const float cb = __fadd_rn(best, T.lam_txd0);
    const float cost8 = __fadd_rn(S.c8.dist, __fmul_rn(lam, __fadd_rn(
        __fadd_rn(S.c8.rate, mbits), __uint_as_float(TXD8_BITS))));
    const float cost4 = __fadd_rn(S.c4.dist, __fmul_rn(lam, __fadd_rn(
        __fadd_rn(S.c4.rate_sum, mbits), __uint_as_float(TXD4_BITS))));
    const int txd = cost8 < fminf(cb, cost4) ? 1 : (cost4 < cb ? 2 : 0);
    const size_t blk = (size_t)r * cols + c;
    const Smem& Sw = *cluster.map_shared_rank(&S, run_p);   // the winner's
    rec_y[blk * 256 + tid] = txd == 1 ? S.c8.recb[tid]
                           : (txd == 2 ? S.c4.recb[tid]
                                       : Sw.recc[p - start_p][tid]);
    lv_y[blk * 256 + tid] = txd == 1 ? (int16_t)S.c8.lvb[tid]
                          : (txd == 2 ? (int16_t)S.c4.lvb[tid]
                                      : Sw.lvc[p - start_p][tid]);
    if (tid == 0) {
      modes[blk] = (int8_t)S.ly.mode_vals[p];
      txds[blk] = (int8_t)txd;
    }
    __syncthreads();
    if (tid == 0) {                 // publish the lane
      __threadfence();
      cuda::atomic_ref<int, cuda::thread_scope_device> f(flags[r * cols + c]);
      f.store(1, cuda::memory_order_release);
      WAVE_STAMP(tk, 7, true);                // published
    }
  }
  // the ring's last tiles are in flight: let them land before exiting
  if (ng)
    for (int s = 0; s < STAGES; ++s, ++it)
      mbar_wait(full + 8 * (it % STAGES), (it / STAGES) & 1);
  cluster.sync();     // no CTA leaves while another may read its memory
}

// The launch configuration of clusters of NWG CTAs (grid: clusters), and
// how many such clusters can be resident at once (0 on an error).
cudaLaunchConfig_t key_config(cudaLaunchAttribute* attr, int clusters,
                              cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = NWG;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NWG * clusters);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = sizeof(Smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

int query_clusters() {
  if (cudaFuncSetAttribute(wave_key_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(Smem)) != cudaSuccess)
    return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = key_config(&attr, 1, nullptr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, wave_key_kernel, &cfg) !=
      cudaSuccess)
    return 0;
  return clusters;
}

// query_clusters for the current device, asked once per device and
// process (the shared memory attribute is set there then; a failed query
// is asked again at the next launch)
constexpr int kMaxDevices = 64;
std::atomic<int> g_clusters[kMaxDevices];

int resident_clusters() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return query_clusters();
  int clusters = g_clusters[dev].load(std::memory_order_relaxed);
  if (clusters == 0) {
    clusters = query_clusters();
    g_clusters[dev].store(clusters, std::memory_order_relaxed);
  }
  return clusters;
}

}  // namespace

// The grid's shape: clusters resident at once, and each CTA's shared
// memory in bytes.
extern "C" int av1_wave_key_clusters() { return resident_clusters(); }
extern "C" int av1_wave_key_smem() { return (int)sizeof(Smem); }

// The keyframe's lanes [0, n) of `lanes` (the schedule's entries from the
// range's first lane) whose diagonals start at d0; flags: (H/16) * (W/16)
// ready flags and the ticket counter after them, zeroed.
extern "C" int av1_wave_key(const WaveTabs* T, const int* src_y,
                            const int* src_u, const int* src_v, int height,
                            int width, int* rec_y, int* rec_u, int* rec_v,
                            int16_t* lv_y, int16_t* lv_u, int16_t* lv_v,
                            int8_t* modes, int8_t* txds, const int* lanes,
                            int n, int d0, int* flags, cudaStream_t stream) {
  int clusters = resident_clusters();
  // every cluster resident at once, and none without a lane to take
  if (clusters > n) clusters = n;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = key_config(&attr, clusters, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, wave_key_kernel, *T, src_y, src_u, src_v, height, width, rec_y,
      rec_u, rec_v, lv_y, lv_u, lv_v, modes, txds, lanes, n, d0, flags);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
