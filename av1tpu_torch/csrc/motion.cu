// The luma motion search of one inter frame, as three hand kernels for
// Hopper: coarse_search (3 launches), global_search (6) and refine_subpel
// (2).
//
// Replaces the jitted search of av1tpu/models/inter_v.py: `_coarse_search`
// (:89), `_global_full` (:287), `_refine_search` (:252), the global snap
// of `_search_mv` (:888-950) and `_subpel_refine` (:374).  These are not
// pallas_calls: XLA fused them, where the port's eager version issued about
// 4,000 PyTorch operations per search and read the global candidates on
// the host three times (kernels/motion.py holds the wrappers and the plain
// PyTorch versions, whose arithmetic these kernels repeat).  The search
// runs once per inter frame of both presets and once per neighbour of the
// keyframe's temporal filter.
//
// What they compute, per 16x16 block unless said otherwise:
//
// A. coarse_search: the 4x4 mean pool of both planes; the +-8 quarter-res
//    full search (289 SADs), its running winner (dx outer, the first dy of
//    the least cost, a strict < across dx), the second-basin candidate
//    (Chebyshev > 1 from the winner, dy-major, first index), and the
//    frame totals of the 289 SADs; then the frame-dominant shift g (argmin
//    of the totals) with its snap, and the top 4 totals (stable).
// B. global_search: 125 whole-frame candidate shifts, 25 around each of
//    shifts4[0], shifts4[1] and (0, 0), then two descent sweeps of 25
//    around the running winner (clipped to +-34 px), each judged by the
//    total of its per-block full-res SADs, the winner updated on a strict
//    <.  The bases are read from device memory: no value goes to the host.
// C. refine_subpel: the +-2 full-pel refine around each base (coarse,
//    coarse2 and the optional temporal base), the snap to the global
//    shift, then the 49-candidate quarter-pel sweep of normative 8-tap MC
//    (InterRound0 then InterRound1), its frame totals, and the snap to the
//    dominant sub-pel offset.
//
// Exactness.  SADs and the MC filters are int32, as in the plain version.
// Every float operation that feeds a decision is written with
// __fadd_rn/__fmul_rn (nvcc would contract a multiply-add to an FMA, which
// rounds once where the plain version rounds twice); the MV-cost biases
// come from the host as the plain version computes them.  Each frame
// total is the exact integer sum (64-bit atomics, exact in any order)
// rounded once to float32, as the plain version computes it, so the
// argmins agree whatever the order of the sums.
//
// What bounds them on an H100.  All integer work: a 1088x1920 search
// reads the two luma planes (8.4 MB int32) a few times and writes a few MB
// of SAD volumes, a few us at 3.35 TB/s; its integer operations (about 0.5
// G abs-diffs and 1 G filter multiply-adds) count against no fp32 or
// tensor peak.  So the stated bound is bytes; the kernels are far from it,
// since each block runs its candidate walk in order on one thread.
//
// What the design does about it.  One block per 16x16 block keeps its
// source and every candidate window in shared memory (the 20x20 quarter-
// res window, the 20x20 full-res window per base, the 24x24 sub-pel patch
// and its seven horizontal passes), so each pixel is read once per base;
// the sums are warp shuffles, and only the short ordered walks (17, 25 or
// 49 steps) are serial.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CR = 8;               // inter_v._COARSE_R
constexpr int ND = 2 * CR + 1;      // 17
constexpr int NC = ND * ND;         // 289 coarse candidates
constexpr int RR = 2;               // inter_v._REFINE_R
constexpr int NR = 25;              // (2 RR + 1)^2
constexpr int MAXMV = 4 * CR + RR;  // inter_v.MAX_MV_PX = 34
constexpr int NSUB = 49;            // 7 x 7 quarter-pel candidates
constexpr int NG = 125;             // global candidates: 3 x 25 + 2 x 25
constexpr int NT = 256;             // one thread per pixel of a 16x16 block
constexpr int NW = NT / 32;

__constant__ int kSubD[7] = {-6, -4, -2, 0, 2, 4, 6};

struct Bias {          // coarse MV-cost biases per offset index 0..16
  float vec[ND];       // _mv_bias over the offsets (the dy table)
  float sca[ND];       // _mv_bias of each offset alone (the dx term)
};
struct Taps {          // the 8-tap bank rows (d & 7) << 1 of kSubD
  int f[7][8];
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the per-thread value v of candidate k into part[k][warp]
__device__ __forceinline__ void warp_part(int v, int k, int* part) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) part[k * NW + (threadIdx.x >> 5)] = v;
}

__device__ __forceinline__ int part_sum(const int* part, int k) {
  int s = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) s += part[k * NW + i];
  return s;
}

__device__ __forceinline__ float total_f32(unsigned long long t) {
  return __ll2float_rn((long long)t);
}

// Warp 0 only: the first index of the least float32 total of n.
__device__ int argmin_totals(const unsigned long long* tot, int n) {
  const int lane = threadIdx.x & 31;
  float bv = inf_f();
  int bk = n;
  for (int k = lane; k < n; k += 32) {
    const float v = total_f32(tot[k]);
    if (v < bv) { bv = v; bk = k; }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int ok = __shfl_xor_sync(0xffffffffu, bk, o);
    if (ov < bv || (ov == bv && ok < bk)) { bv = ov; bk = ok; }
  }
  return bk;
}

// ---- A. coarse_search ------------------------------------------------------

// The 4x4 mean pools of y and ref (exact ints / 16), and the totals zeroed.
__global__ void __launch_bounds__(NT) coarse_pool_kernel(
    const int* __restrict__ y, const int* __restrict__ ref, int h, int w,
    int* __restrict__ src_q, int* __restrict__ ref_q,
    unsigned long long* __restrict__ tot) {
  const int hq = h >> 2, wq = w >> 2;
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx < NC) tot[idx] = 0;
  if (idx >= 2 * hq * wq) return;
  const int plane = idx / (hq * wq), q = idx % (hq * wq);
  const int qy = q / wq, qx = q % wq;
  const int* p = plane ? ref : y;
  int s = 0;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) s += p[(size_t)(4 * qy + i) * w + 4 * qx + j];
  (plane ? ref_q : src_q)[q] = s >> 4;
}

// One block per 16x16 block (a 4x4 quarter-res block): its 289 SADs into
// the volume and the totals, its running winner, its best_sad and its
// second-basin candidate.
__global__ void __launch_bounds__(320) coarse_sad_kernel(
    const int* __restrict__ src_q, const int* __restrict__ ref_q, int hq,
    int wq, Bias bias, int* __restrict__ vol,
    unsigned long long* __restrict__ tot, int* __restrict__ win,
    float* __restrict__ best_sad_out) {
  __shared__ int s_src[16];
  __shared__ int s_ref[20][20];
  __shared__ int s_sad[NC];
  __shared__ float s_colc[ND], s_colmin[ND], s_rowc[ND];
  __shared__ int s_colk[ND], s_rowk[ND], s_best[2];
  const int cols = wq >> 2, nblk = (hq >> 2) * cols;
  const int blk = blockIdx.x, R = blk / cols, C = blk % cols;
  const int t = threadIdx.x;
  if (t < 16) s_src[t] = src_q[(size_t)(4 * R + (t >> 2)) * wq + 4 * C + (t & 3)];
  for (int i = t; i < 400; i += blockDim.x) {
    const int ry = clampi(4 * R - CR + i / 20, 0, hq - 1);
    const int rx = clampi(4 * C - CR + i % 20, 0, wq - 1);
    s_ref[i / 20][i % 20] = ref_q[(size_t)ry * wq + rx];
  }
  __syncthreads();
  if (t < NC) {            // candidate (dy, dx) = (t / 17 - 8, t % 17 - 8)
    const int dy = t / ND, dx = t % ND;
    int s = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s += abs(s_src[i * 4 + j] - s_ref[dy + i][dx + j]);
    s_sad[t] = s;
    vol[(size_t)t * nblk + blk] = s;
    atomicAdd(&tot[t], (unsigned long long)s);
  }
  __syncthreads();
  if (t < ND) {            // column dx = t: torch.min over dy (first index)
    float c = inf_f(), mn = inf_f();
    int k = 0;
    for (int dy = 0; dy < ND; ++dy) {
      const float sad = (float)s_sad[dy * ND + t];
      const float cost = __fadd_rn(sad, __fadd_rn(bias.vec[dy], bias.sca[t]));
      if (cost < c) { c = cost; k = dy; }
      mn = fminf(mn, sad);
    }
    s_colc[t] = c; s_colk[t] = k; s_colmin[t] = mn;
  }
  __syncthreads();
  if (t == 0) {            // across dx: a strict <
    float bc = inf_f(), bs = inf_f();
    int bdy = CR, bdx = CR;
    for (int dx = 0; dx < ND; ++dx)
      if (s_colc[dx] < bc) { bc = s_colc[dx]; bs = s_colmin[dx]; bdy = s_colk[dx]; bdx = dx; }
    s_best[0] = bdy; s_best[1] = bdx;
    best_sad_out[blk] = bs;
  }
  __syncthreads();
  const int bdy = s_best[0], bdx = s_best[1];
  if (t < ND) {            // second basin, row dy = t, first index
    float c = inf_f();
    int k = t * ND;
    for (int dx = 0; dx < ND; ++dx) {
      if (max(abs(t - bdy), abs(dx - bdx)) <= 1) continue;
      const float cost = __fadd_rn(__fadd_rn((float)s_sad[t * ND + dx],
                                             bias.vec[t]), bias.vec[dx]);
      if (cost < c) { c = cost; k = t * ND + dx; }
    }
    s_rowc[t] = c; s_rowk[t] = k;
  }
  __syncthreads();
  if (t == 0) {
    float c = inf_f();
    int k = 0;
    for (int dy = 0; dy < ND; ++dy)
      if (s_rowc[dy] < c) { c = s_rowc[dy]; k = s_rowk[dy]; }
    int* o = win + 4 * (size_t)blk;
    o[0] = bdy; o[1] = bdx; o[2] = k / ND; o[3] = k % ND;
  }
}

// One thread per 16x16 block: the snap to the dominant shift g; block 0
// also writes the stable top 4 totals as shifts4.
__global__ void __launch_bounds__(NT) coarse_select_kernel(
    const unsigned long long* __restrict__ tot, const int* __restrict__ vol,
    const int* __restrict__ win, const float* __restrict__ best_sad,
    int nblk, float margin, int* __restrict__ coarse,
    int* __restrict__ coarse2, int* __restrict__ shifts4) {
  __shared__ int s_g;
  const int t = threadIdx.x;
  if (t < 32) {
    const int g = argmin_totals(tot, NC);
    if (t == 0) s_g = g;
  }
  if (blockIdx.x == 0 && t == 32) {   // top 4, ties: the lower index first
    int chosen[4];
    for (int r = 0; r < 4; ++r) {
      float bv = inf_f();
      int bk = -1;
      for (int k = 0; k < NC; ++k) {
        bool used = false;
        for (int q = 0; q < r; ++q) used |= chosen[q] == k;
        if (used) continue;
        const float v = total_f32(tot[k]);
        if (bk < 0 || v < bv) { bv = v; bk = k; }
      }
      chosen[r] = bk;
      shifts4[2 * r] = (bk / ND - CR) * 4;
      shifts4[2 * r + 1] = (bk % ND - CR) * 4;
    }
  }
  __syncthreads();
  const int blk = blockIdx.x * NT + t;
  if (blk >= nblk) return;
  const int g = s_g;
  const int* o = win + 4 * (size_t)blk;
  const bool snap = (float)vol[(size_t)g * nblk + blk] <=
                    __fadd_rn(best_sad[blk], margin);
  coarse[2 * blk] = ((snap ? g / ND : o[0]) - CR) * 4;
  coarse[2 * blk + 1] = ((snap ? g % ND : o[1]) - CR) * 4;
  coarse2[2 * blk] = (o[2] - CR) * 4;
  coarse2[2 * blk + 1] = (o[3] - CR) * 4;
}

// ---- B. global_search ------------------------------------------------------

// state: [best total (float bits), g_full dy, g_full dx, winning candidate]

// Sweep s (0: 3 bases x 25 unclipped; 1, 2: 25 around the running winner,
// clipped): one block per (16x16 block, base); the block's source and its
// 20x20 reference window once, the 25 SADs into the volume and the totals.
__global__ void __launch_bounds__(NT) global_sweep_kernel(
    const int* __restrict__ y, const int* __restrict__ ref, int h, int w,
    const int* __restrict__ shifts4, const int* __restrict__ state, int sweep,
    int* __restrict__ cand_d, int* __restrict__ vol,
    unsigned long long* __restrict__ tot) {
  __shared__ int s_ref[20][20];
  __shared__ int s_part[NR * NW];
  const int cols = w >> 4, nblk = (h >> 4) * cols;
  const int blk = blockIdx.x, bi = blockIdx.y;
  const int R = blk / cols, C = blk % cols;
  const int t = threadIdx.x, i = t >> 4, j = t & 15;
  int b0, b1;
  if (sweep == 0) {
    b0 = bi < 2 ? shifts4[2 * bi] : 0;
    b1 = bi < 2 ? shifts4[2 * bi + 1] : 0;
  } else {
    b0 = state[1];
    b1 = state[2];
  }
  const int first = sweep == 0 ? bi * NR : 3 * NR + (sweep - 1) * NR;
  const int src = y[(size_t)(16 * R + i) * w + 16 * C + j];
  for (int k = t; k < 400; k += NT) {
    const int ry = clampi(16 * R + b0 - RR + k / 20, 0, h - 1);
    const int rx = clampi(16 * C + b1 - RR + k % 20, 0, w - 1);
    s_ref[k / 20][k % 20] = ref[(size_t)ry * w + rx];
  }
  __syncthreads();
  // |base| <= 34 in every sweep, so a clipped candidate stays inside the
  // window around its base
  for (int k = 0; k < NR; ++k) {
    int d0 = b0 + k / 5 - RR, d1 = b1 + k % 5 - RR;
    if (sweep > 0) { d0 = clampi(d0, -MAXMV, MAXMV); d1 = clampi(d1, -MAXMV, MAXMV); }
    warp_part(abs(src - s_ref[i + d0 - b0 + RR][j + d1 - b1 + RR]), k, s_part);
  }
  __syncthreads();
  if (t < NR) {
    const int s = part_sum(s_part, t), c = first + t;
    vol[(size_t)c * nblk + blk] = s;
    atomicAdd(&tot[c], (unsigned long long)s);
    if (blk == 0) {
      int d0 = b0 + t / 5 - RR, d1 = b1 + t % 5 - RR;
      if (sweep > 0) { d0 = clampi(d0, -MAXMV, MAXMV); d1 = clampi(d1, -MAXMV, MAXMV); }
      cand_d[2 * c] = d0;
      cand_d[2 * c + 1] = d1;
    }
  }
}

// One block: the sweep's candidates in order, the winner on a strict <;
// after the last sweep, sad_g (the winner's block SADs), g_full and c0.
__global__ void __launch_bounds__(NT) global_select_kernel(
    const unsigned long long* __restrict__ tot, const int* __restrict__ cand_d,
    int first, int count, int* __restrict__ state, int last,
    const int* __restrict__ vol, int nblk, float* __restrict__ sad_g,
    int* __restrict__ c0, int* __restrict__ g_full) {
  __shared__ int s_win;
  if (threadIdx.x == 0) {
    float best = first == 0 ? inf_f() : __int_as_float(state[0]);
    int g0 = state[1], g1 = state[2], win = state[3];
    for (int c = first; c < first + count; ++c) {
      const float v = total_f32(tot[c]);
      if (v < best) { best = v; g0 = cand_d[2 * c]; g1 = cand_d[2 * c + 1]; win = c; }
    }
    state[0] = __float_as_int(best);
    state[1] = g0; state[2] = g1; state[3] = win;
    s_win = win;
    if (last) {
      g_full[0] = g0; g_full[1] = g1;
      c0[0] = clampi(((g0 + 2) >> 2) * 4, -4 * CR, 4 * CR);
      c0[1] = clampi(((g1 + 2) >> 2) * 4, -4 * CR, 4 * CR);
    }
  }
  if (!last) return;
  __syncthreads();
  const int* v = vol + (size_t)s_win * nblk;
  for (int b = threadIdx.x; b < nblk; b += NT) sad_g[b] = (float)v[b];
}

// ---- C. refine_subpel ------------------------------------------------------

// The 24x24 clamped patch at the block's MV (row r <-> 16R + mv + r - 4)
// into s_p, then the 24x16 horizontal pass of sub-pel column xi into dst.
__device__ __forceinline__ void load_p24(const int* __restrict__ ref, int h,
                                         int w, int R, int C, int m0, int m1,
                                         int (*s_p)[24]) {
  for (int k = threadIdx.x; k < 576; k += NT) {
    const int ry = clampi(16 * R + m0 - 4 + k / 24, 0, h - 1);
    const int rx = clampi(16 * C + m1 - 4 + k % 24, 0, w - 1);
    s_p[k / 24][k % 24] = ref[(size_t)ry * w + rx];
  }
}

__device__ __forceinline__ int hor_tap(const int (*s_p)[24], const Taps& tp,
                                       int xi, int r, int c) {
  const int ix = kSubD[xi] >> 3;
  int a = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) a += tp.f[xi][k] * s_p[r][c + 1 + ix + k];
  return (a + 4) >> 3;                                  // InterRound0
}

// pixel (i, j) of sub-pel row yi from a 24x16 horizontal pass
__device__ __forceinline__ int ver_tap(const int* hor, const Taps& tp, int yi,
                                       int i, int j, int pix_max) {
  const int iy = kSubD[yi] >> 3;
  int a = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) a += tp.f[yi][k] * hor[(1 + iy + k + i) * 16 + j];
  return clampi((a + 1024) >> 11, 0, pix_max);          // InterRound1
}

// out (int32 words, per block b): mv8 [2b], mv_px [2 nblk + 2b], coarse_f
// [4 nblk + 2b], off_f [6 nblk + 2b], the sweep's best index [8 nblk + b]
// and best SAD (float bits) [9 nblk + b].
__global__ void __launch_bounds__(NT) refine_kernel(
    const int* __restrict__ y, const int* __restrict__ ref, int h, int w,
    const int* __restrict__ base0, const int* __restrict__ base1,
    const int* __restrict__ base2, const int* __restrict__ c0,
    const int* __restrict__ g_full, const float* __restrict__ sad_g,
    float unit_r, float unit_s, float m14, int pix_max, Taps tp,
    unsigned long long* __restrict__ tot, int* __restrict__ out,
    int* __restrict__ pred) {
  __shared__ int s_ref[20][20];
  __shared__ int s_p[24][24];
  __shared__ int s_hor[7][24 * 16];
  __shared__ int s_part[NSUB * NW];
  __shared__ int s_mv[2], s_bk;
  const int cols = w >> 4, nblk = (h >> 4) * cols;
  const int blk = blockIdx.x, R = blk / cols, C = blk % cols;
  const int t = threadIdx.x, i = t >> 4, j = t & 15;
  const int src = y[(size_t)(16 * R + i) * w + 16 * C + j];

  // the +-2 refine around each base; thread 0 keeps the walk's state
  float bc = inf_f(), bsad = inf_f();
  int bm0 = 0, bm1 = 0, bf0 = 0, bf1 = 0;
  const int nb = base2 ? 3 : 2;
  for (int bi = 0; bi < nb; ++bi) {
    const int* bp = bi == 0 ? base0 : bi == 1 ? base1 : base2;
    const int b0 = bp[2 * blk], b1 = bp[2 * blk + 1];
    __syncthreads();
    for (int k = t; k < 400; k += NT) {
      const int ry = clampi(16 * R + b0 - RR + k / 20, 0, h - 1);
      const int rx = clampi(16 * C + b1 - RR + k % 20, 0, w - 1);
      s_ref[k / 20][k % 20] = ref[(size_t)ry * w + rx];
    }
    __syncthreads();
    for (int k = 0; k < NR; ++k)
      warp_part(abs(src - s_ref[i + k / 5][j + k % 5]), k, s_part);
    __syncthreads();
    if (t == 0) {
      float c = inf_f(), sd = inf_f();
      int m0 = 0, m1 = 0;
      for (int k = 0; k < NR; ++k) {
        const int dy = k / 5 - RR, dx = k % 5 - RR;
        const float sad = (float)part_sum(s_part, k);
        const float cost = __fadd_rn(sad, __fmul_rn(unit_r, (float)(abs(dy) + abs(dx))));
        if (cost < c) { c = cost; sd = sad; m0 = b0 + dy; m1 = b1 + dx; }
      }
      if (bi == 0 || c < bc) { bc = c; bsad = sd; bm0 = m0; bm1 = m1; bf0 = b0; bf1 = b1; }
    }
  }
  if (t == 0) {            // the snap to the global shift
    const bool snap = sad_g[blk] <= __fadd_rn(bsad, m14);
    const int m0 = snap ? g_full[0] : bm0, m1 = snap ? g_full[1] : bm1;
    const int f0 = snap ? c0[0] : bf0, f1 = snap ? c0[1] : bf1;
    out[2 * nblk + 2 * blk] = m0; out[2 * nblk + 2 * blk + 1] = m1;
    out[4 * nblk + 2 * blk] = f0; out[4 * nblk + 2 * blk + 1] = f1;
    out[6 * nblk + 2 * blk] = m0 - f0; out[6 * nblk + 2 * blk + 1] = m1 - f1;
    s_mv[0] = m0; s_mv[1] = m1;
  }
  __syncthreads();

  // the quarter-pel sweep: seven horizontal passes, then 49 vertical ones
  load_p24(ref, h, w, R, C, s_mv[0], s_mv[1], s_p);
  __syncthreads();
  for (int k = t; k < 7 * 384; k += NT) {
    const int xi = k / 384, r = (k / 16) % 24, c = k % 16;
    s_hor[xi][r * 16 + c] = hor_tap(s_p, tp, xi, r, c);
  }
  __syncthreads();
  for (int yi = 0; yi < 7; ++yi)
    for (int xi = 0; xi < 7; ++xi)
      warp_part(abs(src - ver_tap(s_hor[xi], tp, yi, i, j, pix_max)),
                yi * 7 + xi, s_part);
  __syncthreads();
  if (t < NSUB) atomicAdd(&tot[t], (unsigned long long)part_sum(s_part, t));
  if (t == 0) {            // dy outer, dx inner, a strict <
    float c = inf_f(), sd = inf_f();
    int bk = 0;
    for (int k = 0; k < NSUB; ++k) {
      const int dy = kSubD[k / 7], dx = kSubD[k % 7];
      const float sad = (float)part_sum(s_part, k);
      const float n = (float)(2 * (dy != 0) + 2 * (dx != 0));
      const float cost = __fadd_rn(sad, __fmul_rn(unit_s, n));
      if (cost < c) { c = cost; sd = sad; bk = k; }
    }
    out[8 * nblk + blk] = bk;
    out[9 * nblk + blk] = __float_as_int(sd);
    s_bk = bk;
  }
  __syncthreads();
  pred[(size_t)blk * 256 + t] =
      ver_tap(s_hor[s_bk % 7], tp, s_bk / 7, i, j, pix_max);
}

// The snap to the dominant sub-pel offset (argmin of the 49 totals), and
// mv8 = mv_px * 8 + the chosen offset.
__global__ void __launch_bounds__(NT) subpel_snap_kernel(
    const int* __restrict__ y, const int* __restrict__ ref, int h, int w,
    const unsigned long long* __restrict__ tot, float m14, int pix_max,
    Taps tp, int* __restrict__ out, int* __restrict__ pred) {
  __shared__ int s_p[24][24];
  __shared__ int s_hor[24 * 16];
  __shared__ int s_part[NW];
  __shared__ int s_gi, s_snap;
  const int cols = w >> 4, nblk = (h >> 4) * cols;
  const int blk = blockIdx.x, R = blk / cols, C = blk % cols;
  const int t = threadIdx.x, i = t >> 4, j = t & 15;
  const int src = y[(size_t)(16 * R + i) * w + 16 * C + j];
  if (t < 32) {
    const int g = argmin_totals(tot, NSUB);
    if (t == 0) s_gi = g;
  }
  const int m0 = out[2 * nblk + 2 * blk], m1 = out[2 * nblk + 2 * blk + 1];
  load_p24(ref, h, w, R, C, m0, m1, s_p);
  __syncthreads();
  const int gi = s_gi;
  for (int k = t; k < 384; k += NT)
    s_hor[k] = hor_tap(s_p, tp, gi % 7, k / 16, k % 16);
  __syncthreads();
  const int v = ver_tap(s_hor, tp, gi / 7, i, j, pix_max);
  warp_part(abs(src - v), 0, s_part);
  __syncthreads();
  if (t == 0) {
    const float sad = (float)part_sum(s_part, 0);
    s_snap = sad <= __fadd_rn(__int_as_float(out[9 * nblk + blk]), m14);
    const int bk = s_snap ? gi : out[8 * nblk + blk];
    out[2 * blk] = m0 * 8 + kSubD[bk / 7];
    out[2 * blk + 1] = m1 * 8 + kSubD[bk % 7];
  }
  __syncthreads();
  if (s_snap) pred[(size_t)blk * 256 + t] = v;
}

// workspace layouts, in int32 words (64-bit totals first)
struct CoarseWs {
  size_t tot, src_q, ref_q, vol, win, best_sad, words;
  __host__ __device__ CoarseWs(int h, int w) {
    const size_t nq = (size_t)(h >> 2) * (w >> 2);
    const size_t nblk = (size_t)(h >> 4) * (w >> 4);
    tot = 0;
    src_q = 2 * NC;
    ref_q = src_q + nq;
    vol = ref_q + nq;
    win = vol + NC * nblk;
    best_sad = win + 4 * nblk;
    words = best_sad + nblk;
  }
};

// the zeroed part of global_search's workspace: totals, state, candidates
constexpr int G_TOT = 0, G_STATE = 2 * NG, G_CAND = G_STATE + 4,
              G_ZERO_WORDS = G_CAND + 2 * NG;

}  // namespace

extern "C" int av1_motion_ws_words(int kind, int h, int w) {
  if (kind == 0) return (int)CoarseWs(h, w).words;
  if (kind == 1) return G_ZERO_WORDS;
  return 0;
}

// ws: CoarseWs(h, w).words int32 words; coarse, coarse2: (rows, cols, 2);
// shifts4: (4, 2).  bias: 2 x 17 floats (host).
extern "C" int av1_coarse_search(const int* y, const int* ref, int h, int w,
                                 const float* bias, float margin, int* ws,
                                 int* coarse, int* coarse2, int* shifts4,
                                 cudaStream_t stream) {
  const CoarseWs L(h, w);
  Bias b;
  for (int k = 0; k < ND; ++k) { b.vec[k] = bias[k]; b.sca[k] = bias[ND + k]; }
  auto* tot = reinterpret_cast<unsigned long long*>(ws + L.tot);
  const int hq = h >> 2, wq = w >> 2, nblk = (h >> 4) * (w >> 4);
  coarse_pool_kernel<<<(max(2 * hq * wq, NC) + NT - 1) / NT, NT, 0, stream>>>(
      y, ref, h, w, ws + L.src_q, ws + L.ref_q, tot);
  coarse_sad_kernel<<<nblk, 320, 0, stream>>>(
      ws + L.src_q, ws + L.ref_q, hq, wq, b, ws + L.vol, tot, ws + L.win,
      reinterpret_cast<float*>(ws + L.best_sad));
  coarse_select_kernel<<<(nblk + NT - 1) / NT, NT, 0, stream>>>(
      tot, ws + L.vol, ws + L.win, reinterpret_cast<float*>(ws + L.best_sad),
      nblk, margin, coarse, coarse2, shifts4);
  return (int)cudaGetLastError();
}

// zws: G_ZERO_WORDS zeroed int32 words; vol: 125 x nblk int32; sad_g:
// (rows, cols) float; c0, g_full: (2,) int32.
extern "C" int av1_global_search(const int* y, const int* ref, int h, int w,
                                 const int* shifts4, int* zws, int* vol,
                                 float* sad_g, int* c0, int* g_full,
                                 cudaStream_t stream) {
  const int nblk = (h >> 4) * (w >> 4);
  auto* tot = reinterpret_cast<unsigned long long*>(zws + G_TOT);
  int* state = zws + G_STATE;
  int* cand = zws + G_CAND;
  for (int s = 0; s < 3; ++s) {
    const int nb = s == 0 ? 3 : 1;
    global_sweep_kernel<<<dim3(nblk, nb), NT, 0, stream>>>(
        y, ref, h, w, shifts4, state, s, cand, vol, tot);
    global_select_kernel<<<1, NT, 0, stream>>>(
        tot, cand, s == 0 ? 0 : 3 * NR + (s - 1) * NR, nb * NR, state,
        s == 2, vol, nblk, sad_g, c0, g_full);
  }
  return (int)cudaGetLastError();
}

// bases: base0, base1 and optional base2, (rows, cols, 2); tot: 49 zeroed
// 64-bit totals; out: 10 x nblk int32 words (refine_kernel's layout);
// pred: (rows, cols, 16, 16).  taps: 7 x 8 ints (host).
extern "C" int av1_refine_subpel(const int* y, const int* ref, int h, int w,
                                 const int* base0, const int* base1,
                                 const int* base2, const int* c0,
                                 const int* g_full, const float* sad_g,
                                 float unit_r, float unit_s, float m14,
                                 int pix_max, const int* taps,
                                 unsigned long long* tot, int* out,
                                 int* pred, cudaStream_t stream) {
  Taps tp;
  for (int k = 0; k < 56; ++k) tp.f[k / 8][k % 8] = taps[k];
  const int nblk = (h >> 4) * (w >> 4);
  refine_kernel<<<nblk, NT, 0, stream>>>(
      y, ref, h, w, base0, base1, base2, c0, g_full, sad_g, unit_r, unit_s,
      m14, pix_max, tp, tot, out, pred);
  subpel_snap_kernel<<<nblk, NT, 0, stream>>>(y, ref, h, w, tot, m14,
                                              pix_max, tp, out, pred);
  return (int)cudaGetLastError();
}
