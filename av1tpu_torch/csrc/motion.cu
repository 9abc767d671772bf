// The luma motion search of one inter frame, as three hand kernels for
// Hopper: coarse_search (3 launches), global_search (3) and refine_subpel
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
// Exactness.  SADs and the MC filters are int32, as in the plain version.
// Every float operation that feeds a decision is written with
// __fadd_rn/__fmul_rn (nvcc would contract a multiply-add to an FMA, which
// rounds once where the plain version rounds twice); the MV-cost biases
// come from the host as the plain version computes them.  Each frame
// total is the exact integer sum (64-bit atomics, exact in any order)
// rounded once to float32, as the plain version computes it, so the
// argmins agree whatever the order of the sums.  Every walk of the plain
// version (the first index of the least cost on a strict <) is a parallel
// argmin on (cost, index): the same float costs, the lower index on a tie.
//
// What bounds them on an H100.  All of the work is int32: adds, filter
// multiply-adds and abs-diffs with their accumulate (one __sad, one
// VABSDIFF), one operation each, at 64 INT32 lanes per SM per clock
// (about 16.7 T/s at 132 SMs and 1.98 GHz).  Per 1088x1920 search that is
// about 42 M operations for A, 261 M for B (125 displacements x 2.09 M
// pixels) and 429 M for C with two bases (2 x 25 + 49 candidates x 2.09 M
// pixels, and 27 k filter multiply-adds per block), some 2.5, 15.6 and
// 25.6 us; their bytes (the two int32 planes, 16.7 MB) take 5.0 us.  So
// bytes bound A and operations B and C (chip_smoke.py:search_ops and
// search_bounds count them).
//
// A. coarse_search: the 4x4 mean pool of both planes; the +-8 quarter-res
//    full search (289 SADs), its running winner (dx outer, the first dy of
//    the least cost, a strict < across dx), the second-basin candidate
//    (Chebyshev > 1 from the winner, dy-major, first index), and the
//    frame totals of the 289 SADs; then the frame-dominant shift g (argmin
//    of the totals) with its snap, and the top 4 totals (stable).  Three
//    launches: the pool (bytes: it reads both planes once), the sweep and
//    the select.  The sweep gives a warp to a block, and a CTA to a 4x8
//    tile of blocks with its 32x48 quarter-res window in shared memory
//    (row stride 49, so lane k's reads fall on bank k: conflict-free);
//    lane l sums the candidates l + 32 i with __sad and keeps them in
//    registers.  The plain walks reduce to lexicographic keys, so each is
//    one butterfly argmin: the winner the least (cost, dx, dy), its
//    best_sad the least raw SAD of the winning column, the second basin
//    the least (cost, dy-major index) outside Chebyshev 1.  A CTA sums
//    its 32 blocks' SADs per candidate (integers, so in any order) and
//    adds them to the frame totals with one 64-bit atomic per candidate:
//    255 CTAs x 289 atomics at 1088x1920, where one per block and
//    candidate made 2.36 M on 289 addresses.  No per-block SAD volume:
//    the select recomputes each block's SAD at g from the pooled planes,
//    16 abs-diffs, the same integer.  The select's top 4 is four warp
//    argmins on (total, index), each without the earlier picks.
// B. global_search: 125 whole-frame candidate shifts, 25 around each of
//    shifts4[0], shifts4[1] and (0, 0), then two descent sweeps of 25
//    around the running winner (clipped to +-34 px), each judged by the
//    total of its per-block full-res SADs, the winner updated on a strict
//    <.  Every block is judged at the same displacement, so a CTA owns a
//    2x4 tile of blocks (one warp each) and loads the tile's reference
//    window (the tile and a 2-px halo, per base) into shared memory once.
//    A lane holds 8 source pixels of a column and slides down the window's
//    columns for the 5 dx offsets, summing the 25 SADs in registers; one
//    transposed warp reduction leaves candidate k's block SAD in lane k (a
//    clipped descent candidate takes the lane of the unclipped one at its
//    displacement).  The last CTA of each sweep (a fence and an atomic
//    ticket) runs the select, so the search is 3 launches and no value
//    goes to the host.  The per-block SADs go to a volume; the last select
//    copies the winner's column out as sad_g.
// C. refine_subpel: the +-2 full-pel refine around each base (coarse,
//    coarse2 and the optional temporal base), the snap to the global
//    shift, then the 49-candidate quarter-pel sweep of normative 8-tap MC
//    (InterRound0 then InterRound1), its frame totals, and the snap to the
//    dominant sub-pel offset.  One warp per 16x16 block: the full-pel
//    refine as B's block SADs, a parallel argmin per base.  The seven
//    quarter-pel offsets fall on four filter phases (kernels/motion.py
//    checks the table's shape: -6/2, -4/4 and -2/6 share a row one pixel
//    apart, 0 is the identity, taps 0 and 7 are zero), so each phase is
//    computed once, 6 taps wide, and a candidate is a shifted view.  A lane
//    owns a column of 8 output rows: it slides a register window down the
//    14 horizontal-pass rows it needs, computes each vertical phase once
//    per row and adds the abs-diffs of every candidate that reads it, 49
//    sums in registers, then two transposed warp reductions.  The second
//    launch takes the argmin of the 49 totals and rebuilds a prediction
//    only where the snap changes the block's offset.
//
// Windows and patches reach shared memory by cp.async, 4 bytes per copy,
// so a row clamped at the frame edge needs no path of its own.

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
constexpr int NT = 256;             // A: the pool's and the select's CTA
constexpr unsigned FULL = 0xffffffffu;

__constant__ int kSubD[7] = {-6, -4, -2, 0, 2, 4, 6};

struct Bias {          // coarse MV-cost biases per offset index 0..16
  float vec[ND];       // _mv_bias over the offsets (the dy table)
  float sca[ND];       // _mv_bias of each offset alone (the dx term)
};
struct Phases {        // taps 1..6 of the bank rows 4, 8 and 12: the
  int f[3][6];         // phases of the offsets -6/2, -4/4 and -2/6
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

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
    const float ov = __shfl_xor_sync(FULL, bv, o);
    const int ok = __shfl_xor_sync(FULL, bk, o);
    if (ov < bv || (ov == bv && ok < bk)) { bv = ov; bk = ok; }
  }
  return bk;
}

// Every lane of the warp gets the least (cost, index): the lower index on
// a tie, which is the plain version's first index on a strict <.
__device__ __forceinline__ void warp_argmin(float& c, int& k) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float oc = __shfl_xor_sync(FULL, c, o);
    const int ok = __shfl_xor_sync(FULL, k, o);
    if (oc < c || (oc == c && ok < k)) { c = oc; k = ok; }
  }
}

// One step of the transposed reduction: lanes with bit O set keep the
// upper O values and trade the lower ones with the lane O away.
template <int O>
__device__ __forceinline__ void reduce_step(int (&v)[32], bool up) {
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const int send = up ? v[k] : v[k + O];
    const int keep = up ? v[k + O] : v[k];
    v[k] = keep + __shfl_xor_sync(FULL, send, O);
  }
}

// v[k]: a lane's part of candidate k's sum.  Returns, in lane k, the whole
// warp's sum of candidate k: 31 shuffles for 32 candidates.
__device__ __forceinline__ int reduce32(int (&v)[32]) {
  const int lane = threadIdx.x & 31;
  reduce_step<16>(v, lane & 16);
  reduce_step<8>(v, lane & 8);
  reduce_step<4>(v, lane & 4);
  reduce_step<2>(v, lane & 2);
  reduce_step<1>(v, lane & 1);
  return v[0];
}

// acc + |a - b|: one VABSDIFF with its accumulator, where abs and an add
// are two instructions
__device__ __forceinline__ int sad_acc(int a, int b, int acc) {
  return (int)__sad(a, b, (unsigned)acc);
}

// A 4-byte asynchronous copy from device memory to shared memory; every
// copy of the thread is complete after copy_wait.
__device__ __forceinline__ void copy4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The warp's lanes and a 16x16 block: lane (j, half) holds column j of rows
// 8 half .. 8 half + 7.
__device__ __forceinline__ int lane_col() { return threadIdx.x & 15; }
__device__ __forceinline__ int lane_row0() { return (threadIdx.x & 16) >> 1; }

__device__ __forceinline__ void load_src(const int* __restrict__ y, int w,
                                         int R, int C, int (&src)[8]) {
  const int* p = y + (size_t)(16 * R + lane_row0()) * w + 16 * C + lane_col();
#pragma unroll
  for (int i = 0; i < 8; ++i) src[i] = p[(size_t)i * w];
}

// The 25 full-pel candidates (dy, dx) = (bb - 2, a - 2) of a window whose
// (0, 0) is the block's origin moved by (-2, -2): acc[5 bb + a] += this
// lane's abs-diffs.  Each window column is read once into registers.
__device__ __forceinline__ void sad25(const int* win, int stride,
                                      const int (&src)[8], int (&acc)[32]) {
  const int* p = win + lane_row0() * stride + lane_col();
#pragma unroll
  for (int a = 0; a < 5; ++a) {
    int col[12];
#pragma unroll
    for (int r = 0; r < 12; ++r) col[r] = p[r * stride + a];
#pragma unroll
    for (int bb = 0; bb < 5; ++bb) {
      int& s = acc[5 * bb + a];
#pragma unroll
      for (int i = 0; i < 8; ++i) s = sad_acc(src[i], col[bb + i], s);
    }
  }
}

// ---- A. coarse_search ------------------------------------------------------

constexpr int CTR = 4, CTC = 8;           // a sweep CTA's tile of blocks
constexpr int CWARPS = CTC;               // a warp per column, CTR blocks
constexpr int CSLOT = (NC + 31) / 32;     // 10 candidates per lane
constexpr int CWH = 4 * CTR + 2 * CR;     // the tile's quarter-res window,
constexpr int CWW = 4 * CTC + 2 * CR;     // rows and columns (32 x 48 at 4)
constexpr int CWS = 49;                   // its row stride, 17 mod 32: lane
                                          // k reads bank k + const
static_assert(CWS >= CWW && CWS % 32 == ND, "coarse window stride");

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
  const int* p = (plane ? ref : y) + (size_t)(4 * qy) * w + 4 * qx;
  int s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s += p[(size_t)i * w + j];
  (plane ? ref_q : src_q)[q] = s >> 4;
}

// One CTA per 4x8 tile of 16x16 blocks (4x4 quarter-res blocks), one warp
// per column of the tile, lane l on the candidates k = l + 32 i, (dy, dx) =
// (k / 17, k % 17) - 8.  Per block: its 289 SADs in registers, its running
// winner, best_sad and second-basin candidate as warp argmins, written to
// win; the CTA's sums of the SADs go to the totals, one atomic per
// candidate.
__global__ void __launch_bounds__(CWARPS * 32) coarse_sweep_kernel(
    const int* __restrict__ src_q, const int* __restrict__ ref_q, int hq,
    int wq, Bias bias, unsigned long long* __restrict__ tot,
    int4* __restrict__ win) {
  __shared__ int s_ref[CWH * CWS];
  __shared__ int s_src[4 * CTR][4 * CTC];
  __shared__ int s_part[CWARPS][NC];
  __shared__ float s_vec[ND], s_add[NC];
  const int rows = hq >> 2, cols = wq >> 2;
  const int tiles_c = (cols + CTC - 1) / CTC;
  const int R0 = CTR * (blockIdx.x / tiles_c), C0 = CTC * (blockIdx.x % tiles_c);
  const int t = threadIdx.x, lane = t & 31, wp = t >> 5;
  const int qy0 = 4 * R0 - CR, qx0 = 4 * C0 - CR;
  for (int i = t; i < CWH * CWW; i += CWARPS * 32)
    copy4(&s_ref[(i / CWW) * CWS + i % CWW],
          &ref_q[(size_t)clampi(qy0 + i / CWW, 0, hq - 1) * wq +
                 clampi(qx0 + i % CWW, 0, wq - 1)]);
  for (int i = t; i < 16 * CTR * CTC; i += CWARPS * 32) {
    const int r = i / (4 * CTC), c = i % (4 * CTC);
    s_src[r][c] = src_q[(size_t)min(4 * R0 + r, hq - 1) * wq +
                        min(4 * C0 + c, wq - 1)];
  }
  if (t < ND) s_vec[t] = bias.vec[t];
  for (int k = t; k < NC; k += CWARPS * 32)
    s_add[k] = __fadd_rn(bias.vec[k / ND], bias.sca[k % ND]);
  copy_wait();
  __syncthreads();

  int part[CSLOT] = {};
  for (int br = 0; br < CTR; ++br) {
    const int R = R0 + br, C = C0 + wp;
    if (R >= rows || C >= cols) break;
    int src[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) src[i] = s_src[4 * br + (i >> 2)][4 * wp + (i & 3)];
    const int* wb = s_ref + 4 * br * CWS + 4 * wp;
    int sad[CSLOT];
    // the winner: the least (cost, dx, dy), which is the plain version's
    // walk (torch.min's first dy per column, a strict < across dx)
    float bc = inf_f();
    int bkey = NC;
#pragma unroll
    for (int i = 0; i < CSLOT; ++i) {
      const int k = lane + 32 * i;
      if (k >= NC) { sad[i] = 0; continue; }
      const int dy = k / ND, dx = k % ND;
      const int* p = wb + dy * CWS + dx;
      int s = 0;
#pragma unroll
      for (int e = 0; e < 16; ++e) s = sad_acc(src[e], p[(e >> 2) * CWS + (e & 3)], s);
      sad[i] = s;
      part[i] += s;
      const float cost = __fadd_rn((float)s, s_add[k]);
      const int key = dx * ND + dy;
      if (cost < bc || (cost == bc && key < bkey)) { bc = cost; bkey = key; }
    }
    warp_argmin(bc, bkey);
    const int bdx = bkey / ND, bdy = bkey % ND;
    // best_sad: the least raw SAD of the winning column
    int mn = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < CSLOT; ++i) {
      const int k = lane + 32 * i;
      if (k < NC && k % ND == bdx) mn = min(mn, sad[i]);
    }
    mn = __reduce_min_sync(FULL, mn);
    // the second basin: the least (cost, k) outside Chebyshev 1 of the
    // winner, k dy-major (torch.argmin's first index; the near ones inf)
    float c2 = inf_f();
    int k2 = NC;
#pragma unroll
    for (int i = 0; i < CSLOT; ++i) {
      const int k = lane + 32 * i;
      if (k >= NC) continue;
      const int dy = k / ND, dx = k % ND;
      const float cost =
          max(abs(dy - bdy), abs(dx - bdx)) <= 1
              ? inf_f()
              : __fadd_rn(__fadd_rn((float)sad[i], s_vec[dy]), s_vec[dx]);
      if (cost < c2 || (cost == c2 && k < k2)) { c2 = cost; k2 = k; }
    }
    warp_argmin(c2, k2);
    if (lane == 0)
      win[(size_t)R * cols + C] = make_int4(bdy, bdx, k2,
                                            __float_as_int((float)mn));
  }
#pragma unroll
  for (int i = 0; i < CSLOT; ++i)
    if (lane + 32 * i < NC) s_part[wp][lane + 32 * i] = part[i];
  __syncthreads();
  for (int k = t; k < NC; k += CWARPS * 32) {
    int s = 0;
#pragma unroll
    for (int i = 0; i < CWARPS; ++i) s += s_part[i][k];
    atomicAdd(&tot[k], (unsigned long long)s);
  }
}

// One thread per 16x16 block: the frame-dominant shift g (each CTA's warp
// 0), the block's SAD at g recomputed from the pooled planes, and the snap;
// CTA 0's warp 1 writes the stable top 4 totals as shifts4, four warp
// argmins on (total, index), each without the earlier picks.
__global__ void __launch_bounds__(NT) coarse_select_kernel(
    const unsigned long long* __restrict__ tot,
    const int* __restrict__ src_q, const int* __restrict__ ref_q, int hq,
    int wq, const int4* __restrict__ win, float margin,
    int* __restrict__ coarse, int* __restrict__ coarse2,
    int* __restrict__ shifts4) {
  __shared__ int s_g;
  const int t = threadIdx.x, lane = t & 31;
  const int cols = wq >> 2, nblk = (hq >> 2) * cols;
  const int blk = blockIdx.x * NT + t;
  const int R = blk / cols, C = blk % cols;
  int src[16];             // loaded while warp 0 finds g
#pragma unroll
  for (int i = 0; i < 16; ++i)
    src[i] = blk < nblk ? src_q[(size_t)(4 * R + (i >> 2)) * wq + 4 * C + (i & 3)]
                        : 0;
  if (t < 32) {
    const int g = argmin_totals(tot, NC);
    if (t == 0) s_g = g;
  } else if (blockIdx.x == 0 && t < 64) {
    float v[CSLOT];
#pragma unroll
    for (int i = 0; i < CSLOT; ++i)
      v[i] = lane + 32 * i < NC ? total_f32(tot[lane + 32 * i]) : inf_f();
    unsigned used = 0;
    for (int r = 0; r < 4; ++r) {
      float bv = inf_f();
      int bk = NC;
#pragma unroll
      for (int i = 0; i < CSLOT; ++i) {
        const int k = lane + 32 * i;
        if (k < NC && !(used >> i & 1) && (v[i] < bv || (v[i] == bv && k < bk))) {
          bv = v[i];
          bk = k;
        }
      }
      warp_argmin(bv, bk);
      if ((bk & 31) == lane) used |= 1u << (bk >> 5);
      if (lane == 0) {
        shifts4[2 * r] = (bk / ND - CR) * 4;
        shifts4[2 * r + 1] = (bk % ND - CR) * 4;
      }
    }
  }
  __syncthreads();
  if (blk >= nblk) return;
  const int g = s_g, gy = g / ND - CR, gx = g % ND - CR;
  int s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int* rr = ref_q + (size_t)clampi(4 * R + i + gy, 0, hq - 1) * wq;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s = sad_acc(src[4 * i + j], rr[clampi(4 * C + j + gx, 0, wq - 1)], s);
  }
  const int4 o = win[blk];
  const bool snap = (float)s <= __fadd_rn(__int_as_float(o.w), margin);
  coarse[2 * blk] = ((snap ? g / ND : o.x) - CR) * 4;
  coarse[2 * blk + 1] = ((snap ? g % ND : o.y) - CR) * 4;
  coarse2[2 * blk] = (o.z / ND - CR) * 4;
  coarse2[2 * blk + 1] = (o.z % ND - CR) * 4;
}

// ---- B. global_search ------------------------------------------------------

constexpr int GTR = 2, GTC = 4;           // a CTA's tile of blocks
constexpr int GW = GTR * GTC;             // one warp per block of the tile
constexpr int GRH = 16 * GTR + 2 * RR;    // the tile's reference window, rows
constexpr int GRW = 16 * GTC + 2 * RR;    // and columns
constexpr int GRS = GRW + 2;              // its row stride: rows 8 apart fall
                                          // on other banks
// the zeroed workspace: 125 totals (64-bit), state [best total (float
// bits), g_full dy, g_full dx, winning candidate], one ticket per sweep
constexpr int G_TOT = 0, G_STATE = 2 * NG, G_TICKET = G_STATE + 4,
              G_ZERO_WORDS = G_TICKET + 4;

// the displacement of sweep 0's candidate c (3 bases x 25, unclipped)
__device__ __forceinline__ void sweep0_d(const int* shifts4, int c, int& d0,
                                         int& d1) {
  const int b = c / NR, k = c % NR;
  d0 = (b < 2 ? shifts4[2 * b] : 0) + k / 5 - RR;
  d1 = (b < 2 ? shifts4[2 * b + 1] : 0) + k % 5 - RR;
}

// Sweep s (0: 3 bases x 25 unclipped, grid.y the base; 1, 2: 25 around
// the running winner, clipped): one CTA per 2x4 tile of blocks, each
// block's 25 SADs into the volume and the CTA's sums into the totals.  The
// sweep's last CTA picks the winner; after sweep 2 it writes g_full, c0
// and sad_g (the winner's block SADs).
__global__ void __launch_bounds__(GW * 32) global_sweep_kernel(
    const int* __restrict__ y, const int* __restrict__ ref, int h, int w,
    const int* __restrict__ shifts4, int sweep, int* __restrict__ zws,
    int* __restrict__ vol, float* __restrict__ sad_g, int* __restrict__ c0,
    int* __restrict__ g_full) {
  __shared__ int s_ref[GRH * GRS];
  __shared__ int s_part[GW][NR];
  __shared__ int s_last, s_win;
  auto* tot = reinterpret_cast<unsigned long long*>(zws + G_TOT);
  int* state = zws + G_STATE;
  const int rows = h >> 4, cols = w >> 4, nblk = rows * cols;
  const int tiles_c = (cols + GTC - 1) / GTC;
  const int tr = blockIdx.x / tiles_c, tc = blockIdx.x % tiles_c;
  const int t = threadIdx.x, lane = t & 31, wp = t >> 5;
  int b0, b1;
  if (sweep == 0) {
    b0 = blockIdx.y < 2 ? shifts4[2 * blockIdx.y] : 0;
    b1 = blockIdx.y < 2 ? shifts4[2 * blockIdx.y + 1] : 0;
  } else {
    b0 = state[1];
    b1 = state[2];
  }
  const int first = sweep == 0 ? blockIdx.y * NR : (sweep + 2) * NR;
  const int y0 = 16 * GTR * tr + b0 - RR, x0 = 16 * GTC * tc + b1 - RR;
  for (int k = t; k < GRH * GRW; k += GW * 32)
    copy4(&s_ref[(k / GRW) * GRS + k % GRW],
          &ref[(size_t)clampi(y0 + k / GRW, 0, h - 1) * w +
               clampi(x0 + k % GRW, 0, w - 1)]);
  copy_wait();
  const int R = GTR * tr + wp / GTC, C = GTC * tc + wp % GTC;
  const bool in = R < rows && C < cols;
  int src[8];
  if (in) load_src(y, w, R, C, src);
  __syncthreads();
  int sad = 0;
  if (in) {
    int acc[32] = {};
    sad25(s_ref + 16 * (wp / GTC) * GRS + 16 * (wp % GTC), GRS, src, acc);
    sad = reduce32(acc);
  }
  if (sweep > 0) {
    // a candidate clipped to +-34 takes the SAD of the unclipped one at
    // the same displacement: |base| <= 34, so it is one of the 25
    const int cy = clampi(b0 + lane / 5 - RR, -MAXMV, MAXMV) - b0 + RR;
    const int cx = clampi(b1 + lane % 5 - RR, -MAXMV, MAXMV) - b1 + RR;
    sad = __shfl_sync(FULL, sad, lane < NR ? 5 * cy + cx : lane);
  }
  if (lane < NR) {
    s_part[wp][lane] = sad;
    if (in) vol[(size_t)(first + lane) * nblk + R * cols + C] = sad;
  }
  __syncthreads();
  if (t < NR) {
    int s = 0;
#pragma unroll
    for (int i = 0; i < GW; ++i) s += s_part[i][t];
    atomicAdd(&tot[first + t], (unsigned long long)s);
  }
  // the last CTA to finish sees every total and every block SAD
  __threadfence();
  __syncthreads();
  if (t == 0)
    s_last = atomicAdd(reinterpret_cast<unsigned*>(zws + G_TICKET + sweep),
                       1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (wp == 0) {
    const int lo = sweep == 0 ? 0 : first, count = sweep == 0 ? 3 * NR : NR;
    float v = inf_f();
    int k = count;
    for (int c = lane; c < count; c += 32) {
      const float tv = total_f32(__ldcg(&tot[lo + c]));
      if (tv < v) { v = tv; k = c; }
    }
    warp_argmin(v, k);
    const float best = sweep == 0 ? inf_f() : __int_as_float(state[0]);
    if (lane == 0) {
      int win = state[3];
      if (v < best) {
        int d0, d1;
        if (sweep == 0) {
          sweep0_d(shifts4, k, d0, d1);
        } else {
          d0 = clampi(b0 + k / 5 - RR, -MAXMV, MAXMV);
          d1 = clampi(b1 + k % 5 - RR, -MAXMV, MAXMV);
        }
        win = lo + k;
        state[0] = __float_as_int(v);
        state[1] = d0;
        state[2] = d1;
        state[3] = win;
        if (sweep == 2) {
          g_full[0] = d0; g_full[1] = d1;
        }
      } else if (sweep == 2) {
        g_full[0] = state[1]; g_full[1] = state[2];
      }
      if (sweep == 2) {
        c0[0] = clampi(((g_full[0] + 2) >> 2) * 4, -4 * CR, 4 * CR);
        c0[1] = clampi(((g_full[1] + 2) >> 2) * 4, -4 * CR, 4 * CR);
      }
      s_win = win;
    }
  }
  if (sweep != 2) return;
  __syncthreads();
  const int* v = vol + (size_t)s_win * nblk;
#pragma unroll 8
  for (int b = t; b < nblk; b += GW * 32) sad_g[b] = (float)__ldcg(&v[b]);
}

// ---- C. refine_subpel ------------------------------------------------------

constexpr int RW = 4;             // blocks (warps) per CTA
constexpr int WS = 22;            // a 20x20 window's row stride, and
constexpr int PS = 26;            // the 24x24 patch's: rows 8 apart fall
                                  // on other banks
constexpr int WWORDS = 3 * 20 * WS;   // a warp's shared words: three
                                      // windows, later the patch

// The 24x24 patch at the block's MV (row r <-> 16R + mv + r - 4), clamped
// at the frame, into p (row stride PS) by the warp.
__device__ __forceinline__ void load_patch(const int* __restrict__ ref, int h,
                                           int w, int R, int C, int m0,
                                           int m1, int* p) {
  for (int k = threadIdx.x & 31; k < 576; k += 32)
    copy4(&p[(k / 24) * PS + k % 24],
          &ref[(size_t)clampi(16 * R + m0 - 4 + k / 24, 0, h - 1) * w +
               clampi(16 * C + m1 - 4 + k % 24, 0, w - 1)]);
  copy_wait();
  __syncwarp();
}

// acc[k] of candidate k: acc[k] in a for k < 32, b[k - 32] after
__device__ __forceinline__ int& acc49(int (&a)[32], int (&b)[32], int k) {
  return k < 32 ? a[k < 32 ? k : 0] : b[k < 32 ? 0 : k - 32];
}

// tap m (of taps 1..6) of the offset d's filter row, d != 0 picking its
// phase, d == 0 the identity
__device__ __forceinline__ int tap(const Phases& ph, int d, int m) {
  const int f = ((d & 7) >> 1) - 1;
  return d == 0 ? (m == 2 ? 128 : 0)
                : f == 0 ? ph.f[0][m] : f == 1 ? ph.f[1][m] : ph.f[2][m];
}

// This lane's abs-diffs of the 49 quarter-pel candidates (dy, dx) =
// (kSubD[k / 7], kSubD[k % 7]), from the 24x24 patch p.
//
// The horizontal pass of offset d reads patch columns c + 2 + (d >> 3) + m
// with taps 1..6 (m = 0..5) of its phase row (d & 7) << 1.  Offsets -6 and
// 2 share phase 4, one column apart (likewise -4/4 on phase 8, -2/6 on
// phase 12), and 0 is the identity: so this lane computes column j of the
// identity and columns j (negative offset) and j + 1 (positive) of each
// phase, as hw[x], x = 0 the identity, 2p + 1 and 2p + 2 phase p.  The
// vertical pass likewise: row u of phase p serves output row u of the
// negative offset and u - 1 of the positive one, and the lane walks the 14
// horizontal-pass rows 8 half + 1 .. 8 half + 14 with a window of the last
// 6 in registers, adding each vertical output's abs-diff to every
// candidate that reads it.
__device__ __forceinline__ void subpel49(const int* p, const Phases& ph,
                                         int pix_max, const int (&src)[8],
                                         int (&a)[32], int (&b)[32]) {
  const int* q0 = p + (lane_row0() + 1) * PS + lane_col() + 1;
  int hw[7][14];
#pragma unroll
  for (int t = 0; t < 14; ++t) {
    int q[7];
#pragma unroll
    for (int m = 0; m < 7; ++m) q[m] = q0[t * PS + m];
    hw[0][t] = (128 * q[3] + 4) >> 3;                   // InterRound0
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      int s0 = 0, s1 = 0;
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        s0 += ph.f[f][m] * q[m];
        s1 += ph.f[f][m] * q[m + 1];
      }
      hw[2 * f + 1][t] = (s0 + 4) >> 3;
      hw[2 * f + 2][t] = (s1 + 4) >> 3;
    }
#pragma unroll
    for (int x = 0; x < 7; ++x) {
      const int xi = x == 0 ? 3 : x & 1 ? (x - 1) / 2 : (x - 2) / 2 + 4;
      if (t >= 3 && t <= 10) {        // the vertical identity, row t - 3
        const int v = clampi((128 * hw[x][t] + 1024) >> 11, 0, pix_max);
        int& r = acc49(a, b, 3 * 7 + xi);
        r = sad_acc(src[t - 3], v, r);
      }
      if (t >= 5) {                   // vertical phase rows u = t - 5
        const int u = t - 5;
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          int s = 0;
#pragma unroll
          for (int m = 0; m < 6; ++m) s += ph.f[f][m] * hw[x][u + m];
          const int v = clampi((s + 1024) >> 11, 0, pix_max);  // InterRound1
          if (u <= 7) {
            int& r = acc49(a, b, f * 7 + xi);
            r = sad_acc(src[u], v, r);
          }
          if (u >= 1) {
            int& r = acc49(a, b, (f + 4) * 7 + xi);
            r = sad_acc(src[u - 1], v, r);
          }
        }
      }
    }
  }
}

// This lane's 8 predicted pixels of quarter-pel candidate k (uniform in
// the warp), from the 24x24 patch p, with the same arithmetic.
__device__ __forceinline__ void pred_at(const int* p, const Phases& ph,
                                        int pix_max, int k, int (&out)[8]) {
  const int dy = kSubD[k / 7], dx = kSubD[k % 7];
  int fx[6], fy[6];
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    fx[m] = tap(ph, dx, m);
    fy[m] = tap(ph, dy, m);
  }
  // horizontal-pass rows 8 half + 2 + (dy >> 3) + t, t = 0..12
  const int* q0 = p + (lane_row0() + 2 + (dy >> 3)) * PS + lane_col() + 2 +
                  (dx >> 3);
  int hc[13];
#pragma unroll
  for (int t = 0; t < 13; ++t) {
    int s = 0;
#pragma unroll
    for (int m = 0; m < 6; ++m) s += fx[m] * q0[t * PS + m];
    hc[t] = (s + 4) >> 3;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int s = 0;
#pragma unroll
    for (int m = 0; m < 6; ++m) s += fy[m] * hc[i + m];
    out[i] = clampi((s + 1024) >> 11, 0, pix_max);
  }
}

__device__ __forceinline__ float subpel_cost(int k, int sad, float unit_s) {
  const int n = 2 * (kSubD[k / 7] != 0) + 2 * (kSubD[k % 7] != 0);
  return __fadd_rn((float)sad, __fmul_rn(unit_s, (float)n));
}

// out (int32 words, per block b): mv8 [2b], mv_px [2 nblk + 2b], coarse_f
// [4 nblk + 2b], off_f [6 nblk + 2b], the sweep's best index [8 nblk + b]
// and best SAD (float bits) [9 nblk + b]; vol: the 49 SADs, [k nblk + b].
// One warp per 16x16 block, RW blocks per CTA; at most 128 registers a
// thread, so that 16 warps share an SM.
__global__ void __launch_bounds__(RW * 32, 4) refine_kernel(
    const int* __restrict__ y, const int* __restrict__ ref, int h, int w,
    const int* __restrict__ base0, const int* __restrict__ base1,
    const int* __restrict__ base2, const int* __restrict__ c0,
    const int* __restrict__ g_full, const float* __restrict__ sad_g,
    float unit_r, float unit_s, float m14, int pix_max, Phases ph,
    unsigned long long* __restrict__ tot, int* __restrict__ vol,
    int* __restrict__ out, int* __restrict__ pred) {
  __shared__ int s_win[RW][WWORDS];
  __shared__ int s_sad[RW][NSUB];
  const int cols = w >> 4, nblk = (h >> 4) * cols;
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int blk = blockIdx.x * RW + wp;
  if (blk < nblk) {
    const int R = blk / cols, C = blk % cols;
    int* win = s_win[wp];
    const int nb = base2 ? 3 : 2;
    int b0[3], b1[3];
#pragma unroll
    for (int bi = 0; bi < 3; ++bi) {
      if (bi >= nb) break;
      const int* bp = bi == 0 ? base0 : bi == 1 ? base1 : base2;
      b0[bi] = bp[2 * blk];
      b1[bi] = bp[2 * blk + 1];
      for (int k = lane; k < 400; k += 32)
        copy4(&win[bi * 20 * WS + (k / 20) * WS + k % 20],
              &ref[(size_t)clampi(16 * R + b0[bi] - RR + k / 20, 0, h - 1) * w
                   + clampi(16 * C + b1[bi] - RR + k % 20, 0, w - 1)]);
    }
    copy_wait();
    int src[8];
    load_src(y, w, R, C, src);
    __syncwarp();

    // the +-2 refine around each base: a parallel argmin per base, the
    // bases in order on a strict <
    float bc = inf_f();
    int bsad = 0, bm0 = 0, bm1 = 0, bf0 = 0, bf1 = 0;
#pragma unroll
    for (int bi = 0; bi < 3; ++bi) {
      if (bi >= nb) break;
      int acc[32] = {};
      sad25(win + bi * 20 * WS, WS, src, acc);
      const int sad = reduce32(acc);
      const int n = abs(lane / 5 - RR) + abs(lane % 5 - RR);   // |dy|+|dx|
      float c = lane < NR
                    ? __fadd_rn((float)sad, __fmul_rn(unit_r, (float)n))
                    : inf_f();
      int k = lane;
      warp_argmin(c, k);
      const int sd = __shfl_sync(FULL, sad, k);
      if (bi == 0 || c < bc) {
        bc = c; bsad = sd;
        bm0 = b0[bi] + k / 5 - RR; bm1 = b1[bi] + k % 5 - RR;
        bf0 = b0[bi]; bf1 = b1[bi];
      }
    }
    // the snap to the global shift
    const bool snap = sad_g[blk] <= __fadd_rn((float)bsad, m14);
    const int m0 = snap ? g_full[0] : bm0, m1 = snap ? g_full[1] : bm1;
    const int f0 = snap ? c0[0] : bf0, f1 = snap ? c0[1] : bf1;
    if (lane == 0) {
      out[2 * nblk + 2 * blk] = m0; out[2 * nblk + 2 * blk + 1] = m1;
      out[4 * nblk + 2 * blk] = f0; out[4 * nblk + 2 * blk + 1] = f1;
      out[6 * nblk + 2 * blk] = m0 - f0; out[6 * nblk + 2 * blk + 1] = m1 - f1;
    }

    // the quarter-pel sweep at the full-pel winner
    __syncwarp();
    load_patch(ref, h, w, R, C, m0, m1, win);
    int sa[32] = {}, sb[32] = {};
    subpel49(win, ph, pix_max, src, sa, sb);
    const int sad_a = reduce32(sa), sad_b = reduce32(sb);
    float c = subpel_cost(lane, sad_a, unit_s);
    int k = lane;
    if (lane + 32 < NSUB) {
      const float cb = subpel_cost(lane + 32, sad_b, unit_s);
      if (cb < c) { c = cb; k = lane + 32; }
    }
    warp_argmin(c, k);
    const int sd_a = __shfl_sync(FULL, sad_a, k & 31);
    const int sd_b = __shfl_sync(FULL, sad_b, k & 31);
    vol[(size_t)lane * nblk + blk] = sad_a;
    s_sad[wp][lane] = sad_a;
    if (lane + 32 < NSUB) {
      vol[(size_t)(lane + 32) * nblk + blk] = sad_b;
      s_sad[wp][lane + 32] = sad_b;
    }
    if (lane == 0) {
      out[8 * nblk + blk] = k;
      out[9 * nblk + blk] = __float_as_int((float)(k < 32 ? sd_a : sd_b));
    }
    int pv[8];
    pred_at(win, ph, pix_max, k, pv);
    int* o = pred + (size_t)blk * 256 + lane_row0() * 16 + lane_col();
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i * 16] = pv[i];
  } else {
    for (int k = lane; k < NSUB; k += 32) s_sad[wp][k] = 0;
  }
  __syncthreads();
  if (threadIdx.x < NSUB) {
    int s = 0;
#pragma unroll
    for (int i = 0; i < RW; ++i) s += s_sad[i][threadIdx.x];
    atomicAdd(&tot[threadIdx.x], (unsigned long long)s);
  }
}

// The snap to the dominant sub-pel offset (the argmin of the 49 totals,
// read by every warp), and mv8 = mv_px * 8 + the chosen offset; a block
// whose offset the snap changes gets the prediction at it.
__global__ void __launch_bounds__(RW * 32) subpel_snap_kernel(
    const int* __restrict__ ref, int h, int w,
    const unsigned long long* __restrict__ tot, const int* __restrict__ vol,
    float m14, int pix_max, Phases ph, int* __restrict__ out,
    int* __restrict__ pred) {
  __shared__ int s_p[RW][24 * PS];
  const int cols = w >> 4, nblk = (h >> 4) * cols;
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int blk = blockIdx.x * RW + wp;
  if (blk >= nblk) return;
  float v = total_f32(tot[lane]);
  int gi = lane;
  if (lane + 32 < NSUB) {
    const float vb = total_f32(tot[lane + 32]);
    if (vb < v) { v = vb; gi = lane + 32; }
  }
  warp_argmin(v, gi);
  const int bk = out[8 * nblk + blk];
  const bool snap = (float)vol[(size_t)gi * nblk + blk] <=
                    __fadd_rn(__int_as_float(out[9 * nblk + blk]), m14);
  const int k = snap ? gi : bk;
  const int m0 = out[2 * nblk + 2 * blk], m1 = out[2 * nblk + 2 * blk + 1];
  if (lane == 0) {
    out[2 * blk] = m0 * 8 + kSubD[k / 7];
    out[2 * blk + 1] = m1 * 8 + kSubD[k % 7];
  }
  if (k == bk) return;
  load_patch(ref, h, w, blk / cols, blk % cols, m0, m1, s_p[wp]);
  int pv[8];
  pred_at(s_p[wp], ph, pix_max, k, pv);
  int* o = pred + (size_t)blk * 256 + lane_row0() * 16 + lane_col();
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i * 16] = pv[i];
}

// workspace layouts, in int32 words (64-bit totals first)
struct CoarseWs {
  size_t tot, src_q, ref_q, win, words;
  __host__ __device__ CoarseWs(int h, int w) {
    const size_t nq = (size_t)(h >> 2) * (w >> 2);
    const size_t nblk = (size_t)(h >> 4) * (w >> 4);
    tot = 0;
    src_q = 2 * NC;
    ref_q = src_q + nq;
    win = (ref_q + nq + 3) & ~(size_t)3;   // int4 aligned
    words = win + 4 * nblk;
  }
};

}  // namespace

extern "C" int av1_motion_ws_words(int kind, int h, int w) {
  if (kind == 0) return (int)CoarseWs(h, w).words;
  if (kind == 1) return G_ZERO_WORDS;
  return 0;
}

// ws: CoarseWs(h, w).words int32 words (16-byte aligned); coarse, coarse2:
// (rows, cols, 2); shifts4: (4, 2).  bias: 2 x 17 floats (host).
extern "C" int av1_coarse_search(const int* y, const int* ref, int h, int w,
                                 const float* bias, float margin, int* ws,
                                 int* coarse, int* coarse2, int* shifts4,
                                 cudaStream_t stream) {
  const CoarseWs L(h, w);
  Bias b;
  for (int k = 0; k < ND; ++k) { b.vec[k] = bias[k]; b.sca[k] = bias[ND + k]; }
  auto* tot = reinterpret_cast<unsigned long long*>(ws + L.tot);
  auto* win = reinterpret_cast<int4*>(ws + L.win);
  const int hq = h >> 2, wq = w >> 2, rows = h >> 4, cols = w >> 4;
  const int tiles = (rows + CTR - 1) / CTR * ((cols + CTC - 1) / CTC);
  coarse_pool_kernel<<<(max(2 * hq * wq, NC) + NT - 1) / NT, NT, 0, stream>>>(
      y, ref, h, w, ws + L.src_q, ws + L.ref_q, tot);
  coarse_sweep_kernel<<<tiles, CWARPS * 32, 0, stream>>>(
      ws + L.src_q, ws + L.ref_q, hq, wq, b, tot, win);
  coarse_select_kernel<<<(rows * cols + NT - 1) / NT, NT, 0, stream>>>(
      tot, ws + L.src_q, ws + L.ref_q, hq, wq, win, margin, coarse, coarse2,
      shifts4);
  return (int)cudaGetLastError();
}

// coarse_search's launch layout at h x w, for kernels/motion.py:
// coarse_layout to check its mirror against: out = {pool CTAs, sweep CTAs,
// select CTAs, the sweep's threads per CTA and static shared bytes
// (cudaFuncGetAttributes)}.
extern "C" int av1_coarse_layout(int h, int w, int* out) {
  const int hq = h >> 2, wq = w >> 2, rows = h >> 4, cols = w >> 4;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, coarse_sweep_kernel);
  out[0] = (max(2 * hq * wq, NC) + NT - 1) / NT;
  out[1] = (rows + CTR - 1) / CTR * ((cols + CTC - 1) / CTC);
  out[2] = (rows * cols + NT - 1) / NT;
  out[3] = CWARPS * 32;
  out[4] = (int)a.sharedSizeBytes;
  return (int)e;
}

// zws: G_ZERO_WORDS zeroed int32 words; vol: 125 x nblk int32; sad_g:
// (rows, cols) float; c0, g_full: (2,) int32.
extern "C" int av1_global_search(const int* y, const int* ref, int h, int w,
                                 const int* shifts4, int* zws, int* vol,
                                 float* sad_g, int* c0, int* g_full,
                                 cudaStream_t stream) {
  const int tiles = ((h >> 4) + GTR - 1) / GTR * (((w >> 4) + GTC - 1) / GTC);
  for (int s = 0; s < 3; ++s)
    global_sweep_kernel<<<dim3(tiles, s == 0 ? 3 : 1), GW * 32, 0, stream>>>(
        y, ref, h, w, shifts4, s, zws, vol, sad_g, c0, g_full);
  return (int)cudaGetLastError();
}

// bases: base0, base1 and optional base2, (rows, cols, 2); tot: 49 zeroed
// 64-bit totals; vol: 49 x nblk int32; out: 10 x nblk int32 words
// (refine_kernel's layout); pred: (rows, cols, 16, 16).  taps: the 7 x 8
// bank rows of the offsets -6..6 (host), whose shape kernels/motion.py has
// checked: rows 0..2 give the phases.
extern "C" int av1_refine_subpel(const int* y, const int* ref, int h, int w,
                                 const int* base0, const int* base1,
                                 const int* base2, const int* c0,
                                 const int* g_full, const float* sad_g,
                                 float unit_r, float unit_s, float m14,
                                 int pix_max, const int* taps,
                                 unsigned long long* tot, int* vol, int* out,
                                 int* pred, cudaStream_t stream) {
  Phases ph;
  for (int f = 0; f < 3; ++f)
    for (int m = 0; m < 6; ++m) ph.f[f][m] = taps[8 * f + 1 + m];
  const int nblk = (h >> 4) * (w >> 4), grid = (nblk + RW - 1) / RW;
  refine_kernel<<<grid, RW * 32, 0, stream>>>(
      y, ref, h, w, base0, base1, base2, c0, g_full, sad_g, unit_r, unit_s,
      m14, pix_max, ph, tot, vol, out, pred);
  subpel_snap_kernel<<<grid, RW * 32, 0, stream>>>(ref, h, w, tot, vol, m14,
                                                   pix_max, ph, out, pred);
  return (int)cudaGetLastError();
}
