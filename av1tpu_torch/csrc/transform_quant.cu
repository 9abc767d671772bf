// Fused forward transform + deadzone quantize + dequantize for Hopper.
//
// Replaces the Pallas TPU kernel av1tpu/kernels/transform_quant.py:_tq_kernel
// (pl.pallas_call at :64).  Per residual row r and coefficient column c:
//
//   coef = resid[r, :] @ fwdt[:, c]                         (fp32 FMAs)
//   lv   = clip(sign(coef) * floor(|coef| / step[c] + off), -cap[c], cap[c])
//   dq   = lv * q[c]                       (lv stored as int16, dq as int32)
//
// and keeps the coefficients in registers, as the TPU kernel kept them in
// VMEM.
//
// What bounds it on an H100.  The work at the main path's shapes is tiny:
// (B, N2) = (120, 256), a 1080p luma block row, is 2*B*N2^2 = 15.7 MFLOP,
// 0.23 us at the 67 TFLOP/s fp32 peak; (1, 256), one block of the first
// row's column scan, moves 268 KB (mostly fwdt), 0.08 us at 3.35 TB/s;
// (240, 64) and (2, 64), the U and V chroma planes together, 0.05 and
// 0.006 us.  Every bound is far below the fixed cost of one launch (a few
// us), so no launch at these shapes comes near its bound.  The design
// therefore minimises the serial steps inside a launch:
//
// - Blocks that fill the card.  One block per (row tile, 32-column strip),
//   one warp per 32-deep K slice: N2 / 32 warps.  A block takes 8 rows at
//   N2 = 256, so (120, 256) makes 120 blocks, about one per SM, and 2 rows
//   at N2 = 64, so (240, 64) makes 240 small blocks (measured faster than
//   120 blocks of 4 rows); at B <= 2 it takes exactly the B rows, so no
//   warp computes a row that does not exist.
// - One wait.  fwdt arrives cut into 32-column strips, each contiguous
//   (kernels/transform_quant.py:TQPlane), so one thread issues two bulk
//   copies (TMA, cp.async.bulk): the block's whole fwdt strip (N2 x 32
//   floats, 32 KB at N2 = 256) and its resid rows, both completing on one
//   mbarrier.  The quantizer rows load into registers meanwhile.
// - fp32 FMAs on the CUDA cores, not the tensor cores: at 15.7 MFLOP over
//   120 SMs the product takes well under a microsecond, so the tensor cores
//   would buy no latency, and TF32 would flip levels.  Lane j owns column j
//   of the strip and keeps one sum per row in registers, so each fwdt value
//   read from shared memory feeds every row of the tile (a first design with
//   one output per thread was bound by shared-memory reads: two per FMA);
//   the resid values are float4 broadcasts.  Each warp leaves its partial
//   sums in its own slice of the strip, which no other warp reads; after
//   one barrier each output sums the slices in a fixed order and the
//   quantize tail runs in registers with IEEE division (nvcc's default
//   -prec-div=true), the same two roundings as the plain version's
//   |coef| / step + off.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STRIP = 32;  // coefficient columns per block: one per lane
constexpr int KS = 32;     // K depth per warp

size_t smem_bytes(int n2, int tm) {
  // mbarrier (padded to 16), fwdt strip, resid rows
  return 16 + sizeof(float) * ((size_t)n2 * STRIP + (size_t)tm * n2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
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
      "}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// TM rows x 32 columns per block; blockDim = n2 (one warp per K slice).
template <int TM>
__global__ void __launch_bounds__(256)
tq_kernel(const float* __restrict__ resid, const float* __restrict__ strips,
          const float* __restrict__ step, const int32_t* __restrict__ q,
          const int32_t* __restrict__ cap, int16_t* __restrict__ lv_out,
          int32_t* __restrict__ dq_out, int b, int n2, float off_dc,
          float off_ac) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem + 16);  // [n2][STRIP] fwdt strip
  float* as = ws + n2 * STRIP;                      // [TM][n2] resid rows
  const uint32_t bar = smem_addr(smem);

  const int lane = threadIdx.x & 31, s = threadIdx.x >> 5;
  const int row0 = blockIdx.y * TM;
  const int rows = min(TM, b - row0);
  const int col = blockIdx.x * STRIP + lane;

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t wbytes = n2 * STRIP * sizeof(float);
    const uint32_t abytes = rows * n2 * sizeof(float);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(wbytes + abytes) : "memory");
    bulk_load(ws, strips + (size_t)blockIdx.x * n2 * STRIP, wbytes, bar);
    bulk_load(as, resid + (size_t)row0 * n2, abytes, bar);
  }
  // every output this thread quantizes below lies in column `col`
  const float stp = step[col];
  const int32_t qc = q[col], cp = cap[col];
  mbar_wait(bar, 0);

  // this warp's K slice for all TM rows (rows past b compute on stale
  // shared memory and are never stored)
  float* w = ws + s * KS * STRIP + lane;
  const float* a = as + s * KS;
  float acc[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) acc[r] = 0.0f;
#pragma unroll
  for (int k = 0; k < KS; k += 4) {
    const float w0 = w[k * STRIP], w1 = w[(k + 1) * STRIP];
    const float w2 = w[(k + 2) * STRIP], w3 = w[(k + 3) * STRIP];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(a + r * n2 + k);
      acc[r] = fmaf(x.x, w0, acc[r]);
      acc[r] = fmaf(x.y, w1, acc[r]);
      acc[r] = fmaf(x.z, w2, acc[r]);
      acc[r] = fmaf(x.w, w3, acc[r]);
    }
  }
  // partial sums into this lane's own column of the slice's first rows:
  // only this thread ever reads or writes those words before the barrier
#pragma unroll
  for (int r = 0; r < TM; ++r) w[r * STRIP] = acc[r];
  __syncthreads();

  const int ks = n2 / KS;
  for (int o = threadIdx.x; o < rows * STRIP; o += blockDim.x) {
    const float* p = ws + (o / STRIP) * STRIP + lane;
    float c = p[0];
    for (int j = 1; j < ks; ++j) c += p[j * KS * STRIP];
    const float mag = floorf(fabsf(c) / stp + (col == 0 ? off_dc : off_ac));
    const int sgn = (c > 0.0f) - (c < 0.0f);
    int lv = sgn * (int)mag;
    lv = lv < -cp ? -cp : (lv > cp ? cp : lv);
    const size_t at = (size_t)(row0 + o / STRIP) * n2 + col;
    lv_out[at] = (int16_t)lv;
    dq_out[at] = lv * qc;
  }
}

template <int TM>
int launch(const float* resid, const float* strips, const float* step,
           const int32_t* q, const int32_t* cap, int16_t* lv_out,
           int32_t* dq_out, int b, int n2, float off_dc, float off_ac,
           cudaStream_t stream) {
  const dim3 grid(n2 / STRIP, (b + TM - 1) / TM);
  tq_kernel<TM><<<grid, n2, smem_bytes(n2, TM), stream>>>(
      resid, strips, step, q, cap, lv_out, dq_out, b, n2, off_dc, off_ac);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry: launches on `stream` and returns cudaGetLastError() (0 = ok).
// resid (b, n2) f32; strips (n2 / 32, n2, 32) f32, fwdt cut into contiguous
// 32-column strips; step (n2,) f32; q, cap (n2,) i32; lv_out (b, n2) i16;
// dq_out (b, n2) i32.  All contiguous device memory; resid and strips
// 16-byte aligned (bulk copies).  n2 is 64 or 256.
extern "C" int av1_transform_quantize(const float* resid, const float* strips,
                                      const float* step, const int32_t* q,
                                      const int32_t* cap, int16_t* lv_out,
                                      int32_t* dq_out, int b, int n2,
                                      float off_dc, float off_ac,
                                      void* stream) {
  if (b <= 0 || (n2 != 64 && n2 != 256) ||
      reinterpret_cast<uintptr_t>(resid) % 16 ||
      reinterpret_cast<uintptr_t>(strips) % 16)
    return (int)cudaErrorInvalidValue;
  // rows per block: 8 at N2 = 256 (120 blocks at (120, 256)), 2 at N2 = 64
  // (240 blocks at (240, 64)), and the B rows themselves at B <= 2
  auto st = (cudaStream_t)stream;
  if (b == 1)
    return launch<1>(resid, strips, step, q, cap, lv_out, dq_out, b, n2,
                     off_dc, off_ac, st);
  if (b == 2 || n2 == 64)
    return launch<2>(resid, strips, step, q, cap, lv_out, dq_out, b, n2,
                     off_dc, off_ac, st);
  return launch<8>(resid, strips, step, q, cap, lv_out, dq_out, b, n2,
                   off_dc, off_ac, st);
}
