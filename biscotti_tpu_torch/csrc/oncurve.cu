// On-curve validation of affine Edwards25519 cells on Hopper (sm_90a): the
// hand-written counterpart of the TPU kernel
// biscotti_tpu/crypto/kernels/pallas_validate.py::_kernel (wrapper
// oncurve_mask).
//
// For each cell i of xy[n, 2, 16] (int64, the radix-2^16 limbs of x and y,
// little-endian, each limb in [0, 2^17), which the kernel checks) it writes
//   out[i] = (y^2 - x^2 - 1 - d x^2 y^2 == 0 mod p),   p = 2^255 - 19,
// the curve equation mod p only: canonicity (x, y < p) is the caller's own
// check. Coordinates may be non-canonical (x + p, all limbs 0xFFFF) and are
// reduced mod p. The mask is a verdict a consensus depends on, so it is
// exact: every intermediate is an exact integer, no step can overflow, and
// nothing is approximated.
//
// Bound. Each cell is read once (32 limbs x 8 B = 256 B) and its verdict
// written once (1 B): 128.6 MB at the VSS fold's n = 502,400 cells, 0.038 ms
// at the H100 SXM's 3.35 TB/s. The arithmetic is four field products of
// 16 x 16 limb multiplies (4 x 256 per cell, fewer where the squares share
// symmetric products) plus the folds, carries, the residual test and the
// limb-range check. chip_smoke.py::oncurve_bound counts them per pipe from
// this kernel's own SASS mix: the multiply-adds, each 64-bit-result
// IMAD.WIDE taking two passes, put about 1,920 lane-passes a cell on the
// FMA pipe, more than the ALU pipe's adds, logic and shifts or the issue
// slots take. At 64 lanes a clock per SM that is 0.058 ms at n = 502,400:
// the operations, not the bytes, bound the kernel.
//
// Design. The TPU kernel works on 128-cell tiles in VMEM with the field
// multiply as an int64 matmul against a [256, 31] 0/1 routing matrix (Pallas
// cannot close over constants, so the matrix, 8p and d ride in as inputs)
// and carry-save passes shaped for the vector unit. None of that carries
// over. Here one thread owns one cell and keeps everything in registers:
//   * x and y are loaded as 16-byte vectors and narrowed to 32-bit limbs;
//   * a field product is a schoolbook 16 x 16 product into 31 64-bit
//     accumulators (inputs < 2^19 keep each product < 2^38 and each
//     diagonal sum < 2^42), the 2^256 = 38 (mod p) fold of the top 15
//     diagonals (< 2^48), and two sequential carry passes, which leave every
//     limb loose (< 2^17);
//   * instead of the reference's two canonical forms, one residual
//     r = y^2 + 16p - x^2 - 1 - d x^2 y^2 is formed limb-wise (16p as
//     non-normalized limbs >= 2^19 - 304 keeps every limb non-negative),
//     carried with the fold until it is a normalized W < 2^256, and tested
//     for W in {0, p, 2p}, the only multiples of p below 2^256 = 2p + 38.
// p, 2p, 16p and d are __constant__ tables indexed only by unrolled loop
// counters. A block is 128 threads; the last block masks its tail, so the
// input needs no padding.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kLimbs = 16;
constexpr int kThreads = 128;

// p = 2^255 - 19
__constant__ uint32_t kP[kLimbs] = {
    0xFFED, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF,
    0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0x7FFF};
// 2p = 2^256 - 38
__constant__ uint32_t k2P[kLimbs] = {
    0xFFDA, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF,
    0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF};
// 16p = 8 (2^256 - 38) as non-normalized limbs, each >= 2^19 - 304
__constant__ uint32_t k16P[kLimbs] = {
    8 * 0xFFDA, 8 * 0xFFFF, 8 * 0xFFFF, 8 * 0xFFFF, 8 * 0xFFFF, 8 * 0xFFFF,
    8 * 0xFFFF, 8 * 0xFFFF, 8 * 0xFFFF, 8 * 0xFFFF, 8 * 0xFFFF, 8 * 0xFFFF,
    8 * 0xFFFF, 8 * 0xFFFF, 8 * 0xFFFF, 8 * 0xFFFF};
// d = -121665 / 121666 mod p
__constant__ uint32_t kD[kLimbs] = {
    0x78A3, 0x1359, 0x4DCA, 0x75EB, 0xD8AB, 0x4141, 0x0A4D, 0x0070,
    0xE898, 0x7779, 0x4079, 0x8CC7, 0xFE73, 0x2B6F, 0x6CEE, 0x5203};

// r = a * b mod p, loose. a, b limbs < 2^19; r limbs < 2^17 (limb 0 below
// 2^16 + 38, the others below 2^16).
__device__ __forceinline__ void fe_mul(const uint32_t (&a)[kLimbs],
                                       const uint32_t (&b)[kLimbs],
                                       uint32_t (&r)[kLimbs]) {
  uint64_t acc[2 * kLimbs - 1];
#pragma unroll
  for (int k = 0; k < 2 * kLimbs - 1; ++k) acc[k] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) acc[i + j] += (uint64_t)a[i] * b[j];
  }
  // 2^256 = 38 (mod p): diagonal k + 16 folds onto diagonal k
#pragma unroll
  for (int k = 0; k < kLimbs - 1; ++k) acc[k] += 38ull * acc[k + kLimbs];
  // pass 1: limbs < 2^48 in, carry out of the top < 2^27
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) {
    const uint64_t t = acc[k] + c;
    r[k] = (uint32_t)t & 0xFFFFu;
    c = t >> 16;
  }
  // pass 2 with the carry folded in: the value is below 2^256 + 2^33, so
  // the carry out of the top is 0 or 1, and folding it leaves limb 0 loose
  c *= 38ull;
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) {
    const uint64_t t = (uint64_t)r[k] + c;
    r[k] = (uint32_t)t & 0xFFFFu;
    c = t >> 16;
  }
  r[0] += 38u * (uint32_t)c;
}

__global__ void __launch_bounds__(kThreads)
oncurve_kernel(const int64_t* __restrict__ xy, uint8_t* __restrict__ out,
               int* __restrict__ bad, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;

  uint32_t x[kLimbs], y[kLimbs];
  uint64_t all = 0;  // the OR of the cell's 32 raw limbs
  const longlong2* cell = reinterpret_cast<const longlong2*>(xy + i * 2 * kLimbs);
#pragma unroll
  for (int k = 0; k < kLimbs / 2; ++k) {
    const longlong2 vx = __ldg(cell + k);
    const longlong2 vy = __ldg(cell + kLimbs / 2 + k);
    all |= (uint64_t)vx.x | (uint64_t)vx.y | (uint64_t)vy.x | (uint64_t)vy.y;
    x[2 * k] = (uint32_t)vx.x;
    x[2 * k + 1] = (uint32_t)vx.y;
    y[2 * k] = (uint32_t)vy.x;
    y[2 * k + 1] = (uint32_t)vy.y;
  }
  // a limb outside [0, 2^17) (a negative one has its top bit set) is out of
  // contract: its verdict would not be exact, so the caller is told (every
  // such thread stores the same 1)
  if (all >> 17) *bad = 1;

  uint32_t xx[kLimbs], yy[kLimbs], xxyy[kLimbs], dxxyy[kLimbs], d[kLimbs];
  fe_mul(x, x, xx);
  fe_mul(y, y, yy);
  fe_mul(xx, yy, xxyy);
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) d[k] = kD[k];
  fe_mul(d, xxyy, dxxyy);

  // residual yy + 16p - xx - dxxyy - 1: each subtrahend limb < 2^17 and
  // each 16p limb >= 2^19 - 304, so every limb is in [0, 2^20)
  uint32_t w[kLimbs];
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) w[k] = yy[k] + k16P[k] - xx[k] - dxxyy[k];
  w[0] -= 1u;

  // normalize to W < 2^256, W = residual (mod p). Pass 1 carries < 2^5 out
  // of the top; after its fold the value is below 2^256 + 2^11, so pass 2
  // carries out 0 or 1, and when it carries 1 what is left is below 2^11:
  // folding 38 onto limb 0 then leaves every limb under 2^16.
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    uint32_t c = 0;
#pragma unroll
    for (int k = 0; k < kLimbs; ++k) {
      const uint32_t t = w[k] + c;
      w[k] = t & 0xFFFFu;
      c = t >> 16;
    }
    w[0] += 38u * c;
  }

  // W = 0 (mod p) iff W is 0, p or 2p (3p > 2^256)
  uint32_t z = 0, dp = 0, d2p = 0;
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) {
    z |= w[k];
    dp |= w[k] ^ kP[k];
    d2p |= w[k] ^ k2P[k];
  }
  out[i] = (uint8_t)((z == 0) | (dp == 0) | (d2p == 0));
}

}  // namespace

extern "C" {

// The on-curve mask of xy[n, 2, 16] (int64 limbs in [0, 2^17), 16-byte
// aligned) into out[n] (0 or 1). Sets *bad (zeroed by the caller) to 1 if
// any limb lies outside [0, 2^17); the mask is then not exact. Launches on
// `stream` and does not synchronise. Returns the cudaError_t of the launch
// (0 on success).
int oncurve_mask_i64(const int64_t* xy, uint8_t* out, int* bad, long long n,
                     void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  oncurve_kernel<<<(unsigned)blocks, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(xy, out, bad, n);
  return (int)cudaGetLastError();
}

const char* oncurve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
