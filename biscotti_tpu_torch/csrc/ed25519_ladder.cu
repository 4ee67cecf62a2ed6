// The Edwards25519 ladders of the device crypto plane on Hopper (sm_90a):
// the hand-written counterparts of the four jitted XLA programs of
// biscotti_tpu/crypto/kernels/primitives.py (wrappers in
// crypto/kernels/cuda_ladder.py):
//
//   B3a msm_ladder_kernel   _build_msm (:116, the fori_loop at :128): each
//                           lane's MSB-first double-and-add of its point
//   B3b fixed_walk_kernel   _build_fixed (:134, the loop at :150): each
//                           lane's LSB-first walk over table[i] = 2^i base
//   B3c grid_points_kernel  _build_grid (:155): per cell, x < p, y < p and
//                           on the curve, and the extended point (x, y, 1, xy)
//   B3d point_add_kernel    _build_ext_add (:176): out[i] = a[i] + b[i], also
//                           each level of the tree sums (_build_msm's and
//                           _build_grid's gp.tree_sum)
//
// Contract: bit equality with the plain PyTorch versions (field.py,
// group.py), not only equality mod p. A field element is 16 radix-2^16
// limbs, and every operation is field.py's, carry for carry:
//   fmul  the 31 diagonal sums of the 16 x 16 limb products (their order is
//         free: they are exact integers), v = lo + 38 hi with hi[15] = 0,
//         then two carry-save passes;
//   fadd  a + b, one pass;   fsub  a + 8p - b (8p as field.py's
//         non-normalized EIGHT_P limbs), one pass;
//   pass  c = v >> 16 (arithmetic); v = (v & 0xFFFF) + rotate(c), limb 0
//         taking 38 c[15]: every limb at once, not a sequential chain.
// The group formulas are group.py's, operand order included. Limbs are
// SIGNED: a negated point's limbs reach 2^18 - 4, so fsub can leave a limb
// of -1, and fmul of such a value can carry a negative limb on; an
// arithmetic shift and a two's complement mask keep those cases exact, as
// torch's int64 ops do.
//
// Ranges. B3a, B3b and B3d take limbs in (-2^19, 2^19): canonical and loose
// limbs, point_neg_limbs' output (< 2^18 + 2^14) and the kernels' own
// outputs, which may hold small negative limbs. In that range a product is
// below 2^38, a diagonal sum below 2^42 and the fold below 2^48, so int64
// sums never overflow; every value stored between operations stays below
// 2^19 in magnitude, so registers hold limbs as int32 and widen them for
// the products (IMAD.WIDE). B3c takes wire limbs in [0, 2^16). Every kernel
// checks each limb it loads and sets *bad, and the wrapper raises.
//
// Bound. The work is limb products on the FMA pipe: a point add is 9 field
// products (2,304 limb products), a double 4 products and 4 squares (1,568;
// a square sums each off-diagonal product once, doubled). Each product is one
// IMAD.WIDE, two passes of the FMA pipe; the carries, folds and selects go
// to the ALU pipe. At the settle's 8,192 lanes B3a does 256 doubles and,
// for random scalars, ~128 adds a lane: about 8.7e9 FMA lane-passes, 0.5 ms
// at the H100 SXM's 132 SMs x 64 lanes x 1.98 GHz. chip_smoke.py counts the
// pipes from this library's own SASS (B3d's listing is one add; B3a's is one
// double and one add). The bytes are small (the points once in and out).
//
// Design. The TPU runs each program as XLA's fused vector loops over every
// lane at once, with the field product as an int64 matmul against a 0/1
// routing matrix. Here one thread owns one lane (B3a, B3b) or one cell or
// pair (B3c, B3d) and keeps its points in registers, with B2's schoolbook
// product into 31 int64 accumulators. A lane's step depends on the step
// before it, so a lane's ladder is one long dependent chain: B3a and B3b
// run one warp a block, which spreads 8,192 lanes (256 warps) over 128 SMs,
// two warps an SM, half of the SM's four schedulers; the registers (two
// points of 64 int32 limbs, the 31 accumulators) allow no more warps an SM
// in any case. A set bit is a branch (the reference computes both arms and
// keeps one; the result is the same). B3b's table row is the same for
// every lane at a step, a broadcast __ldg that L1 serves; every lane loads
// and checks every row, set bit or not. No atomics: two calls give the same
// bits. Making it fast (several threads a field product, a fused tree) is
// later work.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kLimbs = 16;
constexpr int kPointLimbs = 4 * kLimbs;
constexpr int kLaneThreads = 32;  // B3a, B3b: one warp a block
constexpr int kCellThreads = 64;  // B3c, B3d
constexpr int64_t kLoose = 1 << 19;  // B3a, B3b, B3d: limbs in (-2^19, 2^19)

// p = 2^255 - 19
__constant__ int32_t kP[kLimbs] = {
    0xFFED, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF,
    0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0x7FFF};
// field.py's EIGHT_P: 4 (2^256 - 38) limb-wise, non-normalized
__constant__ int32_t kEightP[kLimbs] = {
    4 * (0xFFFF - 37), 4 * 0xFFFF, 4 * 0xFFFF, 4 * 0xFFFF, 4 * 0xFFFF,
    4 * 0xFFFF, 4 * 0xFFFF, 4 * 0xFFFF, 4 * 0xFFFF, 4 * 0xFFFF, 4 * 0xFFFF,
    4 * 0xFFFF, 4 * 0xFFFF, 4 * 0xFFFF, 4 * 0xFFFF, 4 * 0xFFFF};
// d = -121665 / 121666 mod p
__constant__ int32_t kD[kLimbs] = {
    0x78A3, 0x1359, 0x4DCA, 0x75EB, 0xD8AB, 0x4141, 0x0A4D, 0x0070,
    0xE898, 0x7779, 0x4079, 0x8CC7, 0xFE73, 0x2B6F, 0x6CEE, 0x5203};
// 2d mod p
__constant__ int32_t kD2[kLimbs] = {
    0xF159, 0x26B2, 0x9B94, 0xEBD6, 0xB156, 0x8283, 0x149A, 0x00E0,
    0xD130, 0xEEF3, 0x80F2, 0x198E, 0xFCE7, 0x56DF, 0xD9DC, 0x2406};

typedef int32_t Fe[kLimbs];

// rows X, Y, Z, T of the extended coordinates
struct Point {
  Fe v[4];
};

// one carry-save pass over int64 limbs (the fold of field.py's carry)
__device__ __forceinline__ void carry64(int64_t (&x)[kLimbs]) {
  int64_t c[kLimbs];
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) c[k] = x[k] >> 16;
  x[0] = (x[0] & 0xFFFF) + 38 * c[kLimbs - 1];
#pragma unroll
  for (int k = 1; k < kLimbs; ++k) x[k] = (x[k] & 0xFFFF) + c[k - 1];
}

// the same pass over int32 limbs: after an add or subtract every limb is
// below 2^21 in magnitude, where it equals the int64 pass
__device__ __forceinline__ void carry32(Fe& x) {
  int32_t c[kLimbs];
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) c[k] = x[k] >> 16;
  x[0] = (x[0] & 0xFFFF) + 38 * c[kLimbs - 1];
#pragma unroll
  for (int k = 1; k < kLimbs; ++k) x[k] = (x[k] & 0xFFFF) + c[k - 1];
}

// fold the 31 diagonal sums (hi[15] = 0), two passes, narrow: field.fmul's
// tail. d[k] for k < 16 is lo[k], d[16 + k] is hi[k].
__device__ __forceinline__ void fold_carry(const int64_t (&d)[2 * kLimbs - 1],
                                           Fe& r) {
  int64_t x[kLimbs];
#pragma unroll
  for (int k = 0; k < kLimbs - 1; ++k) x[k] = d[k] + 38 * d[k + kLimbs];
  x[kLimbs - 1] = d[kLimbs - 1];
  carry64(x);
  carry64(x);
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) r[k] = (int32_t)x[k];
}

// r = a b (field.fmul); r may alias a or b
__device__ __forceinline__ void fe_mul(const Fe& a, const Fe& b, Fe& r) {
  int64_t d[2 * kLimbs - 1];
#pragma unroll
  for (int k = 0; k < 2 * kLimbs - 1; ++k) d[k] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) d[i + j] += (int64_t)a[i] * b[j];
  }
  fold_carry(d, r);
}

// r = a a: the same diagonal sums as fe_mul(a, a), each off-diagonal
// product taken once and doubled (2 a[j] < 2^20 in magnitude)
__device__ __forceinline__ void fe_sqr(const Fe& a, Fe& r) {
  int64_t d[2 * kLimbs - 1];
#pragma unroll
  for (int k = 0; k < 2 * kLimbs - 1; ++k) d[k] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    d[2 * i] += (int64_t)a[i] * a[i];
#pragma unroll
    for (int j = i + 1; j < kLimbs; ++j) d[i + j] += (int64_t)a[i] * (2 * a[j]);
  }
  fold_carry(d, r);
}

// r = a b with b one of the __constant__ tables (d or 2d), copied into
// registers first so that fe_mul reads it like any other element
__device__ __forceinline__ void fe_mul_table(const Fe& a,
                                             const int32_t (&table)[kLimbs],
                                             Fe& r) {
  Fe b;
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) b[k] = table[k];
  fe_mul(a, b, r);
}

__device__ __forceinline__ void fe_add(const Fe& a, const Fe& b, Fe& r) {
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) r[k] = a[k] + b[k];
  carry32(r);
}

__device__ __forceinline__ void fe_sub(const Fe& a, const Fe& b, Fe& r) {
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) r[k] = a[k] + kEightP[k] - b[k];
  carry32(r);
}

// group.point_add, formula for formula; r may alias p or q
__device__ __forceinline__ void point_add(const Point& p, const Point& q,
                                          Point& r) {
  Fe s1, s2, a, b;
  fe_sub(p.v[1], p.v[0], s1);
  fe_sub(q.v[1], q.v[0], s2);
  fe_mul(s1, s2, a);
  fe_add(p.v[1], p.v[0], s1);
  fe_add(q.v[1], q.v[0], s2);
  fe_mul(s1, s2, b);
  Fe e, h;
  fe_sub(b, a, e);
  fe_add(b, a, h);
  Fe c;
  fe_mul_table(p.v[3], kD2, s1);  // c = (t1 2d) t2
  fe_mul(s1, q.v[3], c);
  Fe dd;
  fe_mul(p.v[2], q.v[2], s1);  // zz
  fe_add(s1, s1, dd);
  Fe f, g;
  fe_sub(dd, c, f);
  fe_add(dd, c, g);
  fe_mul(e, f, r.v[0]);
  fe_mul(g, h, r.v[1]);
  fe_mul(f, g, r.v[2]);
  fe_mul(e, h, r.v[3]);
}

// group.point_double, formula for formula; r may alias p
__device__ __forceinline__ void point_double(const Point& p, Point& r) {
  Fe a, b, h, e, xy;
  fe_sqr(p.v[0], a);
  fe_sqr(p.v[1], b);
  fe_add(a, b, h);
  fe_add(p.v[0], p.v[1], xy);
  fe_sqr(xy, xy);
  fe_sub(h, xy, e);
  Fe g, c, f;
  fe_sub(a, b, g);
  fe_sqr(p.v[2], c);  // zz
  fe_add(c, c, c);
  fe_add(c, g, f);
  fe_mul(e, f, r.v[0]);
  fe_mul(g, h, r.v[1]);
  fe_mul(f, g, r.v[2]);
  fe_mul(e, h, r.v[3]);
}

__device__ __forceinline__ void set_identity(Point& p) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int k = 0; k < kLimbs; ++k) p.v[r][k] = 0;
  }
  p.v[1][0] = 1;
  p.v[2][0] = 1;
}

__device__ __forceinline__ bool loose(long long v) {
  return v > -kLoose && v < kLoose;
}

// load a [4, 16] int64 point (16-byte aligned); false if a limb lies
// outside (-2^19, 2^19)
__device__ __forceinline__ bool load_point(const int64_t* __restrict__ src,
                                           Point& p) {
  const longlong2* s = reinterpret_cast<const longlong2*>(src);
  bool ok = true;
#pragma unroll
  for (int k = 0; k < kPointLimbs / 2; ++k) {
    const longlong2 w = __ldg(s + k);
    ok &= loose(w.x) & loose(w.y);
    p.v[k / 8][(2 * k) % kLimbs] = (int32_t)w.x;
    p.v[k / 8][(2 * k) % kLimbs + 1] = (int32_t)w.y;
  }
  return ok;
}

__device__ __forceinline__ void store_point(int64_t* __restrict__ dst,
                                            const Point& p) {
  longlong2* d = reinterpret_cast<longlong2*>(dst);
#pragma unroll
  for (int k = 0; k < kPointLimbs / 2; ++k) {
    d[k] = make_longlong2(p.v[k / 8][(2 * k) % kLimbs],
                          p.v[k / 8][(2 * k) % kLimbs + 1]);
  }
}

// ------------------------------------------------------------------ B3a

__global__ void __launch_bounds__(kLaneThreads)
msm_ladder_kernel(const uint32_t* __restrict__ bits, int words,
                  const int64_t* __restrict__ pts, int64_t* __restrict__ out,
                  int* __restrict__ bad, long long m) {
  const long long i = (long long)blockIdx.x * kLaneThreads + threadIdx.x;
  if (i >= m) return;
  Point p, acc;
  if (!load_point(pts + i * kPointLimbs, p)) *bad = 1;
  set_identity(acc);
  const uint32_t* lane = bits + i * words;
#pragma unroll 1
  for (int w = 0; w < words; ++w) {
    const uint32_t word = __ldg(lane + w);
#pragma unroll 1
    for (int b = 0; b < 32; ++b) {
      point_double(acc, acc);
      if ((word >> b) & 1u) point_add(acc, p, acc);
    }
  }
  store_point(out + i * kPointLimbs, acc);
}

// ------------------------------------------------------------------ B3b

__global__ void __launch_bounds__(kLaneThreads)
fixed_walk_kernel(const uint32_t* __restrict__ bits, int words,
                  const int64_t* __restrict__ table, int64_t* __restrict__ out,
                  int* __restrict__ bad, long long m) {
  const long long i = (long long)blockIdx.x * kLaneThreads + threadIdx.x;
  if (i >= m) return;
  Point acc;
  set_identity(acc);
  bool ok = true;
  const uint32_t* lane = bits + i * words;
#pragma unroll 1
  for (int w = 0; w < words; ++w) {
    const uint32_t word = __ldg(lane + w);
#pragma unroll 1
    for (int b = 0; b < 32; ++b) {
      Point t;  // table[32 w + b]: one address for every lane of the warp
      ok &= load_point(table + (long long)(32 * w + b) * kPointLimbs, t);
      if ((word >> b) & 1u) point_add(acc, t, acc);
    }
  }
  if (!ok) *bad = 1;
  store_point(out + i * kPointLimbs, acc);
}

// ------------------------------------------------------------------ B3c

// field.canonical: four sequential carry passes with the fold, then two
// conditional subtractions of p
__device__ __forceinline__ void canonical(Fe& x) {
#pragma unroll
  for (int pass = 0; pass < 4; ++pass) {
    int32_t c = 0;
#pragma unroll
    for (int k = 0; k < kLimbs; ++k) {
      const int32_t v = x[k] + c;
      c = v >> 16;
      x[k] = v & 0xFFFF;
    }
    x[0] += 38 * c;
  }
#pragma unroll
  for (int rep = 0; rep < 2; ++rep) {
    Fe s;
    int32_t borrow = 0;
#pragma unroll
    for (int k = 0; k < kLimbs; ++k) {
      const int32_t v = x[k] - kP[k] - borrow;
      borrow = v < 0;
      s[k] = v + (borrow << 16);
    }
    if (!borrow) {
#pragma unroll
      for (int k = 0; k < kLimbs; ++k) x[k] = s[k];
    }
  }
}

// field.lt_p of carried limbs: x < p
__device__ __forceinline__ bool lt_p(const Fe& x) {
  bool lt = false, eq = true;
#pragma unroll
  for (int k = kLimbs - 1; k >= 0; --k) {
    lt |= eq & (x[k] < kP[k]);
    eq &= x[k] == kP[k];
  }
  return lt;
}

// group.on_curve: -x^2 + y^2 = 1 + d x^2 y^2, the canonical forms compared
__device__ __forceinline__ bool on_curve(const Fe& x, const Fe& y) {
  Fe xx, yy, lhs, t;
  fe_sqr(x, xx);
  fe_sqr(y, yy);
  fe_sub(yy, xx, lhs);
  fe_mul(xx, yy, t);
  fe_mul_table(t, kD, t);
  t[0] += 1;  // fadd(ONE, d xx yy)
  carry32(t);
  canonical(lhs);
  canonical(t);
  bool eq = true;
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) eq &= lhs[k] == t[k];
  return eq;
}

__global__ void __launch_bounds__(kCellThreads)
grid_points_kernel(const int64_t* __restrict__ xy, uint8_t* __restrict__ ok,
                   int64_t* __restrict__ pts, int* __restrict__ bad,
                   long long cells) {
  const long long i = (long long)blockIdx.x * kCellThreads + threadIdx.x;
  if (i >= cells) return;
  Point p;
  uint64_t all = 0;  // the OR of the cell's 32 raw limbs
  const longlong2* cell = reinterpret_cast<const longlong2*>(xy + i * 2 * kLimbs);
#pragma unroll
  for (int k = 0; k < kLimbs / 2; ++k) {
    const longlong2 vx = __ldg(cell + k);
    const longlong2 vy = __ldg(cell + kLimbs / 2 + k);
    all |= (uint64_t)vx.x | (uint64_t)vx.y | (uint64_t)vy.x | (uint64_t)vy.y;
    p.v[0][2 * k] = (int32_t)vx.x;
    p.v[0][2 * k + 1] = (int32_t)vx.y;
    p.v[1][2 * k] = (int32_t)vy.x;
    p.v[1][2 * k + 1] = (int32_t)vy.y;
  }
  // a wire limb outside [0, 2^16) (a negative one has its top bit set)
  if (all >> 16) *bad = 1;
  ok[i] = (uint8_t)(lt_p(p.v[0]) & lt_p(p.v[1]) & on_curve(p.v[0], p.v[1]));
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) p.v[2][k] = 0;
  p.v[2][0] = 1;
  fe_mul(p.v[0], p.v[1], p.v[3]);
  store_point(pts + i * kPointLimbs, p);
}

// ------------------------------------------------------------------ B3d

__global__ void __launch_bounds__(kCellThreads)
point_add_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                 int64_t* __restrict__ out, int* __restrict__ bad, long long n) {
  const long long i = (long long)blockIdx.x * kCellThreads + threadIdx.x;
  if (i >= n) return;
  Point p, q;
  const bool ok = load_point(a + i * kPointLimbs, p)
      & load_point(b + i * kPointLimbs, q);
  if (!ok) *bad = 1;
  point_add(p, q, p);
  store_point(out + i * kPointLimbs, p);
}

int blocks_for(long long n, int threads, unsigned* blocks) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long b = (n + threads - 1) / threads;
  if (b > INT_MAX) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)b;
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Every function launches on `stream`, does not synchronise, and returns the
// cudaError_t of the launch (0 on success). Points are [., 4, 16] int64 and
// every pointer is 16-byte aligned; bits are [m, words] uint32, bit b of
// word w being step 32 w + b. *bad (zeroed by the caller) is set to 1 if a
// limb lies outside the kernel's range; the result is then not exact.

// B3a: out[i] = the MSB-first double-and-add of pts[i] over its 32 words
// steps (bits[i]), from the identity.
int ed25519_msm_ladder(const uint32_t* bits, int words, const int64_t* pts,
                       int64_t* out, int* bad, long long m, void* stream) {
  unsigned blocks;
  const int rc = blocks_for(m, kLaneThreads, &blocks);
  if (rc != (int)cudaSuccess || words <= 0) return (int)cudaErrorInvalidValue;
  msm_ladder_kernel<<<blocks, kLaneThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(bits, words, pts,
                                                           out, bad, m);
  return (int)cudaGetLastError();
}

// B3b: out[i] = the sum of table[s] over the set steps s of bits[i]
// (table [32 words, 4, 16]), added in step order from the identity.
int ed25519_fixed_walk(const uint32_t* bits, int words, const int64_t* table,
                       int64_t* out, int* bad, long long m, void* stream) {
  unsigned blocks;
  const int rc = blocks_for(m, kLaneThreads, &blocks);
  if (rc != (int)cudaSuccess || words <= 0) return (int)cudaErrorInvalidValue;
  fixed_walk_kernel<<<blocks, kLaneThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(bits, words, table,
                                                           out, bad, m);
  return (int)cudaGetLastError();
}

// B3c: for each of `cells` affine cells xy[c, 2, 16] (wire limbs in
// [0, 2^16)), ok[c] = x < p & y < p & on the curve, and pts[c] =
// (x, y, 1, x y) as a [4, 16] point.
int ed25519_grid_points(const int64_t* xy, uint8_t* ok, int64_t* pts, int* bad,
                        long long cells, void* stream) {
  unsigned blocks;
  const int rc = blocks_for(cells, kCellThreads, &blocks);
  if (rc != (int)cudaSuccess) return rc;
  grid_points_kernel<<<blocks, kCellThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(xy, ok, pts, bad,
                                                            cells);
  return (int)cudaGetLastError();
}

// B3d: out[i] = a[i] + b[i] for n points (out overlaps neither input).
int ed25519_point_add(const int64_t* a, const int64_t* b, int64_t* out,
                      int* bad, long long n, void* stream) {
  unsigned blocks;
  const int rc = blocks_for(n, kCellThreads, &blocks);
  if (rc != (int)cudaSuccess) return rc;
  point_add_kernel<<<blocks, kCellThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a, b, out, bad, n);
  return (int)cudaGetLastError();
}

const char* ed25519_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
