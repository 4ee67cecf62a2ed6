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
//   B3d point_add_kernel    _build_ext_add (:176): out[i] = a[i] + b[i], and
//                           the tree sums (_build_msm's and _build_grid's
//                           gp.tree_sum) in one or two launches
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
// at the H100 SXM's 132 SMs x 64 lanes x 1.98 GHz. chip_smoke.py counts
// every bound's work from this arithmetic (field_work: an add, a double, a
// wire cell's verdict of 2 squares and 2 products and its point's product),
// so that every bound measures the work and not the layout or the listing
// that does it; the one-thread kernels' listings issued 1.4-2.1 times those
// FMA passes. The bytes are small (the points once in and out), but for
// B3c's points.
//
// Design. The TPU runs each program as XLA's fused vector loops over every
// lane at once, with the field product as an int64 matmul against a 0/1
// routing matrix. B3c keeps one thread a cell: a cell is five products and
// two canonical forms, and a wave holds 502,400 cells, so nothing needs
// splitting; its products sum by output limb against 38 b ‖ b (16 int64
// sums live, not 31 diagonals), and its points leave through shared memory
// so that a warp's stores are contiguous.
// A lane of B3a or B3b is one long dependent chain (256 steps of 8 products
// for a double and 9 for an add); one thread a lane needed 255 registers
// and spilled, and left one warp a scheduler at the settle's 8,192 lanes.
// So B3a and B3b spread each field product over a group of G threads of
// one warp (Group): rank t holds 16/G limbs of every element, a product's
// factors meet in the group's shared memory (A whole, B as 38 b ‖ b, so
// that each output limb is 16 products over one aligned window of B), and
// each carry pass is one shuffle of the carry out of the rank below.
//   B3a  G = kMsmGroup threads a lane, kMsmThreads a block (at G = 8 the
//        settle's 8,192 lanes are 2,048 warps). A stage's independent
//        products (a double's four squares, an add's first four, the four
//        of the tail) lie between one __syncwarp of the group and the next
//        stage's writes; consecutive stages write different slots, so one
//        barrier a stage orders every access. A square takes each pair of
//        limbs once, as fe_sqr (its outputs split by parity). The lane's
//        point is kept in shared memory as the add's B factors (y - x,
//        y + x, t, z), formed once. A set bit is uniform in a group but not
//        in a warp: it is a branch, which measured as fast as computing
//        the add at every step and keeping it where the bit is set (the
//        reference's select; the same bits).
//   B3b  1 to 4 lanes a call: a lane is one block of four groups of
//        kWalkGroup threads, and a point add's independent products run on
//        the four groups at once (a, b, t1 2d, z1 z2; then c = (t1 2d) t2
//        with the sums around it on one group while the others form e and
//        h; then X, Y, Z, T), a __syncthreads between stages. A word's 32
//        table rows come into shared memory by cp.async while the word
//        before runs its steps, are range-checked there (every row, set or
//        not), and each set row's B factors are formed once, off the chain.
//   B3d  kAddGroup threads an add, B3a's msm_add: both operands loaded, the
//        second's B factors formed once an add. A tree is column sums over
//        a [rows, cols] view: a block holds up to 2 kTreeGroups members of
//        a column, each group summing its class on its own, then the
//        groups' partials level by level in shared memory; a wider tree
//        is two launches (cuda_ladder.tree_plan). The grid tree forms each
//        cell's point as it loads it, so the wave's [64, 7,850, 4, 16]
//        points are never written.
// The constants were chosen from tools/ladder_ab.py's times of each G on
// the H100 (PERF.md). Tensor cores are not used: Hopper's integer MMA
// (mma and wgmma, s8/u8 into s32) takes 8-bit factors, so a signed 16-bit
// limb would be split into bytes, four times the products plus the sign
// handling and the recombination, where a group finishes the 16 x 16
// limbs in 16 L IMAD.WIDE a thread. No atomics: two calls give the same
// bits.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kLimbs = 16;
constexpr int kPointLimbs = 4 * kLimbs;
constexpr int kCellThreads = 64;  // B3c
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
// 38 d, limb-wise: the folded half of d as fe_mul's B factor
__constant__ int32_t kD38[kLimbs] = {
    38 * 0x78A3, 38 * 0x1359, 38 * 0x4DCA, 38 * 0x75EB, 38 * 0xD8AB,
    38 * 0x4141, 38 * 0x0A4D, 38 * 0x0070, 38 * 0xE898, 38 * 0x7779,
    38 * 0x4079, 38 * 0x8CC7, 38 * 0xFE73, 38 * 0x2B6F, 38 * 0x6CEE,
    38 * 0x5203};
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

// the two carry passes of field.fmul over the folded sums x[k] = lo[k] +
// 38 hi[k], then narrow
__device__ __forceinline__ void carry_narrow(int64_t (&x)[kLimbs], Fe& r) {
  carry64(x);
  carry64(x);
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) r[k] = (int32_t)x[k];
}

// r = a b (field.fmul) by output limb: x[k] = sum_i a[i] B[k - i + 16]
// with B = 38 b ‖ b (b38 = 38 b), which is lo[k] + 38 hi[k] at once (the
// diagonal sums are exact integers, so any order gives the same bits): 16
// int64 sums, as a Group's rank computes its limbs; r may alias a or b
__device__ __forceinline__ void fe_mul(const Fe& a, const int32_t (&b)[kLimbs],
                                       const int32_t (&b38)[kLimbs], Fe& r) {
  int64_t x[kLimbs];
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) x[k] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) {
      if (i + j < kLimbs) x[i + j] += (int64_t)a[i] * b[j];
      else x[i + j - kLimbs] += (int64_t)a[i] * b38[j];
    }
  }
  carry_narrow(x, r);
}

__device__ __forceinline__ void fe_mul(const Fe& a, const Fe& b, Fe& r) {
  Fe b38;
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) b38[k] = 38 * b[k];
  fe_mul(a, b, b38, r);
}

// r = a a: the same sums as fe_mul(a, a), each unordered pair of limbs
// once, doubled (sqr_part's formula with F = 38 a ‖ a in registers)
__device__ __forceinline__ void fe_sqr(const Fe& a, Fe& r) {
  int32_t a38[kLimbs];
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) a38[k] = 38 * a[k];
  // F(i) = a[i] for i >= 0, 38 a[i + 16] for i < 0
#define F_(i) ((i) >= 0 ? a[(i) & 15] : a38[((i) + kLimbs) & 15])
  int64_t x[kLimbs];
#pragma unroll
  for (int h = 0; h < kLimbs / 2; ++h) {
    int64_t even = 0, odd = 0;
#pragma unroll
    for (int d = 1; d < 8; ++d) even += (int64_t)a[h + d] * F_(h - d);
#pragma unroll
    for (int d = 0; d < 8; ++d) odd += (int64_t)a[h + 1 + d] * F_(h - d);
    x[2 * h] = 2 * even + (int64_t)a[h] * a[h] + (int64_t)a[h + 8] * a38[h + 8];
    x[2 * h + 1] = 2 * odd;
  }
#undef F_
  carry_narrow(x, r);
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

__device__ __forceinline__ bool loose(long long v) {
  return v > -kLoose && v < kLoose;
}

// ------------------------------------------------------- B3a, B3b: groups

// A group of G lanes of one warp computes field products together: rank t
// owns limbs [t L, (t + 1) L) of every element it holds, L = 16 / G. A
// product a b reads its factors from shared memory: A, the 16 limbs of a,
// and B = 38 b ‖ b (32 ints), so that rank t's outputs
//   x[k] = sum_i a[i] B[k - i + 16],  k = t L + r,
// are each 16 products over one contiguous window of B, the 31 diagonal
// sums and the fold lo + 38 hi at once. The two carry passes take one
// shuffle each, the carry out of the group's rank below (rank 0 takes
// 38 times rank G - 1's).
template <int G>
struct Group {
  static_assert(G == 4 || G == 8 || G == 16, "4, 8 or 16 threads a product");
  static constexpr int L = kLimbs / G;
  int t;           // rank in the group
  int k0;          // first limb owned, t L
  int below;       // warp lane of rank t - 1 (mod G)
  unsigned mask;   // the group's lanes of the warp
  __device__ explicit Group(int thread) {
    const int lane = thread & 31, base = lane & ~(G - 1);
    t = lane - base;
    k0 = t * L;
    below = base | ((t + G - 1) & (G - 1));
    mask = ((1u << G) - 1) << base;
  }
};

// a rank's limbs of one field element, and of an extended point
template <int L>
struct Part {
  int32_t v[L];
};
template <int L>
struct PointPart {
  Part<L> c[4];  // X, Y, Z, T
};

// the widest aligned access for runs of n ints at offsets that are
// multiples of n (4 ints: 128 bits)
__host__ __device__ constexpr int run_align(int n) {
  return n % 4 == 0 ? 4 : n % 2 == 0 ? 2 : 1;
}

// N ints of shared memory from p (aligned to V ints) into registers
template <int V, int N>
__device__ __forceinline__ void lds(const int32_t* p, int32_t (&w)[N]) {
  static_assert(N % V == 0, "a whole number of accesses");
#pragma unroll
  for (int k = 0; k < N / V; ++k) {
    if constexpr (V == 4) {
      const int4 q = reinterpret_cast<const int4*>(p)[k];
      w[4 * k] = q.x;
      w[4 * k + 1] = q.y;
      w[4 * k + 2] = q.z;
      w[4 * k + 3] = q.w;
    } else if constexpr (V == 2) {
      const int2 q = reinterpret_cast<const int2*>(p)[k];
      w[2 * k] = q.x;
      w[2 * k + 1] = q.y;
    } else {
      w[k] = p[k];
    }
  }
}

template <int V, int N>
__device__ __forceinline__ void sts(int32_t* p, const int32_t (&w)[N]) {
  static_assert(N % V == 0, "a whole number of accesses");
#pragma unroll
  for (int k = 0; k < N / V; ++k) {
    if constexpr (V == 4) {
      reinterpret_cast<int4*>(p)[k] =
          make_int4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
    } else if constexpr (V == 2) {
      reinterpret_cast<int2*>(p)[k] = make_int2(w[2 * k], w[2 * k + 1]);
    } else {
      p[k] = w[k];
    }
  }
}

// rank t's limbs into an A factor (16 ints) and into a B factor (38 x ‖ x)
template <int G>
__device__ __forceinline__ void put_a(const Group<G>& g, int32_t* A,
                                      const Part<Group<G>::L>& x) {
  sts<run_align(Group<G>::L)>(A + g.k0, x.v);
}

template <int G>
__device__ __forceinline__ void put_b(const Group<G>& g, int32_t* B,
                                      const Part<Group<G>::L>& x) {
  constexpr int L = Group<G>::L;
  int32_t lo[L];
#pragma unroll
  for (int r = 0; r < L; ++r) lo[r] = 38 * x.v[r];
  sts<run_align(L)>(B + g.k0, lo);
  sts<run_align(L)>(B + kLimbs + g.k0, x.v);
}

// rank t's limbs of a field element held whole in shared memory
template <int G>
__device__ __forceinline__ Part<Group<G>::L> get(const Group<G>& g,
                                                 const int32_t* x) {
  Part<Group<G>::L> r;
  lds<run_align(Group<G>::L)>(x + g.k0, r.v);
  return r;
}

// the two carry passes of field.fmul over the group, then narrow: every
// carry of a pass is taken from the limbs before it. Pass 1's carries can
// exceed 2^31 (the sums reach 2^48), pass 2's stay below 2^22
template <int G>
__device__ __forceinline__ Part<Group<G>::L> carried(
    const Group<G>& g, int64_t (&x)[Group<G>::L]) {
  constexpr int L = Group<G>::L;
  int64_t c[L];
#pragma unroll
  for (int r = 0; r < L; ++r) c[r] = x[r] >> 16;
  int64_t cin = __shfl_sync(g.mask, c[L - 1], g.below);
  if (g.t == 0) cin *= 38;
  x[0] = (x[0] & 0xFFFF) + cin;
#pragma unroll
  for (int r = 1; r < L; ++r) x[r] = (x[r] & 0xFFFF) + c[r - 1];
  int32_t c2[L];
#pragma unroll
  for (int r = 0; r < L; ++r) c2[r] = (int32_t)(x[r] >> 16);
  int32_t cin2 = __shfl_sync(g.mask, c2[L - 1], g.below);
  if (g.t == 0) cin2 *= 38;
  Part<L> out;
  out.v[0] = (int32_t)(x[0] & 0xFFFF) + cin2;
#pragma unroll
  for (int r = 1; r < L; ++r) out.v[r] = (int32_t)(x[r] & 0xFFFF) + c2[r - 1];
  return out;
}

// the carry pass of fadd and fsub over the group (limbs below 2^21)
template <int G>
__device__ __forceinline__ void carry_part(const Group<G>& g,
                                           Part<Group<G>::L>& x) {
  constexpr int L = Group<G>::L;
  int32_t c[L];
#pragma unroll
  for (int r = 0; r < L; ++r) c[r] = x.v[r] >> 16;
  int32_t cin = __shfl_sync(g.mask, c[L - 1], g.below);
  if (g.t == 0) cin *= 38;
  x.v[0] = (x.v[0] & 0xFFFF) + cin;
#pragma unroll
  for (int r = 1; r < L; ++r) x.v[r] = (x.v[r] & 0xFFFF) + c[r - 1];
}

template <int G>
__device__ __forceinline__ Part<Group<G>::L> add_part(
    const Group<G>& g, const Part<Group<G>::L>& a, const Part<Group<G>::L>& b) {
  Part<Group<G>::L> r;
#pragma unroll
  for (int i = 0; i < Group<G>::L; ++i) r.v[i] = a.v[i] + b.v[i];
  carry_part(g, r);
  return r;
}

// a + 8p - b: EIGHT_P's limbs are 4 * 0xFFFF but limb 0's
template <int G>
__device__ __forceinline__ Part<Group<G>::L> sub_part(
    const Group<G>& g, const Part<Group<G>::L>& a, const Part<Group<G>::L>& b) {
  Part<Group<G>::L> r;
#pragma unroll
  for (int i = 0; i < Group<G>::L; ++i) r.v[i] = a.v[i] + 4 * 0xFFFF - b.v[i];
  if (g.t == 0) r.v[0] -= 4 * 37;
  carry_part(g, r);
  return r;
}

// a point as the second operand of an add: its B factors y - x, y + x, t, z
template <int G>
__device__ __forceinline__ void put_point_b(const Group<G>& g,
                                            int32_t (&q)[4][2 * kLimbs],
                                            const PointPart<Group<G>::L>& p) {
  put_b(g, q[0], sub_part(g, p.c[1], p.c[0]));
  put_b(g, q[1], add_part(g, p.c[1], p.c[0]));
  put_b(g, q[2], p.c[3]);
  put_b(g, q[3], p.c[2]);
}

// rank t's limbs of the [4, 16] int64 point at src; false if one lies
// outside (-2^19, 2^19)
template <int G>
__device__ __forceinline__ bool load_part(const Group<G>& g,
                                          const int64_t* __restrict__ src,
                                          PointPart<Group<G>::L>& p) {
  constexpr int L = Group<G>::L;
  bool ok = true;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int64_t* s = src + c * kLimbs + g.k0;
    if constexpr (L % 2 == 0) {
#pragma unroll
      for (int r = 0; r < L; r += 2) {
        const longlong2 w = __ldg(reinterpret_cast<const longlong2*>(s + r));
        ok &= loose(w.x) & loose(w.y);
        p.c[c].v[r] = (int32_t)w.x;
        p.c[c].v[r + 1] = (int32_t)w.y;
      }
    } else {
#pragma unroll
      for (int r = 0; r < L; ++r) {
        const long long v = __ldg(s + r);
        ok &= loose(v);
        p.c[c].v[r] = (int32_t)v;
      }
    }
  }
  return ok;
}

template <int G>
__device__ __forceinline__ void store_part(const Group<G>& g,
                                           int64_t* __restrict__ dst,
                                           const PointPart<Group<G>::L>& p) {
  constexpr int L = Group<G>::L;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int64_t* d = dst + c * kLimbs + g.k0;
    if constexpr (L % 2 == 0) {
#pragma unroll
      for (int r = 0; r < L; r += 2)
        reinterpret_cast<longlong2*>(d + r)[0] =
            make_longlong2(p.c[c].v[r], p.c[c].v[r + 1]);
    } else {
#pragma unroll
      for (int r = 0; r < L; ++r) d[r] = p.c[c].v[r];
    }
  }
}

// rank t's limbs of a b: a in registers, B = 38 b ‖ b
template <int G>
__device__ __forceinline__ Part<Group<G>::L> mul_regs(
    const Group<G>& g, const int32_t (&a)[kLimbs], const int32_t* B) {
  constexpr int L = Group<G>::L;
  int32_t w[L + kLimbs];  // w[q] = B[k0 + q]
  lds<run_align(L)>(B + g.k0, w);
  int64_t x[L];
#pragma unroll
  for (int r = 0; r < L; ++r) x[r] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
#pragma unroll
    for (int r = 0; r < L; ++r) x[r] += (int64_t)a[i] * w[r - i + kLimbs];
  }
  return carried(g, x);
}

// the same with a read from A (16 ints of shared memory)
template <int G>
__device__ __forceinline__ Part<Group<G>::L> mul_part(const Group<G>& g,
                                                      const int32_t* A,
                                                      const int32_t* B) {
  int32_t a[kLimbs];
  lds<4>(A, a);
  return mul_regs(g, a, B);
}

// rank t's limbs of a a from F = 38 a ‖ a: each unordered pair of limbs
// once, doubled, as fe_sqr (the same diagonal sums). For k = 2h the pairs
// are (h - d, h + d), d = 1..7, and the squares of a[h] and a[h + 8] (38
// a[h + 8]^2); for k = 2h + 1 they are (h - d, h + 1 + d), d = 0..7; an
// index below 0 wraps to its limb + 16 with the weight 38, which F[16 + i]
// gives for i < 0. With an odd L (G = 16) a rank's outputs have no fixed
// parity, and the square is the plain product with A = F's upper half.
template <int G>
__device__ __forceinline__ Part<Group<G>::L> sqr_part(const Group<G>& g,
                                                      const int32_t* F) {
  constexpr int L = Group<G>::L;
  if constexpr (L % 2) {
    return mul_part(g, F + kLimbs, F);
  } else {
    constexpr int H = L / 2;
    int32_t w[H + kLimbs];  // w[q] = F[8 + h0 + q], h0 = k0 / 2
    lds<run_align(H)>(F + 8 + g.k0 / 2, w);
    int64_t x[L];
#pragma unroll
    for (int s = 0; s < H; ++s) {  // h = h0 + s: F[16 + h + i] = w[8 + s + i]
      int64_t even = 0, odd = 0;
#pragma unroll
      for (int d = 1; d < 8; ++d) even += (int64_t)w[8 + s + d] * w[8 + s - d];
#pragma unroll
      for (int d = 0; d < 8; ++d) odd += (int64_t)w[9 + s + d] * w[8 + s - d];
      x[2 * s] = 2 * even + (int64_t)w[8 + s] * w[8 + s]
          + (int64_t)w[16 + s] * w[s];
      x[2 * s + 1] = 2 * odd;
    }
    return carried(g, x);
  }
}

// ------------------------------------------------------------------ B3a

// B3a's layout: G threads a lane, kMsmThreads a block. G = 4 is 7 %
// faster at the settle's 8,192 lanes, G = 8 1.8 times faster at the 32 to
// 128 lanes of a small msm, and G = 8 costs the main path's launches the
// least in all (PERF.md)
constexpr int kMsmGroup = 8;
constexpr int kMsmThreads = 128;

// a group's shared memory. Consecutive stages of the ladder write
// different slots, so one __syncwarp between a stage's writes and its
// reads orders every access: a slot is written again only two stages
// after it was read, past the stage between's barrier.
struct alignas(16) MsmSmem {
  int32_t p[4][2 * kLimbs];    // the lane's point as B factors: y - x,
                               // y + x, t, z
  int32_t sq[4][2 * kLimbs];   // the double's squares: X, Y, X + Y, Z;
                               // the add's A factors (sq[0], sq[1]), u
  int32_t e[kLimbs];           // the last four products' A factor e
  int32_t fhg[3][2 * kLimbs];  // their B factors f, h, g (f, g also as A)
};

// X = e f, Y = g h, Z = f g, T = e h: the tail of point_add and
// point_double (S: MsmSmem or AddSmem, whose e and fhg it writes)
template <int G, class S>
__device__ __forceinline__ void msm_finish(const Group<G>& g, S& s,
                                           const Part<Group<G>::L>& e,
                                           const Part<Group<G>::L>& f,
                                           const Part<Group<G>::L>& gg,
                                           const Part<Group<G>::L>& h,
                                           PointPart<Group<G>::L>& r) {
  put_a(g, s.e, e);
  put_b(g, s.fhg[0], f);
  put_b(g, s.fhg[1], h);
  put_b(g, s.fhg[2], gg);
  __syncwarp(g.mask);
  int32_t ea[kLimbs];
  lds<4>(s.e, ea);
  r.c[0] = mul_regs(g, ea, s.fhg[0]);
  r.c[3] = mul_regs(g, ea, s.fhg[1]);
  r.c[1] = mul_part(g, s.fhg[2] + kLimbs, s.fhg[1]);
  r.c[2] = mul_part(g, s.fhg[0] + kLimbs, s.fhg[2]);
}

// group.point_double over the group; r may be p
template <int G>
__device__ __forceinline__ void msm_double(const Group<G>& g, MsmSmem& s,
                                           PointPart<Group<G>::L>& p) {
  const auto xy = add_part(g, p.c[0], p.c[1]);
  put_b(g, s.sq[0], p.c[0]);
  put_b(g, s.sq[1], p.c[1]);
  put_b(g, s.sq[2], xy);
  put_b(g, s.sq[3], p.c[2]);
  __syncwarp(g.mask);
  const auto a = sqr_part(g, s.sq[0]);
  const auto b = sqr_part(g, s.sq[1]);
  const auto xy2 = sqr_part(g, s.sq[2]);
  const auto zz = sqr_part(g, s.sq[3]);
  const auto h = add_part(g, a, b);
  const auto e = sub_part(g, h, xy2);
  const auto gg = sub_part(g, a, b);
  const auto c = add_part(g, zz, zz);
  const auto f = add_part(g, c, gg);
  msm_finish(g, s, e, f, gg, h, p);
}

// group.point_add of acc and a second point q, given as its B factors
// (y - x, y + x, t, z; 2d's in d2), acc the left operand; r may be acc.
// It writes s.sq[0..2], then s.e and s.fhg; q is read before the barrier
// of msm_finish (S: MsmSmem or AddSmem)
template <int G, class S>
__device__ __forceinline__ void msm_add(const Group<G>& g, S& s,
                                        const int32_t (&q)[4][2 * kLimbs],
                                        const int32_t* d2,
                                        PointPart<Group<G>::L>& acc) {
  put_a(g, s.sq[0], sub_part(g, acc.c[1], acc.c[0]));
  put_a(g, s.sq[0] + kLimbs, add_part(g, acc.c[1], acc.c[0]));
  put_a(g, s.sq[1], acc.c[3]);
  put_a(g, s.sq[1] + kLimbs, acc.c[2]);
  __syncwarp(g.mask);
  const auto a = mul_part(g, s.sq[0], q[0]);
  const auto b = mul_part(g, s.sq[0] + kLimbs, q[1]);
  const auto u = mul_part(g, s.sq[1], d2);  // t1 2d
  const auto zz = mul_part(g, s.sq[1] + kLimbs, q[3]);
  put_a(g, s.sq[2], u);
  __syncwarp(g.mask);
  const auto c = mul_part(g, s.sq[2], q[2]);  // (t1 2d) t2
  const auto e = sub_part(g, b, a);
  const auto h = add_part(g, b, a);
  const auto dd = add_part(g, zz, zz);
  const auto f = sub_part(g, dd, c);
  const auto gg = add_part(g, dd, c);
  msm_finish(g, s, e, f, gg, h, acc);
}

template <int G, int Threads>
__global__ void __launch_bounds__(Threads)
msm_ladder_kernel(const uint32_t* __restrict__ bits, int words,
                  const int64_t* __restrict__ pts, int64_t* __restrict__ out,
                  int* __restrict__ bad, long long m) {
  constexpr int L = Group<G>::L;
  __shared__ MsmSmem smem[Threads / G];
  __shared__ __align__(16) int32_t d2[2 * kLimbs];  // 38 (2d) ‖ 2d
  if (threadIdx.x < kLimbs) {
    d2[threadIdx.x] = 38 * kD2[threadIdx.x];
    d2[kLimbs + threadIdx.x] = kD2[threadIdx.x];
  }
  __syncthreads();
  const long long i = ((long long)blockIdx.x * Threads + threadIdx.x) / G;
  if (i >= m) return;  // the whole group: its lane is past m
  const Group<G> g(threadIdx.x);
  MsmSmem& s = smem[threadIdx.x / G];

  // rank t's limbs of the point, checked as loaded
  PointPart<L> p;
  if (!load_part(g, pts + i * kPointLimbs, p)) *bad = 1;
  put_point_b(g, s.p, p);

  PointPart<L> acc;  // the identity (0, 1, 1, 0)
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int r = 0; r < L; ++r) acc.c[c].v[r] = 0;
  }
  if (g.t == 0) acc.c[1].v[0] = acc.c[2].v[0] = 1;

  const uint32_t* lane = bits + i * words;
#pragma unroll 1
  for (int w = 0; w < words; ++w) {
    const uint32_t word = __ldg(lane + w);
#pragma unroll 1
    for (int b = 0; b < 32; ++b) {
      msm_double(g, s, acc);
      if ((word >> b) & 1u) msm_add(g, s, s.p, d2, acc);
    }
  }
  store_part(g, out + i * kPointLimbs, acc);
}

// ------------------------------------------------------------------ B3b

// B3b's layout: four groups of kWalkGroup threads a lane, one lane a block
constexpr int kWalkGroup = 16;

// cp.async of 16 bytes from global to shared memory, and its waits
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x whole as a B factor (38 x ‖ x), by one thread
__device__ __forceinline__ void put_b_whole(int32_t* B, const Fe& x) {
  int32_t lo[kLimbs];
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) lo[k] = 38 * x[k];
  sts<4>(B, lo);
  sts<4>(B + kLimbs, x);
}

// a table row (its int64 limbs in shared memory, checked already) as the
// add's B factors: Y - X, Y + X, T, Z, by one thread
__device__ __forceinline__ void walk_row(const int64_t* src,
                                         int32_t (&dst)[4][2 * kLimbs]) {
  Point q;
#pragma unroll
  for (int k = 0; k < kPointLimbs / 2; ++k) {
    const longlong2 w = reinterpret_cast<const longlong2*>(src)[k];
    q.v[k / 8][(2 * k) % kLimbs] = (int32_t)w.x;
    q.v[k / 8][(2 * k) % kLimbs + 1] = (int32_t)w.y;
  }
  Fe t;
  fe_sub(q.v[1], q.v[0], t);
  put_b_whole(dst[0], t);
  fe_add(q.v[1], q.v[0], t);
  put_b_whole(dst[1], t);
  put_b_whole(dst[2], q.v[3]);
  put_b_whole(dst[3], q.v[2]);
}

// a lane's shared memory
struct alignas(16) WalkSmem {
  int64_t raw[32 * kPointLimbs];     // a word's 32 table rows as loaded
  int32_t rows[32][4][2 * kLimbs];   // its set rows' B factors (walk_row)
  int32_t acc[4][kLimbs];            // X, Y, Z, T
  int32_t mid[4][kLimbs];            // a, b, u = t1 2d, zz
  int32_t f[kLimbs];                 // the last products' A factor f
  int32_t ehg[3][2 * kLimbs];        // their B factors e, h, g (e, g as A)
  int32_t d2[2 * kLimbs];            // 38 (2d) ‖ 2d
};

// group.point_add(acc, q) with q's B factors in `row`: group j computes
// one of the four independent products of a stage, and the lane's
// threads meet at a barrier after each stage
template <int G>
__device__ __forceinline__ void walk_add(const Group<G>& g, int j,
                                         WalkSmem& s,
                                         const int32_t (&row)[4][2 * kLimbs]) {
  // a = (y1 - x1)(y2 - x2), b = (y1 + x1)(y2 + x2), u = t1 2d, zz = z1 z2
  {
    int32_t a[kLimbs];
    const int32_t* B;
    if (j < 2) {
      Fe x, y;
      lds<4>(s.acc[0], x);
      lds<4>(s.acc[1], y);
      if (j == 0) {
        fe_sub(y, x, a);
        B = row[0];
      } else {
        fe_add(y, x, a);
        B = row[1];
      }
    } else {
      lds<4>(s.acc[j == 2 ? 3 : 2], a);
      B = j == 2 ? s.d2 : row[3];
    }
    put_a(g, s.mid[j], mul_regs(g, a, B));
  }
  __syncthreads();
  // c = u t2 and f = dd - c, g = dd + c (dd = zz + zz) by group 2; e =
  // b - a by group 0; h = b + a by group 1
  if (j == 2) {
    const auto c = mul_part(g, s.mid[2], row[2]);
    const auto zz = get(g, s.mid[3]);
    const auto dd = add_part(g, zz, zz);
    put_a(g, s.f, sub_part(g, dd, c));
    put_b(g, s.ehg[2], add_part(g, dd, c));
  } else if (j < 2) {
    const auto a = get(g, s.mid[0]), b = get(g, s.mid[1]);
    put_b(g, s.ehg[j], j == 0 ? sub_part(g, b, a) : add_part(g, b, a));
  }
  __syncthreads();
  // X = e f, Y = g h, Z = f g, T = e h
  const int32_t* A = (j == 0 || j == 2) ? s.f
                     : j == 1 ? s.ehg[2] + kLimbs : s.ehg[0] + kLimbs;
  const int32_t* B = j == 0 ? s.ehg[0] : j == 2 ? s.ehg[2] : s.ehg[1];
  put_a(g, s.acc[j], mul_part(g, A, B));
  __syncthreads();
}

// copy word w's 32 table rows into s.raw, 16 bytes a thread at a time
template <int Threads>
__device__ __forceinline__ void walk_stage(WalkSmem& s,
                                           const int64_t* __restrict__ table,
                                           int w) {
  const int64_t* src = table + (long long)w * 32 * kPointLimbs;
#pragma unroll 1
  for (int k = threadIdx.x; k < 32 * kPointLimbs / 2; k += Threads)
    cp_async16(s.raw + 2 * k, src + 2 * k);
  cp_async_commit();
}

template <int G>
__global__ void __launch_bounds__(4 * G)
fixed_walk_kernel(const uint32_t* __restrict__ bits, int words,
                  const int64_t* __restrict__ table, int64_t* __restrict__ out,
                  int* __restrict__ bad) {
  constexpr int kThreads = 4 * G;
  __shared__ WalkSmem s;
  const long long i = blockIdx.x;  // the lane
  const int j = threadIdx.x / G;   // the product group
  const Group<G> g(threadIdx.x);
  for (int k = threadIdx.x; k < 4 * kLimbs; k += kThreads)
    (&s.acc[0][0])[k] = (k == kLimbs || k == 2 * kLimbs) ? 1 : 0;
  for (int k = threadIdx.x; k < kLimbs; k += kThreads) {
    s.d2[k] = 38 * kD2[k];
    s.d2[kLimbs + k] = kD2[k];
  }
  walk_stage<kThreads>(s, table, 0);
  bool ok = true;
  const uint32_t* lane = bits + i * words;
#pragma unroll 1
  for (int w = 0; w < words; ++w) {
    const uint32_t word = __ldg(lane + w);
    cp_async_wait_all();
    __syncthreads();
    // every row of the word is checked, set or not; the set ones become
    // B factors; then the next word's rows load while this word's steps run
#pragma unroll 1
    for (int k = threadIdx.x; k < 32 * kPointLimbs / 2; k += kThreads) {
      const longlong2 v = reinterpret_cast<const longlong2*>(s.raw)[k];
      ok &= loose(v.x) & loose(v.y);
    }
#pragma unroll 1
    for (int r = threadIdx.x; r < 32; r += kThreads) {
      if ((word >> r) & 1u) walk_row(s.raw + r * kPointLimbs, s.rows[r]);
    }
    __syncthreads();
    if (w + 1 < words) walk_stage<kThreads>(s, table, w + 1);
#pragma unroll 1
    for (int b = 0; b < 32; ++b) {
      if ((word >> b) & 1u) walk_add(g, j, s, s.rows[b]);
    }
  }
  if (!ok) *bad = 1;
  for (int k = threadIdx.x; k < 4 * kLimbs; k += kThreads)
    out[i * kPointLimbs + k] = (&s.acc[0][0])[k];
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
  fe_mul(t, kD, kD38, t);  // d's limbs read from constant memory
  t[0] += 1;  // fadd(ONE, d xx yy)
  carry32(t);
  canonical(lhs);
  canonical(t);
  bool eq = true;
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) eq &= lhs[k] == t[k];
  return eq;
}

// one thread a cell (kCellThreads a block): the cell's work is short and
// the wave holds 502,400 cells, so no chain needs splitting; the products
// keep 16 int64 sums each (fe_mul, fe_sqr). With Points, also the point
// (x, y, 1, x y), formed first so that x and y die with the verdict's
// squares, and staged in shared memory so that the block writes its
// points' bytes in order, a warp 512 contiguous bytes a store; without,
// the verdict alone (grid_sum's path, where the tree forms the points as
// it loads the cells)
template <bool Points>
__global__ void __launch_bounds__(kCellThreads)
grid_points_kernel(const int64_t* __restrict__ xy, uint8_t* __restrict__ ok,
                   int64_t* __restrict__ pts, int* __restrict__ bad,
                   long long cells) {
  constexpr int kRow = kPointLimbs / 2;  // a point's 16-byte words
  // a cell's words, padded by one so that a quarter warp's stores hit
  // distinct banks
  __shared__ longlong2 stage[Points ? kCellThreads : 1][kRow + 1];
  const long long first = (long long)blockIdx.x * kCellThreads;
  const long long i = first + threadIdx.x;
  if (i < cells) {
    Fe x, y;
    uint64_t all = 0;  // the OR of the cell's 32 raw limbs
    const longlong2* cell =
        reinterpret_cast<const longlong2*>(xy + i * 2 * kLimbs);
#pragma unroll
    for (int k = 0; k < kLimbs / 2; ++k) {
      const longlong2 vx = __ldg(cell + k);
      const longlong2 vy = __ldg(cell + kLimbs / 2 + k);
      all |= (uint64_t)vx.x | (uint64_t)vx.y | (uint64_t)vy.x | (uint64_t)vy.y;
      x[2 * k] = (int32_t)vx.x;
      x[2 * k + 1] = (int32_t)vx.y;
      y[2 * k] = (int32_t)vy.x;
      y[2 * k + 1] = (int32_t)vy.y;
    }
    // a wire limb outside [0, 2^16) (a negative one has its top bit set)
    if (all >> 16) *bad = 1;
    if constexpr (Points) {
      Fe t;
      fe_mul(x, y, t);
      longlong2* d = stage[threadIdx.x];
#pragma unroll
      for (int k = 0; k < kLimbs / 2; ++k) {
        d[k] = make_longlong2(x[2 * k], x[2 * k + 1]);
        d[kLimbs / 2 + k] = make_longlong2(y[2 * k], y[2 * k + 1]);
        d[kLimbs + k] = make_longlong2(k == 0 ? 1 : 0, 0);
        d[3 * kLimbs / 2 + k] = make_longlong2(t[2 * k], t[2 * k + 1]);
      }
    }
    const bool canon = lt_p(x) & lt_p(y);
    ok[i] = (uint8_t)(canon & on_curve(x, y));
  }
  if constexpr (Points) {
    __syncthreads();
    const long long n = cells - first < kCellThreads ? cells - first
                                                     : kCellThreads;
    longlong2* out = reinterpret_cast<longlong2*>(pts + first * kPointLimbs);
    for (int w = threadIdx.x; w < n * kRow; w += kCellThreads)
      out[w] = stage[w / kRow][w % kRow];
  }
}

// ------------------------------------------------------------------ B3d

// B3d's layout: G = kAddGroup threads a point add (Group, the product of
// B3a), kAddThreads a block for the pointwise add, kTreeGroups groups a
// block of a tree launch, so that one block reduces up to 2 kTreeGroups
// points
constexpr int kAddGroup = 8;
constexpr int kAddThreads = 128;
constexpr int kTreeGroups = 64;

// a group's shared memory: the second operand's B factors (q: y - x,
// y + x, t, z), which the group's own adds read and, in a tree, the level
// after its last add reads from another group, and msm_add's scratch
struct alignas(16) AddSmem {
  int32_t q[4][2 * kLimbs];
  int32_t sq[3][2 * kLimbs];
  int32_t e[kLimbs];
  int32_t fhg[3][2 * kLimbs];
};

// the point (x, y, 1, x y) of the wire cell at src (x, y limbs in [0,
// 2^16); ok cleared if one lies outside), or the identity (0, 1, 1, 0)
// where its grid is invalid: grid_points_plain's point, masked as
// grid_sum masks it. The product meets in s.sq[2] (x as A) and s.sq[0] (y
// as B), between two barriers of the group, so that the adds around it
// keep their slots' order
template <int G>
__device__ __forceinline__ PointPart<Group<G>::L> cell_point(
    const Group<G>& g, AddSmem& s, const int64_t* __restrict__ src,
    bool valid, bool& ok) {
  constexpr int L = Group<G>::L;
  Part<L> x, y;
  uint64_t all = 0;
#pragma unroll
  for (int r = 0; r < L; ++r) {
    const long long vx = __ldg(src + g.k0 + r);
    const long long vy = __ldg(src + kLimbs + g.k0 + r);
    all |= (uint64_t)vx | (uint64_t)vy;
    x.v[r] = (int32_t)vx;
    y.v[r] = (int32_t)vy;
  }
  ok &= (all >> 16) == 0;
  PointPart<L> p;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int r = 0; r < L; ++r) p.c[c].v[r] = 0;
  }
  if (g.t == 0) p.c[1].v[0] = p.c[2].v[0] = 1;  // the identity; Z = 1
  if (valid) {
    put_a(g, s.sq[2], x);
    put_b(g, s.sq[0], y);
    __syncwarp(g.mask);
    p.c[0] = x;
    p.c[1] = y;
    p.c[3] = mul_part(g, s.sq[2], s.sq[0]);
    __syncwarp(g.mask);
  }
  return p;
}

// the deepest stack of the sequential part of a tree (2^31 members a group)
constexpr int kTreeDepth = 32;

// Column sums of a [rows, cols] batch of points (Cells: of wire cells,
// each made a point by cell_point, with grid_ok[f / row_cells] its grid's
// verdict, f the cell's flat index): out[c] = the sum over r of member
// (r, c), paired as gp.tree_sum pairs them, level l adding i and
// i + half with the first half the left operand. Rows r < rows / 2 lie at
// lo + (r cols + c), the rest at hi + ((r - rows / 2) cols + c), so that
// a pointwise add (rows = 2) takes its two operands apart.
//
// Output j of level k of a tree of n members is the sum, in the tree's
// own order, of the 2^k members congruent to j mod n / 2^k. So a column
// of rows members is split among q = min(Groups, rows / 2) groups: group
// j first reduces its class (members j, j + q, ...: rows / q of them,
// paired likewise) on its own, an add at a time, then the q groups'
// partials meet through shared memory, level by level, a __syncthreads a
// level: the groups of the upper half write their partial as B factors
// into their own slot, and those of the lower half add it. A slot is
// written once after the group's own adds (past their barriers) and read
// once, by another group, after the level's barrier; no group writes a
// slot that a group still reads. A block holds Groups / q columns. The
// class is reduced in the bit-reversed order, where the tree pairs
// neighbours, with a stack of partials (used once a class has four
// members or more).
template <int G, int Groups, bool Cells>
__global__ void __launch_bounds__(Groups * G)
point_add_kernel(const int64_t* __restrict__ lo, const int64_t* __restrict__ hi,
                 const uint8_t* __restrict__ grid_ok, long long row_cells,
                 int64_t* __restrict__ out, int* __restrict__ bad, int rows,
                 long long cols) {
  constexpr int L = Group<G>::L;
  constexpr int kWidth = Cells ? 2 * kLimbs : kPointLimbs;  // limbs a member
  extern __shared__ __align__(16) unsigned char tree_smem[];
  __shared__ __align__(16) int32_t d2[2 * kLimbs];  // 38 (2d) ‖ 2d
  AddSmem* smem = reinterpret_cast<AddSmem*>(tree_smem);
  for (int k = threadIdx.x; k < kLimbs; k += Groups * G) {
    d2[k] = 38 * kD2[k];
    d2[kLimbs + k] = kD2[k];
  }
  __syncthreads();
  const Group<G> g(threadIdx.x);
  const int group = threadIdx.x / G;
  AddSmem& s = smem[group];
  const int half = rows / 2;
  const int q = half < 1 ? 1 : (half < Groups ? half : Groups);
  const int per = rows / q;  // members of a group's class
  const long long col = (long long)blockIdx.x * (Groups / q) + group / q;
  const int j = group % q;
  const bool live = col < cols;
  bool ok = true;

  // member (r, col) as a point, checked as loaded
  auto member = [&](int r) {
    const long long f = (long long)r * cols + col;
    const int64_t* src = r < half || rows == 1
        ? lo + f * kWidth : hi + (f - (long long)half * cols) * kWidth;
    PointPart<L> p;
    if constexpr (Cells) {
      // the grid of the cell: its row where the launch views the cells
      // as they lie, [grids, cells a grid]
      const long long grid = row_cells == cols ? r : f / row_cells;
      p = cell_point(g, s, src, grid_ok[grid] != 0, ok);
    } else {
      ok &= load_part(g, src, p);
    }
    return p;
  };

  PointPart<L> acc;
  if (live) {
    if (per == 1) {
      acc = member(j);
    } else {
      PointPart<L> stack[kTreeDepth];
      int bits = 0;
      while ((1 << bits) < per) ++bits;
      for (int v = 0; v < per; v += 2) {
        // the pair (u, u + per / 2), u = v bit-reversed, on the way up
        const int u = (int)(__brev((unsigned)v) >> (32 - bits));
        acc = member(j + u * q);
        put_point_b(g, s.q, member(j + (u + per / 2) * q));
        msm_add(g, s, s.q, d2, acc);
        int h = 1;
        for (; ((v + 1) >> h) & 1; ++h) {  // the left partial waits below
          put_point_b(g, s.q, acc);
          acc = stack[h];
          msm_add(g, s, s.q, d2, acc);
        }
        if (v + 2 < per) stack[h] = acc;
      }
    }
  }
  for (int n = q; n > 1; n /= 2) {
    if (live && j >= n / 2 && j < n) put_point_b(g, s.q, acc);
    __syncthreads();
    if (live && j < n / 2) msm_add(g, s, smem[group + n / 2].q, d2, acc);
  }
  if (!ok) *bad = 1;
  if (live && j == 0) store_part(g, out + col * kPointLimbs, acc);
}

int blocks_for(long long n, int threads, unsigned* blocks) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long b = (n + threads - 1) / threads;
  if (b > INT_MAX) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)b;
  return (int)cudaSuccess;
}

// let `kernel` take `smem` bytes of dynamic shared memory where that is
// above the default 48 KB, once a device (a host-side call that costs far
// more than a small launch): `allowed` holds a bit a device, one word for
// each kernel
template <class Kernel>
int allow_smem(Kernel kernel, int smem,
               std::atomic<unsigned long long>& allowed) {
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (allowed.load() & bit) return (int)cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed.fetch_or(bit);
  return (int)err;
}

// one launch of point_add_kernel<kAddGroup, Groups, Cells> over [rows,
// cols], its groups' shared memory dynamic
template <int Groups, bool Cells>
int launch_tree(const int64_t* lo, const int64_t* hi, const uint8_t* grid_ok,
                long long row_cells, int64_t* out, int* bad, long long rows,
                long long cols, void* stream) {
  if (rows <= 0 || rows > INT_MAX || (rows & (rows - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const long long q = rows / 2 < 1 ? 1 : rows / 2 < Groups ? rows / 2 : Groups;
  unsigned blocks;
  const int rc = blocks_for(cols, Groups / (int)q, &blocks);
  if (rc != (int)cudaSuccess) return rc;
  auto kernel = point_add_kernel<kAddGroup, Groups, Cells>;
  const int smem = Groups * (int)sizeof(AddSmem);
  static std::atomic<unsigned long long> allowed{0};  // this instance's
  const int err = allow_smem(kernel, smem, allowed);
  if (err != (int)cudaSuccess) return err;
  kernel<<<blocks, Groups * kAddGroup, smem,
           static_cast<cudaStream_t>(stream)>>>(lo, hi, grid_ok, row_cells,
                                                out, bad, (int)rows, cols);
  return (int)cudaGetLastError();
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
  const int rc = blocks_for(m, kMsmThreads / kMsmGroup, &blocks);
  if (rc != (int)cudaSuccess || words <= 0) return (int)cudaErrorInvalidValue;
  msm_ladder_kernel<kMsmGroup, kMsmThreads>
      <<<blocks, kMsmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          bits, words, pts, out, bad, m);
  return (int)cudaGetLastError();
}

// B3b: out[i] = the sum of table[s] over the set steps s of bits[i]
// (table [32 words, 4, 16]), added in step order from the identity.
int ed25519_fixed_walk(const uint32_t* bits, int words, const int64_t* table,
                       int64_t* out, int* bad, long long m, void* stream) {
  unsigned blocks;
  const int rc = blocks_for(m, 1, &blocks);
  if (rc != (int)cudaSuccess || words <= 0) return (int)cudaErrorInvalidValue;
  fixed_walk_kernel<kWalkGroup>
      <<<blocks, 4 * kWalkGroup, 0, static_cast<cudaStream_t>(stream)>>>(
          bits, words, table, out, bad);
  return (int)cudaGetLastError();
}

// B3c: for each of `cells` affine cells xy[c, 2, 16] (wire limbs in
// [0, 2^16)), ok[c] = x < p & y < p & on the curve, and, unless pts is
// null, pts[c] = (x, y, 1, x y) as a [4, 16] point.
int ed25519_grid_points(const int64_t* xy, uint8_t* ok, int64_t* pts, int* bad,
                        long long cells, void* stream) {
  unsigned blocks;
  const int rc = blocks_for(cells, kCellThreads, &blocks);
  if (rc != (int)cudaSuccess) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pts != nullptr) {
    grid_points_kernel<true><<<blocks, kCellThreads, 0, s>>>(xy, ok, pts, bad,
                                                            cells);
  } else {
    grid_points_kernel<false><<<blocks, kCellThreads, 0, s>>>(xy, ok, pts,
                                                             bad, cells);
  }
  return (int)cudaGetLastError();
}

// B3d: out[i] = a[i] + b[i] for n points (out overlaps neither input).
int ed25519_point_add(const int64_t* a, const int64_t* b, int64_t* out,
                      int* bad, long long n, void* stream) {
  return launch_tree<kAddThreads / kAddGroup, false>(a, b, nullptr, 1, out,
                                                     bad, 2, n, stream);
}

// B3d, a tree launch: out[c] = the column sum of pts viewed as [rows, cols]
// (rows a power of two), in gp.tree_sum's pairing; out overlaps nothing.
int ed25519_point_tree(const int64_t* pts, int64_t* out, int* bad,
                       long long rows, long long cols, void* stream) {
  return launch_tree<kTreeGroups, false>(
      pts, pts + (rows / 2) * cols * kPointLimbs, nullptr, 1, out, bad, rows,
      cols, stream);
}

// B3d, a grid tree launch: the same over the cells xy viewed as [rows,
// cols, 2, 16], each cell the point (x, y, 1, x y) where grid_ok[f /
// row_cells] (f its flat index) and the identity elsewhere.
int ed25519_grid_tree(const int64_t* xy, const uint8_t* grid_ok, int64_t* out,
                      int* bad, long long rows, long long cols,
                      long long row_cells, void* stream) {
  if (row_cells <= 0) return (int)cudaErrorInvalidValue;
  return launch_tree<kTreeGroups, true>(
      xy, xy + (rows / 2) * cols * 2 * kLimbs, grid_ok, row_cells, out, bad,
      rows, cols, stream);
}

// the reach of one tree launch: it pairs up to 2 kTreeGroups members a
// column in shared memory
int ed25519_tree_groups(void) { return kTreeGroups; }

const char* ed25519_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
