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
// pipes of one add from B3d's SASS and of one double from constants read
// off the one-thread-a-lane B3a's SASS (git 86a9ec2), so that the bound of
// B3a and B3b measures the work and not the layout that does it. The bytes
// are small (the points once in and out).
//
// Design. The TPU runs each program as XLA's fused vector loops over every
// lane at once, with the field product as an int64 matmul against a 0/1
// routing matrix. B3c and B3d keep one thread a cell or pair and its points
// in registers, with B2's schoolbook product into 31 int64 accumulators.
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

namespace {

constexpr int kLimbs = 16;
constexpr int kPointLimbs = 4 * kLimbs;
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
// point_double
template <int G>
__device__ __forceinline__ void msm_finish(const Group<G>& g, MsmSmem& s,
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

// group.point_add of acc and the lane's point (its B factors in s.p; 2d's
// in d2); r may be acc
template <int G>
__device__ __forceinline__ void msm_add(const Group<G>& g, MsmSmem& s,
                                        const int32_t* d2,
                                        PointPart<Group<G>::L>& acc) {
  put_a(g, s.sq[0], sub_part(g, acc.c[1], acc.c[0]));
  put_a(g, s.sq[0] + kLimbs, add_part(g, acc.c[1], acc.c[0]));
  put_a(g, s.sq[1], acc.c[3]);
  put_a(g, s.sq[1] + kLimbs, acc.c[2]);
  __syncwarp(g.mask);
  const auto a = mul_part(g, s.sq[0], s.p[0]);
  const auto b = mul_part(g, s.sq[0] + kLimbs, s.p[1]);
  const auto u = mul_part(g, s.sq[1], d2);  // t1 2d
  const auto zz = mul_part(g, s.sq[1] + kLimbs, s.p[3]);
  put_a(g, s.sq[2], u);
  __syncwarp(g.mask);
  const auto c = mul_part(g, s.sq[2], s.p[2]);  // (t1 2d) t2
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
  bool ok = true;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int64_t* src = pts + i * kPointLimbs + c * kLimbs + g.k0;
#pragma unroll
    for (int r = 0; r < L; ++r) {
      const long long v = __ldg(src + r);
      ok &= loose(v);
      p.c[c].v[r] = (int32_t)v;
    }
  }
  if (!ok) *bad = 1;
  put_b(g, s.p[0], sub_part(g, p.c[1], p.c[0]));
  put_b(g, s.p[1], add_part(g, p.c[1], p.c[0]));
  put_b(g, s.p[2], p.c[3]);
  put_b(g, s.p[3], p.c[2]);

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
      if ((word >> b) & 1u) msm_add(g, s, d2, acc);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int64_t* dst = out + i * kPointLimbs + c * kLimbs + g.k0;
#pragma unroll
    for (int r = 0; r < L; ++r) dst[r] = acc.c[c].v[r];
  }
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
