// Krum scores on Hopper (sm_90a): the hand-written counterpart of the TPU
// kernel biscotti_tpu/ops/krum_pallas.py::_krum_kernel (with
// _select_kth_and_sum).
//
// For each row i of x[n, d] (fp32, row-major):
//   D_ij    = max(fma(-2, x_i.x_j, sq_i + sq_j), 0),  plus +inf when i = j
//   t_i     = the exact k-th smallest D_ij of the row
//   score_i = sum(D_ij < t_i) + (k - count(D_ij < t_i)) * t_i
// which is the sum of the k = n - f - 2 smallest off-diagonal distances, ties
// at the threshold counted as a sorted prefix would count them. sq holds the
// rows' fp32 sums of squares, computed by the caller as the reference
// computes them outside its kernel.
//
// Non-finite rows follow the plain version's rule (ops/krum.py docstring),
// never the card's NaN bits (inf - inf is 0x7fffffff here, 0xffc00000 on
// the CPU the reference ran on). The epilogue stores each D_ij as a 31-bit
// order key: a NaN from a row with a NaN input (sq_i or sq_j NaN) ranks
// after +inf, any other NaN below every distance, a number v >= 0 as its
// bits + 1, and column padding last. The select bisects on those keys; a
// row whose k nearest hold a generated NaN scores 0xffc00000, one whose
// k-th nearest is a propagated NaN 0x7fc00000, as the plain version does.
//
// Subnormals follow the plain version's flush-to-zero rule (ops/krum.py
// docstring), not the card's IEEE arithmetic: the pre-pass stores inputs
// with |x| < FLT_MIN as 0 and each row's max |x|; the epilogue takes G_ij
// as 0 where max|x_i| * max|x_j| < FLT_MIN or G_ij is subnormal, and a
// subnormal D_ij as 0. sq comes from the caller with its subnormal
// products flushed.
//
// Bound, by pipe. D is symmetric, so the scores need the n(n-1)/2 distinct
// off-diagonal dot products: n(n-1)*d operations, against 4*(n*d + n) bytes
// read and written (22.5 MB, 0.0067 ms at n = 716, d = 7850). On the fp32
// FMA pipe, which this kernel uses (67 TFLOP/s): 0.0600 ms at (716, 7850),
// 1.965 ms at (4096, 7850). A 3xTF32 Gram on the tensor pipe would need
// 3*n(n-1)*d at 495 TFLOP/s: 0.0244 and 0.798 ms. The work is bound by
// operations either way.
//
// Why not the tensor cores. A 3xTF32 mainloop (hi = tf32(x), lo = tf32(x -
// hi), acc += lo.hi + hi.lo + hi.hi with mma.sync.m16n8k8) matched the
// plain version to 1.9e-7 on random rows, but on rows that share one large
// mean (x = 0.05 randn + a common row, D ~ 39 next to |x|^2 ~ 7850) its
// scores were 6.1e-3 off, a single TF32 pass's error: the tensor cores add
// each product into the fp32 accumulator with truncation, and when every
// product is positive and the accumulator large, the lost bits add up in
// one direction (~0.1 of a Gram entry of 7850 here). The accept boundary's
// gap there is 4e-5 to 5e-5. So the Gram runs on the fp32 FMA pipe, which
// rounds each step to nearest as the plain version's matmul does.
//
// Design. Three kernels on the caller's stream, in order:
//
// 1. krum_pad_kernel copies x once into a zero-padded [n_pad, d_pad]
//    buffer (n_pad a multiple of the 128-row tile, d_pad of the 16-feature
//    k-tile), subnormal inputs as 0, and each row's max |x| into amax. A row of x at d = 7850 is 31,400 bytes, not a multiple of 16,
//    so 16-byte loads could not read x in place; zero padding leaves
//    products and norms exact. It also zeroes the split-K arrival counters.
// 2. krum_gram_kernel computes the Gram tiles G[I, J] = X_I . X_J^T of the
//    upper triangle I <= J only (the bound's n(n-1)*d work, not twice it),
//    128 x 128 a block of 256 threads, each thread 8 x 8 outputs in
//    registers (rows ty*4 + {0..3, 64..67}, columns tx*4 + {0..3, 64..67}):
//    per feature, 4 float4 shared-memory loads feed 64 FMAs. The k-tiles
//    pass through two shared-memory buffers, stored feature-major
//    (transposed) so the 4 rows or columns a thread needs are one float4;
//    the next k-tile's global loads are in flight in registers while the
//    current one is multiplied. A diagonal tile loads one side. When the
//    upper tiles alone cannot fill the card (21 tiles at n = 716 for 132
//    SMs), the wrapper splits d across `splits` blocks a tile; each writes
//    its partial tile to a workspace and bumps the tile's integer counter,
//    and the last to arrive sums the partials in split order 0, 1, ..., so
//    the scores are bit-identical from call to call: no float atomics. The
//    epilogue forms D = fma(-2, G, sq_i + sq_j) (one rounding, as the
//    reference's fused expression), clamped by (v > 0), which also maps -0
//    to +0 (whose bits would order above every distance), plus +inf on the
//    diagonal, and stores the order keys of D[I, J] and, for an
//    off-diagonal tile, of its transpose D[J, I] from registers as uint4
//    (every 32-byte sector written whole) into an [n, n_pad] buffer.
// 3. krum_select_kernel: one warp a row stages the row's keys in shared
//    memory (columns past n as the padding key, as the reference masks its
//    padding), finds the exact k-th smallest by the reference's 31-step
//    bisection (the keys are below 2^31), counting with warp reductions,
//    and forms the score from the keys' values.
//
// What this design does about the four causes that held back the first
// port of this kernel (one block a few rows, streaming all of x past them
// through shared memory, R + 1 scalar loads per R FMAs): a block reads its
// two 128-row stripes of x once, so x crosses L2 about n/128 times, not
// n/R; shared-memory issue falls to 4 float4 loads per 64 FMAs; symmetry
// halves the products; the tensor pipe is not used, for the accuracy above.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;                  // rows of a Gram tile, each side
constexpr int kK = 16;                      // features of a k-tile
constexpr int kThreads = 256;               // 16 x 16, 8 x 8 outputs each
constexpr int kPitch = kTile + 4;           // floats a feature row of a buffer
constexpr int kOperand = kK * kPitch;       // floats of one operand k-tile
constexpr int kLoads = kTile * kK / 4 / kThreads;  // float4 a thread an operand
constexpr int kPadThreads = 256;
constexpr int kSelWarps = 4;                // rows of D a select block
constexpr int kBits = 31;                   // every order key is below 2^31
// order keys of a distance (see the head comment)
constexpr unsigned kKeyNearNaN = 0u;           // NaN with no NaN input: nearest
constexpr unsigned kKeyFarNaN = 0x7fc00001u;   // NaN a NaN input propagated
constexpr unsigned kKeyPad = 0x7fffffffu;      // column padding: never selected
constexpr unsigned kScoreNearNaN = 0xffc00000u;
constexpr unsigned kScoreFarNaN = 0x7fc00000u;
constexpr int kMaxSmem = 232448;            // opt-in shared memory of one block
constexpr float kFltMin = 1.17549435e-38f;  // the least normal float32
static_assert(kLoads * kThreads * 4 == kTile * kK, "whole float4 a thread");

__device__ __forceinline__ unsigned distance(const float* __restrict__ sq,
                                             const float* __restrict__ amax,
                                             int n, int i, int j, float g) {
  if (j >= n) return kKeyPad;
  const float si = sq[i], sj = sq[j];
  if (isnan(si) || isnan(sj)) return kKeyFarNaN;
  // flush-to-zero: an entry of subnormal products only, or a subnormal
  // sum, is 0 (a NaN product of the maxima compares false and keeps g)
  if (amax[i] * amax[j] < kFltMin || fabsf(g) < kFltMin) g = 0.f;
  // (sq_i + sq_j) - 2g in one rounding, as the plain version forms it;
  // only where 2g overflows does it differ from two roundings
  float v = fmaf(-2.f, g, si + sj);
  if (isnan(v)) return kKeyNearNaN;
  v = v >= kFltMin ? v : 0.f;  // negatives, -0 and subnormals to +0
  if (i == j) v += INFINITY;  // the reference adds +inf to the diagonal
  return __float_as_uint(v) + 1u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x[n, d] -> xp[n_pad, d_pad] with subnormal inputs as 0, and the row's
// max |x| into amax[row] (NaN if the row holds one, as torch's amax), one
// block a padded row; block 0 also zeroes the split-K counters (null when
// the Gram is not split)
__global__ void __launch_bounds__(kPadThreads)
krum_pad_kernel(const float* __restrict__ x, float* __restrict__ xp,
                float* __restrict__ amax, int* __restrict__ counters,
                int n_counters, int n, int d, int d_pad) {
  __shared__ float warp_max[kPadThreads / 32];
  const int row = blockIdx.x;
  if (row == 0 && counters != nullptr)
    for (int t = threadIdx.x; t < n_counters; t += blockDim.x) counters[t] = 0;
  float4* dst = reinterpret_cast<float4*>(xp + (size_t)row * d_pad);
  float m = 0.f;
  bool nan = false;
  for (int q = threadIdx.x; q < d_pad / 4; q += blockDim.x) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * q + e;
      const float a = (row < n && c < d) ? x[(size_t)row * d + c] : 0.f;
      v[e] = fabsf(a) < kFltMin ? 0.f : a;  // DAZ; NaN compares false
      nan |= isnan(v[e]);
      m = fmaxf(m, fabsf(v[e]));  // fmaxf drops a NaN: counted apart
    }
    dst[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  nan = __any_sync(0xffffffffu, nan);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = nan ? NAN : m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = 0.f;
    bool any_nan = false;
    for (int w = 0; w < kPadThreads / 32; ++w) {
      any_nan |= isnan(warp_max[w]);
      r = fmaxf(r, warp_max[w]);
    }
    amax[row] = any_nan ? NAN : r;
  }
}

// one upper Gram tile (I <= J), one split of d; grid (tiles, splits)
__global__ void __launch_bounds__(kThreads, 2)
krum_gram_kernel(const float* __restrict__ xp, const float* __restrict__ sq,
                 const float* __restrict__ amax, unsigned* __restrict__ dist, float* __restrict__ partials,
                 int* __restrict__ counters, int n, int n_pad, int d_pad,
                 int splits) {
  // two buffers of two operands, each [kK][kPitch], feature-major
  __shared__ __align__(16) float smem[2 * 2 * kOperand];
  __shared__ int last_arrival;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // upper-triangle tile index -> (I, J), row by row
  const int T = n_pad / kTile;
  int I = 0, rem = blockIdx.x;
  while (rem >= T - I) {
    rem -= T - I;
    ++I;
  }
  const int J = I + rem;
  const bool diag = I == J;
  const int split = blockIdx.y;
  const int kt_all = d_pad / kK;
  const int kt0 = (int)((long long)split * kt_all / splits);
  const int nk = (int)((long long)(split + 1) * kt_all / splits) - kt0;

  // this thread's float4s of a k-tile: row e / 4, features (e % 4) * 4 + 0..3
  const float* a_src = xp + (size_t)I * kTile * d_pad;
  const float* b_src = xp + (size_t)J * kTile * d_pad;
  float4 pa[kLoads], pb[kLoads];
  auto fetch = [&](int kt) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int e = tid + q * kThreads;
      const size_t off = (size_t)(e >> 2) * d_pad + (size_t)kt * kK + (e & 3) * 4;
      pa[q] = *reinterpret_cast<const float4*>(a_src + off);
      if (!diag) pb[q] = *reinterpret_cast<const float4*>(b_src + off);
    }
  };
  auto stash = [&](int buf) {
    float* a = smem + buf * 2 * kOperand;
    float* b = a + kOperand;
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int e = tid + q * kThreads;
      const int r = e >> 2, f = (e & 3) * 4;
      a[(f + 0) * kPitch + r] = pa[q].x;
      a[(f + 1) * kPitch + r] = pa[q].y;
      a[(f + 2) * kPitch + r] = pa[q].z;
      a[(f + 3) * kPitch + r] = pa[q].w;
      if (!diag) {
        b[(f + 0) * kPitch + r] = pb[q].x;
        b[(f + 1) * kPitch + r] = pb[q].y;
        b[(f + 2) * kPitch + r] = pb[q].z;
        b[(f + 3) * kPitch + r] = pb[q].w;
      }
    }
  };

  float acc[8][8] = {};
  fetch(kt0);
  stash(0);
  __syncthreads();
  for (int it = 0; it < nk; ++it) {
    const int buf = it & 1;
    if (it + 1 < nk) fetch(kt0 + it + 1);  // in flight during the products
    const float* a = smem + buf * 2 * kOperand;
    const float* b = diag ? a : a + kOperand;
#pragma unroll
    for (int f = 0; f < kK; ++f) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + f * kPitch + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a + f * kPitch + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b + f * kPitch + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(b + f * kPitch + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    if (it + 1 < nk) stash(buf ^ 1);  // the other buffer: read last iteration
    __syncthreads();
  }

  // tile coordinates of acc[u][v]: row rt(u), column ct(v)
  auto rt = [&](int u) { return (u < 4 ? 0 : 64 - 4) + ty * 4 + u; };
  auto ct = [&](int v) { return (v < 4 ? 0 : 64 - 4) + tx * 4 + v; };

  if (splits > 1) {
    // write this split's partial; the last block of the tile to arrive
    // sums all of them in split order
    float* part = partials + (size_t)blockIdx.x * splits * kTile * kTile;
    float* mine = part + (size_t)split * kTile * kTile;
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(mine + rt(u) * kTile + ct(4 * h)) =
            make_float4(acc[u][4 * h], acc[u][4 * h + 1], acc[u][4 * h + 2],
                        acc[u][4 * h + 3]);
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last_arrival = atomicAdd(counters + blockIdx.x, 1) == splits - 1;
    __syncthreads();
    if (!last_arrival) return;
    __threadfence();
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t off = rt(u) * kTile + ct(4 * h);
        float4 s = __ldcg(reinterpret_cast<const float4*>(part + off));
        for (int p = 1; p < splits; ++p) {
          const float4 t = __ldcg(
              reinterpret_cast<const float4*>(part + (size_t)p * kTile * kTile + off));
          s.x += t.x;
          s.y += t.y;
          s.z += t.z;
          s.w += t.w;
        }
        acc[u][4 * h] = s.x;
        acc[u][4 * h + 1] = s.y;
        acc[u][4 * h + 2] = s.z;
        acc[u][4 * h + 3] = s.w;
      }
  }

  const int i0 = I * kTile, j0 = J * kTile;
#pragma unroll
  for (int u = 0; u < 8; ++u) {  // D[I, J]: rows of the tile
    const int i = i0 + rt(u);
    if (i >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + ct(4 * h);
      *reinterpret_cast<uint4*>(dist + (size_t)i * n_pad + j) = make_uint4(
          distance(sq, amax, n, i, j, acc[u][4 * h]),
          distance(sq, amax, n, i, j + 1, acc[u][4 * h + 1]),
          distance(sq, amax, n, i, j + 2, acc[u][4 * h + 2]),
          distance(sq, amax, n, i, j + 3, acc[u][4 * h + 3]));
    }
  }
  if (diag) return;
#pragma unroll
  for (int v = 0; v < 8; ++v) {  // D[J, I] = D[I, J]^T: columns of the tile
    const int i = j0 + ct(v);
    if (i >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = i0 + rt(4 * h);
      *reinterpret_cast<uint4*>(dist + (size_t)i * n_pad + j) = make_uint4(
          distance(sq, amax, n, i, j, acc[4 * h][v]),
          distance(sq, amax, n, i, j + 1, acc[4 * h + 1][v]),
          distance(sq, amax, n, i, j + 2, acc[4 * h + 2][v]),
          distance(sq, amax, n, i, j + 3, acc[4 * h + 3][v]));
    }
  }
}

// exact k-th smallest of each row's order keys by bisection, one warp a row
// (the reference's _select_kth_and_sum), and the row's score
__global__ void __launch_bounds__(kSelWarps * 32)
krum_select_kernel(const unsigned* __restrict__ dist, float* __restrict__ out,
                   int n, int ldd, int k) {
  extern __shared__ uint4 rows[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kSelWarps + warp;
  if (i >= n) return;
  const int q4 = ldd / 4;
  uint4* row = rows + (size_t)warp * q4;
  const uint4* src = reinterpret_cast<const uint4*>(dist + (size_t)i * ldd);
  for (int q = lane; q < q4; q += 32) {
    uint4 v = src[q];
    const int j = 4 * q;
    if (j >= n) v.x = kKeyPad;
    if (j + 1 >= n) v.y = kKeyPad;
    if (j + 2 >= n) v.z = kKeyPad;
    if (j + 3 >= n) v.w = kKeyPad;
    row[q] = v;
  }
  __syncwarp();

  unsigned ans = 0;
  for (int t = 0; t < kBits; ++t) {
    const unsigned cand = ans | (1u << (kBits - 1 - t));
    int cnt = 0;
    for (int q = lane; q < q4; q += 32) {
      const uint4 v = row[q];
      cnt += (v.x < cand) + (v.y < cand) + (v.z < cand) + (v.w < cand);
    }
    // count(key < cand) >= k means the k-th smallest is below cand
    if (__reduce_add_sync(0xffffffffu, cnt) < k) ans = cand;
  }
  int cnt = 0, near_nan = 0;
  float sum = 0.f;
  for (int q = lane; q < q4; q += 32) {
    const uint4 v = row[q];
    const unsigned e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      near_nan |= e[c] == kKeyNearNaN;
      if (e[c] != kKeyNearNaN && e[c] < ans) {  // a number below the k-th
        ++cnt;
        sum += __uint_as_float(e[c] - 1u);
      }
    }
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  near_nan = __any_sync(0xffffffffu, near_nan);
  sum = warp_sum(sum);
  if (lane != 0) return;
  // a generated NaN is always among the k nearest; a propagated one counts
  // only as the k-th (every NaN is after it)
  if (near_nan)
    out[i] = __uint_as_float(kScoreNearNaN);
  else if (ans == kKeyFarNaN)
    out[i] = __uint_as_float(kScoreFarNaN);
  else
    out[i] = sum + (float)(k - cnt) * __uint_as_float(ans - 1u);
}

}  // namespace

extern "C" {

// Krum scores of x[n, d] into out[n]; sq[n] holds the rows' squared norms
// (subnormal products flushed). Scratch, allocated by the caller: xp
// [n_pad, d_pad]; amax [n_pad]; dist [n, n_pad] (4 bytes an entry, the
// order keys of D); with
// splits > 1, partials [tiles * splits * 128 * 128] and counters [tiles],
// tiles = T (T + 1) / 2 for T = n_pad / 128 (both may be null when
// splits == 1). n_pad is a multiple of 128, d_pad of 16, 1 <= splits <=
// d_pad / 16, 0 < k < n. Launches three kernels on `stream`, does not
// synchronise, allocates nothing. Returns the cudaError_t of the launches
// (0 on success).
int krum_scores_f32(const float* x, const float* sq, float* out, float* xp,
                    float* amax, float* dist, float* partials, int* counters, int n, int d,
                    int n_pad, int d_pad, int splits, int k, void* stream) {
  if (n <= 0 || d <= 0 || k <= 0 || k >= n || n_pad < n || n_pad % kTile ||
      d_pad < d || d_pad % kK || splits < 1 || splits > d_pad / kK)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (partials == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t sel_smem = (size_t)kSelWarps * n_pad * sizeof(unsigned);
  if (sel_smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = n_pad / kTile;
  const int tiles = T * (T + 1) / 2;

  krum_pad_kernel<<<n_pad, kPadThreads, 0, s>>>(
      x, xp, amax, splits > 1 ? counters : nullptr, tiles, n, d, d_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  unsigned* keys = reinterpret_cast<unsigned*>(dist);
  krum_gram_kernel<<<dim3(tiles, splits), kThreads, 0, s>>>(
      xp, sq, amax, keys, partials, counters, n, n_pad, d_pad, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(krum_select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sel_smem);
  if (err != cudaSuccess) return (int)err;
  krum_select_kernel<<<(n + kSelWarps - 1) / kSelWarps, kSelWarps * 32,
                       sel_smem, s>>>(keys, out, n, n_pad, k);
  return (int)cudaGetLastError();
}

const char* krum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
