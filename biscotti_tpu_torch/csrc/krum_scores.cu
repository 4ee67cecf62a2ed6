// Krum scores on Hopper (sm_90a): the hand-written counterpart of the TPU
// kernel biscotti_tpu/ops/krum_pallas.py::_krum_kernel (with
// _select_kth_and_sum).
//
// For each row i of x[n, d] (fp32, row-major):
//   D_ij    = max(sq_i + sq_j - 2 x_i.x_j, 0),  D_ii = +inf
//   t_i     = the exact k-th smallest D_ij of the row
//   score_i = sum(D_ij < t_i) + (k - count(D_ij < t_i)) * t_i
// which is the sum of the k = n - f - 2 smallest off-diagonal distances, ties
// at the threshold counted as a sorted prefix would count them. sq holds the
// rows' fp32 sums of squares, computed by the caller as the reference
// computes them outside its kernel.
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
//    k-tile). A row of x at d = 7850 is 31,400 bytes, not a multiple of 16,
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
//    epilogue forms D = (sq_i + sq_j) - 2G, clamped by (v > 0), which also
//    maps -0 to +0 (whose bits would order above every distance), with the
//    diagonal at +inf, and stores D[I, J] and, for an off-diagonal tile, its
//    transpose D[J, I] from registers as float4 (every 32-byte sector
//    written whole) into an [n, n_pad] buffer. Columns past n are never
//    read.
// 3. krum_select_kernel: one warp a row stages the row of D in shared
//    memory (columns past n read as +inf, as the reference masks its
//    padding), finds the exact k-th smallest by the reference's 31-step
//    bisection on the float bit pattern (non-negative floats order like
//    their bits), counting with warp reductions, and forms the score.
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
constexpr int kBits = 31;                   // sign bit of a distance is never set
constexpr int kMaxSmem = 232448;            // opt-in shared memory of one block
static_assert(kLoads * kThreads * 4 == kTile * kK, "whole float4 a thread");

__device__ __forceinline__ float distance(const float* __restrict__ sq, int n,
                                          int i, int j, float g) {
  if (i == j) return INFINITY;
  if (j >= n) return 0.f;  // column padding: never read
  // (sq_i + sq_j) - 2g in the plain version's order; 2g is exact, so a
  // contraction into one fma rounds the same
  const float v = (sq[i] + sq[j]) - 2.f * g;
  return v > 0.f ? v : 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x[n, d] -> xp[n_pad, d_pad], one block a padded row; block 0 also zeroes
// the split-K counters (null when the Gram is not split)
__global__ void __launch_bounds__(kPadThreads)
krum_pad_kernel(const float* __restrict__ x, float* __restrict__ xp,
                int* __restrict__ counters, int n_counters, int n, int d,
                int d_pad) {
  const int row = blockIdx.x;
  if (row == 0 && counters != nullptr)
    for (int t = threadIdx.x; t < n_counters; t += blockDim.x) counters[t] = 0;
  float4* dst = reinterpret_cast<float4*>(xp + (size_t)row * d_pad);
  for (int q = threadIdx.x; q < d_pad / 4; q += blockDim.x) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * q + e;
      v[e] = (row < n && c < d) ? x[(size_t)row * d + c] : 0.f;
    }
    dst[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// one upper Gram tile (I <= J), one split of d; grid (tiles, splits)
__global__ void __launch_bounds__(kThreads, 2)
krum_gram_kernel(const float* __restrict__ xp, const float* __restrict__ sq,
                 float* __restrict__ dist, float* __restrict__ partials,
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
      *reinterpret_cast<float4*>(dist + (size_t)i * n_pad + j) = make_float4(
          distance(sq, n, i, j, acc[u][4 * h]),
          distance(sq, n, i, j + 1, acc[u][4 * h + 1]),
          distance(sq, n, i, j + 2, acc[u][4 * h + 2]),
          distance(sq, n, i, j + 3, acc[u][4 * h + 3]));
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
      *reinterpret_cast<float4*>(dist + (size_t)i * n_pad + j) = make_float4(
          distance(sq, n, i, j, acc[4 * h][v]),
          distance(sq, n, i, j + 1, acc[4 * h + 1][v]),
          distance(sq, n, i, j + 2, acc[4 * h + 2][v]),
          distance(sq, n, i, j + 3, acc[4 * h + 3][v]));
    }
  }
}

// exact k-th smallest of each row of D by bisection on the bit pattern, one
// warp a row (the reference's _select_kth_and_sum), and the row's score
__global__ void __launch_bounds__(kSelWarps * 32)
krum_select_kernel(const float* __restrict__ dist, float* __restrict__ out,
                   int n, int ldd, int k) {
  extern __shared__ float4 rows[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kSelWarps + warp;
  if (i >= n) return;
  const int q4 = ldd / 4;
  float4* row = rows + (size_t)warp * q4;
  const float4* src = reinterpret_cast<const float4*>(dist + (size_t)i * ldd);
  for (int q = lane; q < q4; q += 32) {
    float4 v = src[q];
    const int j = 4 * q;
    if (j >= n) v.x = INFINITY;  // padding, never written, as +inf
    if (j + 1 >= n) v.y = INFINITY;
    if (j + 2 >= n) v.z = INFINITY;
    if (j + 3 >= n) v.w = INFINITY;
    row[q] = v;
  }
  __syncwarp();

  unsigned ans = 0;
  for (int t = 0; t < kBits; ++t) {
    const unsigned cand = ans | (1u << (kBits - 1 - t));
    int cnt = 0;
    for (int q = lane; q < q4; q += 32) {
      const float4 v = row[q];
      cnt += (__float_as_uint(v.x) < cand) + (__float_as_uint(v.y) < cand) +
             (__float_as_uint(v.z) < cand) + (__float_as_uint(v.w) < cand);
    }
    // count(D < cand) >= k means the k-th smallest is below cand
    if (__reduce_add_sync(0xffffffffu, cnt) < k) ans = cand;
  }
  int cnt = 0;
  float sum = 0.f;
  for (int q = lane; q < q4; q += 32) {
    const float4 v = row[q];
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (__float_as_uint(e[c]) < ans) {
        ++cnt;
        sum += e[c];
      }
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  sum = warp_sum(sum);
  if (lane == 0) out[i] = sum + (float)(k - cnt) * __uint_as_float(ans);
}

}  // namespace

extern "C" {

// Krum scores of x[n, d] into out[n]; sq[n] holds the rows' squared norms.
// Scratch, allocated by the caller: xp [n_pad, d_pad]; dist [n, n_pad]; with
// splits > 1, partials [tiles * splits * 128 * 128] and counters [tiles],
// tiles = T (T + 1) / 2 for T = n_pad / 128 (both may be null when
// splits == 1). n_pad is a multiple of 128, d_pad of 16, 1 <= splits <=
// d_pad / 16, 0 < k < n. Launches three kernels on `stream`, does not
// synchronise, allocates nothing. Returns the cudaError_t of the launches
// (0 on success).
int krum_scores_f32(const float* x, const float* sq, float* out, float* xp,
                    float* dist, float* partials, int* counters, int n, int d,
                    int n_pad, int d_pad, int splits, int k, void* stream) {
  if (n <= 0 || d <= 0 || k <= 0 || k >= n || n_pad < n || n_pad % kTile ||
      d_pad < d || d_pad % kK || splits < 1 || splits > d_pad / kK)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (partials == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t sel_smem = (size_t)kSelWarps * n_pad * sizeof(float);
  if (sel_smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = n_pad / kTile;
  const int tiles = T * (T + 1) / 2;

  krum_pad_kernel<<<n_pad, kPadThreads, 0, s>>>(
      x, xp, splits > 1 ? counters : nullptr, tiles, n, d, d_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  krum_gram_kernel<<<dim3(tiles, splits), kThreads, 0, s>>>(
      xp, sq, dist, partials, counters, n, n_pad, d_pad, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(krum_select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sel_smem);
  if (err != cudaSuccess) return (int)err;
  krum_select_kernel<<<(n + kSelWarps - 1) / kSelWarps, kSelWarps * 32,
                       sel_smem, s>>>(dist, out, n, n_pad, k);
  return (int)cudaGetLastError();
}

const char* krum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
