// Krum scores on Hopper (sm_90a): the hand-written counterpart of the TPU
// kernel biscotti_tpu/ops/krum_pallas.py::_krum_kernel (with
// _select_kth_and_sum).
//
// For each row i of x[n, d] (fp32, row-major):
//   D_ij    = max(sq_i + sq_j - 2 x_i.x_j, 0),  D_ii = +inf
//   t_i     = the exact k-th smallest D_ij of the row
//   score_i = sum(D_ij < t_i) + (k - count(D_ij < t_i)) * t_i
// which is the sum of the k = n - f - 2 smallest off-diagonal distances, ties
// at the threshold counted as a sorted prefix would count them.
//
// Bound. D is symmetric, so the scores need the n(n-1)/2 distinct
// off-diagonal dot products, n(n-1)*d fp32 operations (4.02 GFLOP at n=716,
// d=7850; 132 GFLOP at n=4096), against 4*n*d bytes of input (22.5 MB at
// n=716), far above the card's fp32 operations-per-byte balance: the work
// is bound by fp32 FMAs, not by memory. This kernel computes both halves of
// the Gram matrix (2*n^2*d operations), twice the bound's work. TF32 is not
// used; the products accumulate in fp32 registers, as the reference's do.
//
// Design. The TPU kernel keeps a (128, n_pad) fp32 Gram stripe in VMEM
// (2 MiB at n=4096); one H100 block has at most 227 KB of shared memory. So
// a block here owns only R rows (R = 4, or 8 from n = 1056 on, so that the
// main path's n = 716 still launches 179 blocks for 132 SMs) and keeps their
// R x n distance stripe in dynamic shared memory (128 KB at R = 8, n = 4096).
// The block walks column tiles of 256 rows of x. For each tile it streams
// 32-wide feature chunks of its R rows and of the tile's rows through shared
// memory, the next chunk prefetched into registers while the current one is
// multiplied; each thread owns one column and accumulates its R dot products
// in registers. The tile's distances go into the stripe. Then one warp per
// row finds the row's exact k-th smallest distance by the reference's 31-step
// bisection on the float bit pattern (non-negative floats order like their
// bits), counting with warp reductions, and forms the score. Each element of
// x is read from L2 n/R times; tensor-core Gram tiles (wgmma, TMA) are a
// later refinement.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // one stripe column per thread
constexpr int kTileCols = kThreads;      // rows of x per column tile
constexpr int kChunk = 32;               // features per shared-memory chunk
constexpr int kTilePitch = kTileCols + 1;  // padded: conflict-free transpose
constexpr int kLoadsPerThread = kTileCols * kChunk / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kBits = 31;                // sign bit of a distance is never set
constexpr int kMaxSmem = 232448;         // opt-in shared memory of one block

template <int R>
size_t smem_bytes(int n) {
  return sizeof(float) * ((size_t)R * n + (size_t)kChunk * kTilePitch +
                          (size_t)kChunk * R);
}

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(0xffffffffu, v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
krum_scores_kernel(const float* __restrict__ x, const float* __restrict__ sq,
                   float* __restrict__ out, int n, int d, int k) {
  static_assert(R * kChunk <= kThreads, "one row-chunk element per thread");
  extern __shared__ float smem[];
  float* stripe = smem;                                 // [R][n]
  float* xj_s = stripe + (size_t)R * n;                 // [kChunk][kTilePitch]
  float* xi_s = xj_s + kChunk * kTilePitch;             // [kChunk][R]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * R;
  const int nchunks = (d + kChunk - 1) / kChunk;

  // this thread's share of one chunk: one element of the block's R rows
  // (threads below R*kChunk) and kLoadsPerThread elements of the tile
  const int ri = tid / kChunk, fi = tid % kChunk;
  const bool loads_row = tid < R * kChunk;
  const int row_i = row0 + ri;

  for (int col0 = 0; col0 < n; col0 += kTileCols) {
    float pre_i = 0.f;
    float pre_j[kLoadsPerThread];

    auto fetch = [&](int c) {
      const int f = c * kChunk + lane;
      pre_i = 0.f;
      if (loads_row) {
        const int fr = c * kChunk + fi;
        if (row_i < n && fr < d) pre_i = x[(size_t)row_i * d + fr];
      }
#pragma unroll
      for (int t = 0; t < kLoadsPerThread; ++t) {
        const int j = col0 + warp + kWarps * t;
        pre_j[t] = (j < n && f < d) ? x[(size_t)j * d + f] : 0.f;
      }
    };
    auto stash = [&]() {
      if (loads_row) xi_s[fi * R + ri] = pre_i;
#pragma unroll
      for (int t = 0; t < kLoadsPerThread; ++t)
        xj_s[lane * kTilePitch + warp + kWarps * t] = pre_j[t];
    };

    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;

    fetch(0);
    stash();
    __syncthreads();
    for (int c = 0; c < nchunks; ++c) {
      if (c + 1 < nchunks) fetch(c + 1);  // in flight during the products
#pragma unroll 8
      for (int kk = 0; kk < kChunk; ++kk) {
        const float xj = xj_s[kk * kTilePitch + tid];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(xi_s[kk * R + r], xj, acc[r]);
      }
      __syncthreads();
      if (c + 1 < nchunks) {
        stash();
        __syncthreads();
      }
    }

    const int j = col0 + tid;
    if (j < n) {
      const float sqj = sq[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = row0 + r;
        if (i >= n) break;
        const float v = (sq[i] + sqj) - 2.f * acc[r];
        // clamp fp cancellation noise; (v > 0) also maps -0 to +0, whose
        // bits would otherwise order above every distance
        stripe[r * n + j] = (i == j) ? INFINITY : (v > 0.f ? v : 0.f);
      }
    }
  }
  __syncthreads();

  // exact k-th smallest per row by bisection on the bit pattern, one warp
  // per row (the reference's _select_kth_and_sum)
  for (int r = warp; r < R; r += kWarps) {
    const int i = row0 + r;
    if (i >= n) break;
    const float* drow = stripe + (size_t)r * n;
    unsigned ans = 0;
    for (int t = 0; t < kBits; ++t) {
      const unsigned cand = ans | (1u << (kBits - 1 - t));
      int cnt = 0;
      for (int jj = lane; jj < n; jj += 32) cnt += __float_as_uint(drow[jj]) < cand;
      // count(D < cand) >= k means the k-th smallest is below cand
      if (warp_sum(cnt) < k) ans = cand;
    }
    int cnt = 0;
    float sum = 0.f;
    for (int jj = lane; jj < n; jj += 32) {
      const float v = drow[jj];
      if (__float_as_uint(v) < ans) {
        ++cnt;
        sum += v;
      }
    }
    cnt = warp_sum(cnt);
    sum = warp_sum(sum);
    if (lane == 0) out[i] = sum + (float)(k - cnt) * __uint_as_float(ans);
  }
}

template <int R>
cudaError_t launch(const float* x, const float* sq, float* out, int n, int d,
                   int k, cudaStream_t stream) {
  const size_t smem = smem_bytes<R>(n);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      krum_scores_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + R - 1) / R;
  krum_scores_kernel<R><<<blocks, kThreads, smem, stream>>>(x, sq, out, n, d, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Krum scores of x[n, d] into out[n]; sq[n] holds the rows' squared norms.
// 0 < k < n. Launches on `stream` and does not synchronise. Returns the
// cudaError_t of the launch (0 on success).
int krum_scores_f32(const float* x, const float* sq, float* out, int n, int d,
                    int k, void* stream) {
  if (n <= 0 || d <= 0 || k <= 0 || k >= n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n >= 8 * 132) return (int)launch<8>(x, sq, out, n, d, k, s);
  return (int)launch<4>(x, sq, out, n, d, k, s);
}

const char* krum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
