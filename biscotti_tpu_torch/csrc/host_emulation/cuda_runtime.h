// A host emulation of what csrc/ed25519_ladder.cu takes from the CUDA
// runtime, so that g++ can compile the kernels and run them on the CPU, one
// std::thread a CUDA thread (tools/ladder_emulation.py builds it). Blocks
// run one after another; a block's threads run at once. __syncthreads,
// __syncwarp and __shfl_sync are barriers among the threads they name,
// __shared__ variables are function statics (one block at a time), dynamic
// shared memory is a buffer a block, filled with 0xA5 so that a read
// before a write shows, and a launch that asks for more than 48 KB of it
// fails unless cudaFuncSetAttribute allowed that kernel as much. A barrier
// that waits 60 s aborts: a thread that skips a barrier the others reach
// is a fault of the kernel. It checks indices, barriers, shuffles and
// launches, not what nvcc accepts for sm_90a.
#pragma once

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
struct alignas(16) longlong2 {
  long long x, y;
};
struct alignas(16) int4 {
  int x, y, z, w;
};
struct alignas(8) int2 {
  int x, y;
};
inline longlong2 make_longlong2(long long x, long long y) { return {x, y}; }
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
inline int2 make_int2(int x, int y) { return {x, y}; }

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

namespace emu {

class Barrier {
 public:
  explicit Barrier(int count) : count_(count) {}
  void wait() {
    std::unique_lock<std::mutex> lk(m_);
    const long gen = gen_;
    if (++waiting_ == count_) {
      release();
      return;
    }
    if (!cv_.wait_for(lk, std::chrono::seconds(60),
                      [&] { return gen_ != gen; })) {
      std::fprintf(stderr, "emulation: a barrier of %d threads waited 60 s "
                   "with %d arrived\n", count_, waiting_);
      std::abort();
    }
  }
  // a thread that exits no longer holds the others back
  void leave() {
    std::lock_guard<std::mutex> lk(m_);
    --count_;
    if (waiting_ > 0 && waiting_ == count_) release();
  }

 private:
  void release() {
    waiting_ = 0;
    ++gen_;
    cv_.notify_all();
  }
  std::mutex m_;
  std::condition_variable cv_;
  int count_, waiting_ = 0;
  long gen_ = 0;
};

struct Block {
  explicit Block(unsigned threads, size_t smem)
      : all(threads), dynamic(smem + 16, 0xA5), slots((threads + 31) / 32) {}
  Barrier all;
  std::vector<unsigned char> dynamic;
  std::mutex m;
  std::map<std::pair<unsigned, unsigned>, std::unique_ptr<Barrier>> warps;
  std::vector<std::vector<int64_t>> slots;  // a warp's shuffle values
  Barrier& warp(unsigned w, unsigned mask) {
    std::lock_guard<std::mutex> lk(m);
    auto& b = warps[{w, mask}];
    if (!b) b.reset(new Barrier(__builtin_popcount(mask)));
    return *b;
  }
};

inline thread_local dim3 thread_idx, block_idx, block_dim, grid_dim;
inline thread_local Block* block = nullptr;
inline cudaError_t last_error = cudaSuccess;
// the dynamic shared memory each kernel may take beyond the default 48 KB
// (cudaFuncSetAttribute); a launch that asks for more fails, as on a card
inline std::mutex attr_m;
inline std::map<const void*, int> smem_allowed;
constexpr size_t kDefaultSmem = 48 * 1024;

inline unsigned char* dynamic_smem() {
  auto p = reinterpret_cast<uintptr_t>(block->dynamic.data());
  return reinterpret_cast<unsigned char*>((p + 15) & ~uintptr_t(15));
}

inline void sync_warp(unsigned mask) {
  block->warp(thread_idx.x / 32, mask).wait();
}

template <class T>
T shfl(unsigned mask, T v, int src) {
  static_assert(sizeof(T) <= 8, "a shuffle moves at most 8 bytes");
  auto& s = block->slots[thread_idx.x / 32];
  {
    std::lock_guard<std::mutex> lk(block->m);
    if (s.empty()) s.assign(32, 0);
    std::memcpy(&s[thread_idx.x % 32], &v, sizeof(T));
  }
  sync_warp(mask);
  T out;
  {
    std::lock_guard<std::mutex> lk(block->m);
    std::memcpy(&out, &s[src & 31], sizeof(T));
  }
  sync_warp(mask);
  return out;
}

template <class F>
void run_grid(unsigned blocks, unsigned threads, size_t smem, F&& body) {
  for (unsigned b = 0; b < blocks; ++b) {
    Block blk(threads, smem);
    std::vector<std::thread> team;
    team.reserve(threads);
    for (unsigned t = 0; t < threads; ++t) {
      team.emplace_back([&, b, t] {
        thread_idx.x = t;
        block_idx.x = b;
        block_dim.x = threads;
        grid_dim.x = blocks;
        block = &blk;
        body();
        blk.all.leave();
      });
    }
    for (auto& th : team) th.join();
  }
}

template <class... P>
struct Launch {
  void (*kernel)(P...);
  unsigned blocks, threads;
  size_t smem;
  template <class... A>
  void operator()(A... args) const {
    if (smem > kDefaultSmem) {
      std::lock_guard<std::mutex> lk(attr_m);
      auto it = smem_allowed.find(reinterpret_cast<const void*>(kernel));
      if (it == smem_allowed.end() || (size_t)it->second < smem) {
        last_error = cudaErrorInvalidValue;
        return;
      }
    }
    auto k = kernel;
    run_grid(blocks, threads, smem, [&] { k(static_cast<P>(args)...); });
  }
};

template <class... P>
Launch<P...> launch(void (*kernel)(P...), unsigned blocks, unsigned threads,
                    size_t smem, cudaStream_t) {
  return {kernel, blocks, threads, smem};
}

}  // namespace emu

#define threadIdx (emu::thread_idx)
#define blockIdx (emu::block_idx)
#define blockDim (emu::block_dim)
#define gridDim (emu::grid_dim)

inline void __syncthreads() { emu::block->all.wait(); }
inline void __syncwarp(unsigned mask = 0xffffffffu) { emu::sync_warp(mask); }
template <class T>
T __shfl_sync(unsigned mask, T v, int src) {
  return emu::shfl(mask, v, src);
}
template <class T>
T __ldg(const T* p) {
  return *p;
}
inline unsigned __brev(unsigned v) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((v >> i) & 1u) << (31 - i);
  return r;
}

template <class T>
cudaError_t cudaFuncSetAttribute(T* kernel, cudaFuncAttribute attr,
                                 int value) {
  if (attr == cudaFuncAttributeMaxDynamicSharedMemorySize) {
    std::lock_guard<std::mutex> lk(emu::attr_m);
    emu::smem_allowed[reinterpret_cast<const void*>(kernel)] = value;
  }
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu::last_error;
  emu::last_error = cudaSuccess;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "invalid argument";
}
