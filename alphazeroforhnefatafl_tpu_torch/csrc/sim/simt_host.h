// A host stand-in for the few CUDA features the kernels use, so that the
// same sources compile with a plain C++ compiler (-DTAFL_HOST_SIM) and run on
// CPU buffers. It exists to test the kernels' logic where there is no card:
// nothing of the package's run path uses it, and it says nothing about speed.
//
// One CTA runs at a time. Each of its threads is a fiber (ucontext) on the
// caller's OS thread, scheduled round-robin; a fiber yields only inside a
// warp-wide call or a block barrier, until the others have arrived. Every
// warp-wide call must name all 32 lanes, as the kernels' do.
#pragma once

#include <ucontext.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)

struct uint2 {
  uint32_t x, y;
};
struct uint4 {
  uint32_t x, y, z, w;
};
struct dim3 {
  unsigned x, y, z;
};
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

namespace simt {

constexpr int kMaxWarps = 32;
constexpr size_t kStackBytes = 256 * 1024;

struct Fiber {
  ucontext_t ctx;
  std::vector<char> stack;
  bool done;
};

struct WarpState {
  uint32_t slot[32];
  int arrived, departed, draining;
};

struct State {
  std::vector<Fiber> fibers;
  ucontext_t scheduler;
  int current = 0;
  int num_threads = 0;
  dim3 block_idx{0, 0, 0};
  dim3 grid_dim{0, 0, 0};
  WarpState warps[kMaxWarps];
  int bar_arrived = 0, bar_departed = 0, bar_draining = 0;
  std::vector<uint4> dynamic;
  std::function<void()> body;
};

inline State& state() {
  static State s;
  return s;
}

inline void yield() {
  State& s = state();
  swapcontext(&s.fibers[s.current].ctx, &s.scheduler);
}

inline void fiber_main() {
  State& s = state();
  s.body();
  s.fibers[s.current].done = true;
  swapcontext(&s.fibers[s.current].ctx, &s.scheduler);
}

inline uint4* dynamic_shared() { return state().dynamic.data(); }

// Every lane hands in a value and gets all 32 back.
inline void gather(unsigned mask, uint32_t value, uint32_t out[32]) {
  State& s = state();
  if (mask != 0xffffffffu) {
    fprintf(stderr, "simt: a warp-wide call must name all 32 lanes\n");
    abort();
  }
  WarpState& w = s.warps[s.current >> 5];
  while (w.draining) yield();
  w.slot[s.current & 31] = value;
  if (++w.arrived == 32) {
    w.draining = 1;
    w.departed = 0;
  }
  while (!w.draining) yield();
  memcpy(out, w.slot, sizeof(w.slot));
  if (++w.departed == 32) {
    w.arrived = 0;
    w.draining = 0;
  }
}

inline void block_barrier() {
  State& s = state();
  while (s.bar_draining) yield();
  if (++s.bar_arrived == s.num_threads) {
    s.bar_draining = 1;
    s.bar_departed = 0;
  }
  while (!s.bar_draining) yield();
  if (++s.bar_departed == s.num_threads) {
    s.bar_arrived = 0;
    s.bar_draining = 0;
  }
}

template <typename F>
inline void launch(int grid, int block, int dynamic_bytes, F body) {
  State& s = state();
  if (block % 32 != 0 || block > 32 * kMaxWarps) {
    fprintf(stderr, "simt: block size %d\n", block);
    abort();
  }
  s.num_threads = block;
  s.grid_dim = dim3{(unsigned)grid, 1, 1};
  s.body = body;
  s.dynamic.assign((dynamic_bytes + 15) / 16 + 1, uint4{0xdeadbeefu, 0xdeadbeefu, 0xdeadbeefu, 0xdeadbeefu});
  if ((int)s.fibers.size() < block) s.fibers.resize(block);
  for (int bx = 0; bx < grid; ++bx) {
    s.block_idx = dim3{(unsigned)bx, 0, 0};
    memset(s.warps, 0, sizeof(s.warps));
    s.bar_arrived = s.bar_departed = s.bar_draining = 0;
    for (int t = 0; t < block; ++t) {
      Fiber& f = s.fibers[t];
      if (f.stack.empty()) f.stack.resize(kStackBytes);
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.data();
      f.ctx.uc_stack.ss_size = f.stack.size();
      f.ctx.uc_link = nullptr;
      f.done = false;
      makecontext(&f.ctx, fiber_main, 0);
    }
    long rounds = 0;
    for (int left = block; left > 0;) {
      left = 0;
      for (int t = 0; t < block; ++t) {
        if (s.fibers[t].done) continue;
        s.current = t;
        swapcontext(&s.scheduler, &s.fibers[t].ctx);
        if (!s.fibers[t].done) ++left;
      }
      if (++rounds > 10000000L) {
        fprintf(stderr, "simt: the CTA does not finish (a lane missed a warp-wide call?)\n");
        abort();
      }
    }
  }
}

inline dim3 thread_idx() { return dim3{(unsigned)state().current, 0, 0}; }
inline dim3 block_dim() { return dim3{(unsigned)state().num_threads, 1, 1}; }

}  // namespace simt

#define threadIdx (simt::thread_idx())
#define blockDim (simt::block_dim())
#define blockIdx (simt::state().block_idx)
#define gridDim (simt::state().grid_dim)

inline void __syncthreads() { simt::block_barrier(); }

inline int __lane() { return simt::state().current & 31; }

inline uint32_t __shfl_sync(unsigned mask, uint32_t v, int src) {
  uint32_t all[32];
  simt::gather(mask, v, all);
  return all[src & 31];
}
inline uint32_t __shfl_up_sync(unsigned mask, uint32_t v, unsigned delta) {
  uint32_t all[32];
  simt::gather(mask, v, all);
  const int lane = __lane();
  return lane >= (int)delta ? all[lane - delta] : v;
}
inline uint32_t __shfl_down_sync(unsigned mask, uint32_t v, unsigned delta) {
  uint32_t all[32];
  simt::gather(mask, v, all);
  const int lane = __lane();
  return lane + (int)delta < 32 ? all[lane + delta] : v;
}
inline uint32_t __ballot_sync(unsigned mask, int pred) {
  uint32_t all[32];
  simt::gather(mask, pred ? 1u : 0u, all);
  uint32_t out = 0;
  for (int i = 0; i < 32; ++i) out |= all[i] << i;
  return out;
}
inline int __any_sync(unsigned mask, int pred) { return __ballot_sync(mask, pred) != 0u; }
inline unsigned __reduce_add_sync(unsigned mask, unsigned v) {
  uint32_t all[32];
  simt::gather(mask, v, all);
  unsigned sum = 0;
  for (int i = 0; i < 32; ++i) sum += all[i];
  return sum;
}

inline int __popc(uint32_t x) { return __builtin_popcount(x); }
inline int __ffs(uint32_t x) { return __builtin_ffs((int)x); }
inline int __clz(uint32_t x) { return x ? __builtin_clz(x) : 32; }
inline uint32_t __brev(uint32_t x) {
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
template <typename T>
inline T __ldg(const T* p) {
  return *p;
}

inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, sizeof(f));
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  memcpy(&u, &f, sizeof(u));
  return u;
}
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }

// bf16 as 16-bit storage (cuda_bf16.h): a float's upper half, rounded to
// nearest with ties to even; a NaN stays a (quiet) NaN.
struct __nv_bfloat16 {
  unsigned short x;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(unsigned short)((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.x; }
