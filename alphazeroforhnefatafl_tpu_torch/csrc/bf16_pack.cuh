// bf16 channels as packs of one vector load, shared by the kernels that
// read and write the trunk's channels-last activations (group_norm.cu,
// se_block.cu): a lane's C / 32 adjacent channels at one position, 2 to 16
// bytes, unpacked to float32 and packed back with one round to nearest
// (ties to even).
#pragma once

#include "tafl_common.cuh"

#ifndef TAFL_HOST_SIM
#include <cuda_bf16.h>
#endif

namespace tafl_bf16 {

// A lane's C / 32 bf16 channels at one position, as one load.
template <int CPG>
struct Pack;
template <>
struct Pack<1> {
  using T = unsigned short;
};
template <>
struct Pack<2> {
  using T = uint32_t;
};
template <>
struct Pack<4> {
  using T = uint2;
};
template <>
struct Pack<8> {
  using T = uint4;
};

// 32-bit word i of a pack: channels 2i (low half) and 2i + 1 (high half).
__device__ __forceinline__ uint32_t word(unsigned short r, int) { return r; }
__device__ __forceinline__ uint32_t word(uint32_t r, int) { return r; }
__device__ __forceinline__ uint32_t word(uint2 r, int i) { return i == 0 ? r.x : r.y; }
__device__ __forceinline__ uint32_t word(uint4 r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}
__device__ __forceinline__ void set_word(unsigned short& r, int, uint32_t w) {
  r = (unsigned short)w;
}
__device__ __forceinline__ void set_word(uint32_t& r, int, uint32_t w) { r = w; }
__device__ __forceinline__ void set_word(uint2& r, int i, uint32_t w) {
  if (i == 0) r.x = w; else r.y = w;
}
__device__ __forceinline__ void set_word(uint4& r, int i, uint32_t w) {
  if (i == 0) r.x = w; else if (i == 1) r.y = w; else if (i == 2) r.z = w; else r.w = w;
}

template <int CPG>
__device__ __forceinline__ void unpack(typename Pack<CPG>::T r, float (&v)[CPG]) {
#pragma unroll
  for (int c = 0; c < CPG; ++c) {
    const uint32_t w = word(r, c / 2);
    v[c] = __uint_as_float((c & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

template <int CPG>
__device__ __forceinline__ typename Pack<CPG>::T pack_rn(const float (&v)[CPG]) {
  typename Pack<CPG>::T r;
  if constexpr (CPG == 1) {
    r = __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
  } else {
#pragma unroll
    for (int i = 0; i < CPG / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      set_word(r, i, (uint32_t)__bfloat16_as_ushort(h.x) |
                         ((uint32_t)__bfloat16_as_ushort(h.y) << 16));
    }
  }
  return r;
}

}  // namespace tafl_bf16
