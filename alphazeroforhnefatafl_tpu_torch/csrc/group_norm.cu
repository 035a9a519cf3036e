// The trunk's normalisation epilogue: GroupNorm over 32 groups, then the
// residual skip and the ReLU, on bf16 activations held channels-last.
//
// Replaces no TPU kernel. On the TPU, XLA fuses GroupNorm's statistics, its
// affine, the skip add and the ReLU into the convolutions' neighbours. On the
// H100, PyTorch runs the same chain as a float32 copy of the activations, a
// moments kernel, a params kernel, an apply kernel, a cast back, a ReLU and
// an add, and its GroupNorm takes NCHW only, so cuDNN transposes around every
// channels-last convolution. This kernel is that whole chain in one pass
// over channels-last bf16 (models/network.py, ResBlock and the stem's and
// policy head's sites; ops/group_norm.py holds the chain as its plain
// version).
//
// What bounds it: bytes. A row (one game's activation, C x H x W) is read
// once and written once, plus the skip where there is one; there are about
// ten flops an element. At 64 channels on 11x11 that is 15,488 bytes each
// way a row, so the least time is rows x (2 or 3) x 15,488 bytes over the
// card's memory rate.
//
// Design for the H100: one CTA a row. Lane g of every warp serves group g
// (the kernel takes 32 groups and C in {32, 64, 128, 256}, so a group is
// C / 32 adjacent channels): at one position the warp's 32 lanes load the
// position's C channels as one coalesced line, each lane C / 32 of them in
// one vector load (2, 4, 8 or 16 bytes). Warp w takes positions w, w + W,
// w + 2W, ... and keeps its lanes' values in registers, at most 32 floats a
// lane, so the row is read from device memory once; the skip's packs are
// loaded beside them. The group's mean comes
// from the lanes' partial sums, put through shared memory (each warp writes
// its 32 partials, every lane then adds up its group's W partials in the same
// order); the variance is the mean of the squared deviations of the same
// values in a second pass of the same kind, never E[x^2] - E[x]^2. Then
// (x - mean) * rsqrt(var + eps) * weight + bias, the skip, the ReLU, all in
// float32, and one round to bf16 (to nearest, ties to even) on the store,
// which has the load's pattern. Nothing is approximated beyond rsqrtf.
#include "bf16_pack.cuh"

namespace {

using tafl_bf16::Pack;
using tafl_bf16::pack_rn;
using tafl_bf16::unpack;

constexpr int kGroups = 32;         // one group a lane
constexpr int kValuesPerLane = 32;  // floats a lane holds: positions x channels
constexpr int kMaxWarps = 32;

// The sum over the CTA of each lane's `part`, for the lane's group: warp w's
// partials go to buf[w][lane], and every lane adds its group's column in warp
// order, so all warps get the same bits.
__device__ __forceinline__ float group_total(float part, float* buf, int warps, int warp,
                                             int lane) {
  buf[warp * kGroups + lane] = part;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < warps; ++w) total += buf[w * kGroups + lane];
  return total;
}

// x, skip, out: rows of hw positions x (32 lanes x CPG channels), bf16.
template <int CPG>
__global__ void __launch_bounds__(32 * kMaxWarps)
tafl_group_norm_act_kernel(const typename Pack<CPG>::T* __restrict__ x,
                           const float* __restrict__ weight, const float* __restrict__ bias,
                           const typename Pack<CPG>::T* __restrict__ skip, int hw, float eps,
                           typename Pack<CPG>::T* __restrict__ out) {
  using T = typename Pack<CPG>::T;
  constexpr int P = kValuesPerLane / CPG;  // positions a lane holds
  TAFL_DYNAMIC_SHARED(smem);
  float* buf = reinterpret_cast<float*>(smem);  // [2][warps][32]: one a pass
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * hw * kGroups;

  // The skip is loaded with x, so its latency hides behind the reductions.
  float v[P][CPG];
  T sk[P];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = k * warps + warp;
    if (p < hw) {
      unpack<CPG>(x[row + (size_t)p * kGroups + lane], v[k]);
      if (skip != nullptr) sk[k] = skip[row + (size_t)p * kGroups + lane];
#pragma unroll
      for (int c = 0; c < CPG; ++c) sum += v[k][c];
    }
  }
  const float n = (float)(CPG * hw);
  const float mean = group_total(sum, buf, warps, warp, lane) / n;

  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (k * warps + warp < hw) {
#pragma unroll
      for (int c = 0; c < CPG; ++c) {
        v[k][c] -= mean;
        ss = fmaf(v[k][c], v[k][c], ss);
      }
    }
  }
  const float var = group_total(ss, buf + warps * kGroups, warps, warp, lane) / n;
  const float rstd = rsqrtf(var + eps);

  float scale[CPG], shift[CPG];
#pragma unroll
  for (int c = 0; c < CPG; ++c) {
    scale[c] = rstd * __ldg(weight + lane * CPG + c);
    shift[c] = __ldg(bias + lane * CPG + c);
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = k * warps + warp;
    if (p < hw) {
      const size_t at = row + (size_t)p * kGroups + lane;
      float y[CPG], s[CPG];
      if (skip != nullptr) unpack<CPG>(sk[k], s);
#pragma unroll
      for (int c = 0; c < CPG; ++c) {
        y[c] = fmaf(v[k][c], scale[c], shift[c]);
        if (skip != nullptr) y[c] += s[c];
        y[c] = y[c] < 0.f ? 0.f : y[c];
      }
      out[at] = pack_rn<CPG>(y);
    }
  }
}

template <int CPG>
int launch(const void* x, const void* weight, const void* bias, const void* skip, int rows,
           int hw, float eps, void* out, void* stream) {
  using T = typename Pack<CPG>::T;
  constexpr int P = kValuesPerLane / CPG;
  const int warps = (hw + P - 1) / P;
  if (warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  TAFL_LAUNCH(tafl_group_norm_act_kernel<CPG>, rows, 32 * warps,
              (int)(2 * warps * kGroups * sizeof(float)), (cudaStream_t)stream,
              (const T*)x, (const float*)weight, (const float*)bias, (const T*)skip, hw, eps,
              (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16[rows, C, H, W] with channels-last strides (memory runs rows, H, W,
// C), weight and bias float32[C], skip null or shaped and laid out as x, ->
// out = relu(group_norm(x) + skip), bf16 laid out as x. 32 groups; C in {32, 64, 128, 256}; hw = H * W at
// most 1024 * 32 / C. Returns the CUDA error of the launch (0 on success).
extern "C" int tafl_group_norm_act(const void* x, const void* weight, const void* bias,
                                   const void* skip, int rows, int channels, int hw, float eps,
                                   void* out, void* stream) {
  if (rows <= 0) return 0;
  if (hw <= 0) return (int)cudaErrorInvalidValue;
  switch (channels) {
    case 32: return launch<1>(x, weight, bias, skip, rows, hw, eps, out, stream);
    case 64: return launch<2>(x, weight, bias, skip, rows, hw, eps, out, stream);
    case 128: return launch<4>(x, weight, bias, skip, rows, hw, eps, out, stream);
    case 256: return launch<8>(x, weight, bias, skip, rows, hw, eps, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
