// The SE block's end as the port first ran it: one CTA a row of at most 32
// warps, the row and the skip held in registers between their one read and
// the one write, every row reading the SE weights from L1 or L2. Not part of
// the library: chip_smoke.py builds it on its own and times it beside
// csrc/se_block.cu's persistent kernel at the same shapes, as the yardstick
// that kernel is measured against. It takes what tafl_se_block takes, less
// `sms`, and is held within 1 ulp of exact math as the kernel is.
#include "bf16_pack.cuh"

namespace {

using tafl_bf16::Pack;
using tafl_bf16::pack_rn;
using tafl_bf16::unpack;

constexpr int kLanes = 32;
constexpr int kValuesPerLane = 32;  // bf16 values a lane holds of y, and of x
constexpr int kMaxWarps = 32;

// The sum of the warp's 32 values, in lane 0 (a shuffle tree).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = kLanes / 2; d > 0; d >>= 1) {
    v += __uint_as_float(__shfl_down_sync(TAFL_FULL, __float_as_uint(v), d));
  }
  return v;
}

// The norm's inference affine of channel c: z = y * scale + shift.
__device__ __forceinline__ void bn_affine(const float* __restrict__ weight,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ mean,
                                          const float* __restrict__ var, float eps, int c,
                                          float& scale, float& shift) {
  scale = __ldg(weight + c) * rsqrtf(__ldg(var + c) + eps);
  shift = fmaf(-__ldg(mean + c), scale, __ldg(bias + c));
}

// y, skip, out: rows of hw positions x (32 lanes x CPG channels), bf16.
// w1 float32[hidden][C], b1 [hidden], w2 [2C][hidden], b2 [2C].
template <int CPG>
__global__ void __launch_bounds__(kLanes * kMaxWarps)
yardstick_se_one_row_kernel(const typename Pack<CPG>::T* __restrict__ y,
                     const typename Pack<CPG>::T* __restrict__ skip,
                     const float* __restrict__ weight, const float* __restrict__ bias,
                     const float* __restrict__ mean, const float* __restrict__ var, float eps,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2, int hidden,
                     int hw, typename Pack<CPG>::T* __restrict__ out) {
  using T = typename Pack<CPG>::T;
  constexpr int C = kLanes * CPG;
  constexpr int P = kValuesPerLane / CPG;  // positions a lane holds
  TAFL_DYNAMIC_SHARED(smem);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* part = reinterpret_cast<float*>(smem);  // [warps][C]: each warp's sums of y
  float* pooled = part + warps * C;              // [C]: s
  float* a = pooled + C;                         // [C]: the gate times the norm's scale
  float* b = a + C;                              // [C]: the shift of out
  float* hid = b + C;                            // [hidden]: h
  const size_t row = (size_t)blockIdx.x * hw * kLanes;

  // Read y; sum each channel over the lane's positions; then read the skip,
  // whose latency hides behind the SE unit.
  T yp[P], sk[P];
  float sum[CPG];
#pragma unroll
  for (int c = 0; c < CPG; ++c) sum[c] = 0.f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = k * warps + warp;
    if (p < hw) {
      yp[k] = y[row + (size_t)p * kLanes + lane];
      float v[CPG];
      unpack<CPG>(yp[k], v);
#pragma unroll
      for (int c = 0; c < CPG; ++c) sum[c] += v[c];
    }
  }
#pragma unroll
  for (int c = 0; c < CPG; ++c) part[warp * C + lane * CPG + c] = sum[c];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = k * warps + warp;
    if (p < hw) sk[k] = skip[row + (size_t)p * kLanes + lane];
  }
  __syncthreads();

  // s = the norm applied to the mean of y.
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float total = 0.f;
    for (int w = 0; w < warps; ++w) total += part[w * C + c];
    float scale, shift;
    bn_affine(weight, bias, mean, var, eps, c, scale, shift);
    pooled[c] = fmaf(total / (float)hw, scale, shift);
  }
  __syncthreads();

  // h = relu(W1 s + b1): a warp an output.
  for (int j = warp; j < hidden; j += warps) {
    float acc = 0.f;
    for (int c = lane; c < C; c += kLanes) acc = fmaf(__ldg(w1 + (size_t)j * C + c), pooled[c], acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      const float h = acc + __ldg(b1 + j);
      hid[j] = h < 0.f ? 0.f : h;
    }
  }
  __syncthreads();

  // (gamma, beta) = W2 h + b2, a thread a channel for both halves; then
  // out = relu(x + sigmoid(gamma) (y scale + shift) + beta) = relu(x + a y + b).
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float gamma = __ldg(b2 + c), beta = __ldg(b2 + C + c);
    for (int j = 0; j < hidden; ++j) {
      const float h = hid[j];
      gamma = fmaf(__ldg(w2 + (size_t)c * hidden + j), h, gamma);
      beta = fmaf(__ldg(w2 + (size_t)(C + c) * hidden + j), h, beta);
    }
    const float gate = 1.f / (1.f + expf(-gamma));
    float scale, shift;
    bn_affine(weight, bias, mean, var, eps, c, scale, shift);
    a[c] = gate * scale;
    b[c] = fmaf(gate, shift, beta);
  }
  __syncthreads();

  float ca[CPG], cb[CPG];
#pragma unroll
  for (int c = 0; c < CPG; ++c) {
    ca[c] = a[lane * CPG + c];
    cb[c] = b[lane * CPG + c];
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = k * warps + warp;
    if (p < hw) {
      float v[CPG], x[CPG];
      unpack<CPG>(yp[k], v);
      unpack<CPG>(sk[k], x);
#pragma unroll
      for (int c = 0; c < CPG; ++c) {
        const float o = x[c] + fmaf(ca[c], v[c], cb[c]);
        v[c] = o < 0.f ? 0.f : o;
      }
      out[row + (size_t)p * kLanes + lane] = pack_rn<CPG>(v);
    }
  }
}

template <int CPG>
int launch_se(const void* y, const void* skip, const void* weight, const void* bias,
              const void* mean, const void* var, float eps, const void* w1, const void* b1,
              const void* w2, const void* b2, int hidden, int rows, int hw, void* out,
              void* stream) {
  using T = typename Pack<CPG>::T;
  constexpr int C = kLanes * CPG;
  constexpr int P = kValuesPerLane / CPG;
  const int warps = (hw + P - 1) / P;
  if (warps > kMaxWarps || hidden <= 0 || hidden > C) return (int)cudaErrorInvalidValue;
  const int smem = (int)(((warps + 3) * C + hidden) * sizeof(float));
  TAFL_LAUNCH(yardstick_se_one_row_kernel<CPG>, rows, kLanes * warps, smem,
              (cudaStream_t)stream, (const T*)y, (const T*)skip, (const float*)weight, (const float*)bias,
              (const float*)mean, (const float*)var, eps, (const float*)w1, (const float*)b1,
              (const float*)w2, (const float*)b2, hidden, hw, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// y, skip: bf16[rows, C, H, W] with channels-last strides (memory runs rows,
// H, W, C); weight, bias, mean, var: the norm's float32[C]; w1 float32[hidden,
// C], b1 [hidden], w2 [2C, hidden], b2 [2C] -> out = the SE block's output,
// bf16 laid out as y. C in {32, 64, 128, 256}; hw = H * W at most 1024 * 32 /
// C; 1 <= hidden <= C. Returns the CUDA error of the launch (0 on success).
extern "C" int tafl_se_block_one_row(const void* y, const void* skip, const void* weight,
                             const void* bias, const void* mean, const void* var, float eps,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             int hidden, int rows, int channels, int hw, void* out,
                             void* stream) {
  if (rows <= 0) return 0;
  if (hw <= 0) return (int)cudaErrorInvalidValue;
  switch (channels) {
    case 32: return launch_se<1>(y, skip, weight, bias, mean, var, eps, w1, b1, w2, b2, hidden, rows, hw, out, stream);
    case 64: return launch_se<2>(y, skip, weight, bias, mean, var, eps, w1, b1, w2, b2, hidden, rows, hw, out, stream);
    case 128: return launch_se<4>(y, skip, weight, bias, mean, var, eps, w1, b1, w2, b2, hidden, rows, hw, out, stream);
    case 256: return launch_se<8>(y, skip, weight, bias, mean, var, eps, w1, b1, w2, b2, hidden, rows, hw, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
