// The batch-norm trunk's epilogues, on bf16 activations held channels-last:
//
// - tafl_bn_relu: relu(batch_norm(y)) with the running statistics (the
//   stem's, each block's first and the policy head's norm);
// - tafl_se_block: the end of a squeeze-excitation residual block (Leela
//   Chess Zero's), from the second convolution's output y and the block's
//   input x:
//       z   = batch_norm(y)                  (running statistics)
//       s   = mean of z over the H x W cells  [C]
//       h   = relu(W1 s + b1)                 [C / ratio]
//       g   = W2 h + b2                       [2C] = (gamma, beta)
//       out = relu(x + sigmoid(gamma) z + beta)
//
// Replaces no TPU kernel: the JAX package has no batch norm and no SE unit
// (models/network.py, PolicyValueNet with norm="batch"). In PyTorch ops the
// SE end of a block is about eight launches (a float32 norm, the mean, two
// GEMMs, their bias adds, the ReLU, the sigmoid, the scale-and-shift, the
// skip add, the ReLU), each a pass over the row or a launch of next to no
// work; ops/se_block.py holds that chain as the plain version.
//
// What bounds them: bytes. tafl_se_block reads y and x once and writes out
// once (185,856 bytes a row at 256 channels on 11x11) and reads the SE
// weights and the norm's four vectors once a launch (104,576 bytes at 256
// channels and ratio 8); its two small matrix-vector products are 16,384
// and 16,384 multiply-adds a row, far below the bytes. tafl_bn_relu reads y
// and writes out once.
//
// Design for the H100. tafl_se_block: one CTA a row, laid out as the
// GroupNorm kernel's (group_norm.cu): lane l of every warp holds channels
// [l C/32, (l + 1) C/32) of a position as one 2-16 byte load, warp w takes
// positions w, w + W, ..., at most 32 / (C / 32) of them, so the row and
// the skip stay in registers as raw bf16 packs between the one read and the
// one write. The cells' mean needs only the sums of y (the norm is affine):
// each warp writes its lanes' per-channel sums to shared memory and one
// thread a channel adds the warps' columns in warp order and applies the
// norm. The first dense layer is a warp an output (lanes stride the
// channels, a shuffle tree sums), the second a thread a channel (two dots
// of C / ratio, W2 read from L1). The sigmoid gate and the norm fold into
// one scale and one shift a channel, out = relu(x + a y + b), applied from
// the registers. All arithmetic is float32 (expf and rsqrtf the only
// library calls), with one round to bf16 on the store. At 256 channels a
// row takes 31 warps of 64 registers, so one CTA an SM: the SE unit's
// serial steps are not hidden behind another row's loads (PERF.md gives
// the variants measured against this one). tafl_bn_relu: each thread a
// 2-16 byte pack, grid-stride, so a thread keeps one lane's channels and
// loads their scale and shift once.
#include "bf16_pack.cuh"

namespace {

using tafl_bf16::Pack;
using tafl_bf16::pack_rn;
using tafl_bf16::unpack;

constexpr int kLanes = 32;
constexpr int kValuesPerLane = 32;  // bf16 values a lane holds of y, and of x
constexpr int kMaxWarps = 32;
constexpr int kActThreads = 256;
constexpr int kActBlocksPerSm = 8;
constexpr int kSms = 132;

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

template <int CPG>
__global__ void __launch_bounds__(kActThreads)
tafl_bn_relu_kernel(const typename Pack<CPG>::T* __restrict__ y,
                    const float* __restrict__ weight, const float* __restrict__ bias,
                    const float* __restrict__ mean, const float* __restrict__ var, float eps,
                    size_t packs, typename Pack<CPG>::T* __restrict__ out) {
  // The stride is a multiple of 32 packs, so a thread's packs are all its
  // lane's channels.
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = (int)(i & (kLanes - 1));
  float scale[CPG], shift[CPG];
#pragma unroll
  for (int c = 0; c < CPG; ++c) {
    bn_affine(weight, bias, mean, var, eps, lane * CPG + c, scale[c], shift[c]);
  }
  for (; i < packs; i += stride) {
    float v[CPG];
    unpack<CPG>(y[i], v);
#pragma unroll
    for (int c = 0; c < CPG; ++c) {
      const float z = fmaf(v[c], scale[c], shift[c]);
      v[c] = z < 0.f ? 0.f : z;
    }
    out[i] = pack_rn<CPG>(v);
  }
}

// y, skip, out: rows of hw positions x (32 lanes x CPG channels), bf16.
// w1 float32[hidden][C], b1 [hidden], w2 [2C][hidden], b2 [2C].
template <int CPG>
__global__ void __launch_bounds__(kLanes * kMaxWarps)
tafl_se_block_kernel(const typename Pack<CPG>::T* __restrict__ y,
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
  TAFL_LAUNCH(tafl_se_block_kernel<CPG>, rows, kLanes * warps, smem, (cudaStream_t)stream,
              (const T*)y, (const T*)skip, (const float*)weight, (const float*)bias,
              (const float*)mean, (const float*)var, eps, (const float*)w1, (const float*)b1,
              (const float*)w2, (const float*)b2, hidden, hw, (T*)out);
  return (int)cudaGetLastError();
}

template <int CPG>
int launch_act(const void* y, const void* weight, const void* bias, const void* mean,
               const void* var, float eps, int rows, int hw, void* out, void* stream) {
  using T = typename Pack<CPG>::T;
  const size_t packs = (size_t)rows * hw * kLanes;
  size_t blocks = (packs + kActThreads - 1) / kActThreads;
  if (blocks > (size_t)kSms * kActBlocksPerSm) blocks = (size_t)kSms * kActBlocksPerSm;
  TAFL_LAUNCH(tafl_bn_relu_kernel<CPG>, (int)blocks, kActThreads, 0, (cudaStream_t)stream,
              (const T*)y, (const float*)weight, (const float*)bias, (const float*)mean,
              (const float*)var, eps, packs, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// y, skip: bf16[rows, C, H, W] with channels-last strides (memory runs rows,
// H, W, C); weight, bias, mean, var: the norm's float32[C]; w1 float32[hidden,
// C], b1 [hidden], w2 [2C, hidden], b2 [2C] -> out = the SE block's output,
// bf16 laid out as y. C in {32, 64, 128, 256}; hw = H * W at most 1024 * 32 /
// C; 1 <= hidden <= C. Returns the CUDA error of the launch (0 on success).
extern "C" int tafl_se_block(const void* y, const void* skip, const void* weight,
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

// y: as above -> out = relu(batch_norm(y)) with the running statistics, laid
// out as y. C in {32, 64, 128, 256}.
extern "C" int tafl_bn_relu(const void* y, const void* weight, const void* bias,
                            const void* mean, const void* var, float eps, int rows,
                            int channels, int hw, void* out, void* stream) {
  if (rows <= 0) return 0;
  if (hw <= 0) return (int)cudaErrorInvalidValue;
  switch (channels) {
    case 32: return launch_act<1>(y, weight, bias, mean, var, eps, rows, hw, out, stream);
    case 64: return launch_act<2>(y, weight, bias, mean, var, eps, rows, hw, out, stream);
    case 128: return launch_act<4>(y, weight, bias, mean, var, eps, rows, hw, out, stream);
    case 256: return launch_act<8>(y, weight, bias, mean, var, eps, rows, hw, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
