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
// Design for the H100. tafl_se_block is persistent: min(rows, resident
// CTAs) CTAs of 512 threads, one an SM at 256 channels, each walking rows
// blockIdx.x, blockIdx.x + gridDim.x, ... Each CTA folds the norm into a
// scale and a shift a channel and, where they fit beside the row buffer
// (at 256 channels on 11x11 up to 52 hidden, so ratio 5 and above; at 128
// channels up to 126 hidden; always at fewer channels), brings the SE
// weights into shared memory once, W1 and W2 by bulk copy (TMA) while its
// first row's squeeze runs; where they do not fit, the same kernel reads
// them from global memory. Each row of y comes into one row buffer in
// shared memory by one bulk copy on an mbarrier, issued when the previous
// row's apply has left the buffer, and the row's skip is loaded into
// registers (16 bytes a thread and load) before its SE unit starts. (A ring
// of two buffers, the next row in flight during this one, measured no
// faster; PERF.md.) The cells' sums of y come from the shared-memory row, a
// thread two channels of every (threads / (C / 2))-th position, then one
// thread a channel adds the groups in order, with no atomics, so a result
// is the same run to run. The first dense layer is a warp an output, the second a
// thread a channel (both halves), each thread's dot starting at its own
// column so that a warp's reads of W2's rows fall in distinct banks. The
// sigmoid gate and the norm fold into one scale and one shift a channel,
// out = relu(x + a y + b), written once as 16-byte packs. All arithmetic is
// float32 (expf and rsqrtf the only library calls), with one round to bf16
// on the store. HBM sees y and the skip read once and out written once; the
// weights leave it once a launch. PERF.md gives the variants measured
// against this one. tafl_bn_relu: each thread a 2-16 byte pack,
// grid-stride, so a thread keeps one lane's channels and loads their scale
// and shift once.
#include "bf16_pack.cuh"

namespace {

using tafl_bf16::Pack;
using tafl_bf16::pack_rn;
using tafl_bf16::unpack;

constexpr int kLanes = 32;
constexpr int kSeThreads = 512;       // threads of a tafl_se_block CTA
constexpr int kMaxRowValues = 32768;  // hw x C of a row: at most 64 KB of bf16
constexpr int kSmemBytes = 232448;    // the most dynamic shared memory a CTA may hold
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

// The dynamic shared memory of a tafl_se_block CTA, laid out from its start:
// a row of y, two mbarriers (the row's and the weights'), then float32
// arrays.
struct SePlan {
  int row_bytes;  // one row of y
  int floats;     // where the float arrays start
  int hid;        // hidden rounded up to 4 floats, so the arrays stay 16-byte aligned
  int bytes;      // the whole
  bool resident;  // the SE weights held in shared memory
};

__host__ __device__ inline SePlan se_plan(int C, int hidden, int hw) {
  SePlan p;
  p.row_bytes = hw * C * 2;
  p.floats = p.row_bytes + 16;
  p.hid = (hidden + 3) & ~3;
  // scale, shift, pooled [C]; h [hid]; scratch [2 threads]: each group's
  // sums of y, then a and b.
  const int common = 4 * (3 * C + p.hid + 2 * kSeThreads);
  const int weights = 4 * (p.hid + 2 * C + 3 * C * hidden);  // b1, b2, W1, W2
  p.resident = p.floats + common + weights <= kSmemBytes;
  p.bytes = p.floats + common + (p.resident ? weights : 0);
  return p;
}

// y, skip, out: rows of hw positions x C channels, bf16, as 16-byte packs of
// 8 channels. w1 float32[hidden][C], b1 [hidden], w2 [2C][hidden], b2 [2C].
template <int C, bool kResident>
__global__ void __launch_bounds__(kSeThreads, 1)
tafl_se_block_kernel(const uint4* __restrict__ y, const uint4* __restrict__ skip,
                     const float* __restrict__ weight, const float* __restrict__ bias,
                     const float* __restrict__ mean, const float* __restrict__ var, float eps,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2, int hidden,
                     int rows, int hw, uint4* __restrict__ out) {
  constexpr int kWords = C / 2;                   // channel pairs of a position
  constexpr int kGroups = kSeThreads / kWords;    // positions summed side by side
  constexpr int kPackChannels = 8;                // bf16 channels of a 16-byte pack
  constexpr int kPacks = kMaxRowValues / kPackChannels / kSeThreads;  // a thread's, at most
  TAFL_DYNAMIC_SHARED(smem);
  const SePlan plan = se_plan(C, hidden, hw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint8_t* base = reinterpret_cast<uint8_t*>(smem);
  uint4* row_y = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + plan.row_bytes);  // the row's y landed
  uint64_t* loaded = full + 1;                                          // the weights
  float* scale = reinterpret_cast<float*>(base + plan.floats);
  float* shift = scale + C;
  float* pooled = shift + C;
  float* hid = pooled + C;
  float* scratch = hid + plan.hid;
  float* s_b1 = scratch + 2 * kSeThreads;
  float* s_b2 = s_b1 + plan.hid;
  float* s_w1 = s_b2 + 2 * C;       // [hidden][C]
  float* s_w2 = s_w1 + hidden * C;  // [2C][hidden]
  const int packs = hw * C / kPackChannels;
  const int row_bytes = plan.row_bytes;
  int row = blockIdx.x;  // < rows: the grid is at most rows

  // The first row of y, and the weights, are on their way before anything
  // else; the row's squeeze runs while the weights land.
  if (tid == 0) {
    tafl_mbar_init(full, 1);
    tafl_mbar_init(loaded, 2);
    tafl_bulk_load(row_y, y + (size_t)row * packs, row_bytes, full);
    if constexpr (kResident) {
      tafl_bulk_load(s_w1, w1, hidden * C * 4, loaded);
      tafl_bulk_load(s_w2, w2, 2 * C * hidden * 4, loaded);
    }
  }
  for (int c = tid; c < C; c += kSeThreads) bn_affine(weight, bias, mean, var, eps, c, scale[c], shift[c]);
  if constexpr (kResident) {
    for (int i = tid; i < hidden; i += kSeThreads) s_b1[i] = __ldg(b1 + i);
    for (int i = tid; i < 2 * C; i += kSeThreads) s_b2[i] = __ldg(b2 + i);
  }
  __syncthreads();
  auto w1_at = [&](int j, int c) {
    if constexpr (kResident) return s_w1[j * C + c];
    else return __ldg(w1 + (size_t)j * C + c);
  };
  auto w2_at = [&](int o, int j) {
    if constexpr (kResident) return s_w2[o * hidden + j];
    else return __ldg(w2 + (size_t)o * hidden + j);
  };
  auto b1_at = [&](int j) {
    if constexpr (kResident) return s_b1[j];
    else return __ldg(b1 + j);
  };
  auto b2_at = [&](int o) {
    if constexpr (kResident) return s_b2[o];
    else return __ldg(b2 + o);
  };

  for (int it = 0; row < rows; ++it, row += gridDim.x) {
    const size_t first = (size_t)row * packs;
    // This row's y into the buffer, whose last reads (the previous row's
    // apply) ended at the barrier that closed that row.
    if (tid == 0 && it > 0) tafl_bulk_load(row_y, y + first, row_bytes, full);
    // This row's skip, in flight while its SE unit runs.
    uint4 sk[kPacks];
#pragma unroll
    for (int k = 0; k < kPacks; ++k) {
      const int q = tid + k * kSeThreads;
      if (q < packs) sk[k] = __ldcs(skip + first + q);
    }
    tafl_mbar_wait(full, it & 1);

    // The cells' sums of y: thread (g, w) sums channels 2w and 2w + 1 over
    // positions g, g + kGroups, ...
    {
      const uint32_t* words = reinterpret_cast<const uint32_t*>(row_y);
      const int w = tid % kWords, g = tid / kWords;
      float lo = 0.f, hi = 0.f;
#pragma unroll 4
      for (int p = g; p < hw; p += kGroups) {
        const uint32_t v = words[p * kWords + w];
        lo += __uint_as_float(v << 16);
        hi += __uint_as_float(v & 0xffff0000u);
      }
      scratch[g * C + 2 * w] = lo;
      scratch[g * C + 2 * w + 1] = hi;
    }
    __syncthreads();

    // s = the norm applied to the mean of y.
    for (int c = tid; c < C; c += kSeThreads) {
      float total = 0.f;
      for (int g = 0; g < kGroups; ++g) total += scratch[g * C + c];
      pooled[c] = fmaf(total / (float)hw, scale[c], shift[c]);
    }
    __syncthreads();

    // h = relu(W1 s + b1): a warp an output.
    if (kResident && it == 0) tafl_mbar_wait(loaded, 0);
    for (int j = warp; j < hidden; j += kSeThreads / kLanes) {
      float acc = 0.f;
      for (int c = lane; c < C; c += kLanes) acc = fmaf(w1_at(j, c), pooled[c], acc);
      acc = warp_sum(acc);
      if (lane == 0) {
        const float h = acc + b1_at(j);
        hid[j] = h < 0.f ? 0.f : h;
      }
    }
    __syncthreads();

    // (gamma, beta) = W2 h + b2, a thread a channel for both halves, each
    // thread's dot starting at its own j = c mod hidden, so that a warp's
    // reads of W2's rows (and of h) fall in distinct banks; then
    // out = relu(x + sigmoid(gamma) (y scale + shift) + beta) = relu(x + a y + b).
    float* a = scratch;
    float* b = scratch + C;
    for (int c = tid; c < C; c += kSeThreads) {
      float gamma = b2_at(c), beta = b2_at(C + c);
      for (int n = 0, j = c % hidden; n < hidden; ++n, j = j + 1 == hidden ? 0 : j + 1) {
        const float h = hid[j];
        gamma = fmaf(w2_at(c, j), h, gamma);
        beta = fmaf(w2_at(C + c, j), h, beta);
      }
      const float gate = 1.f / (1.f + expf(-gamma));
      a[c] = gate * scale[c];
      b[c] = fmaf(gate, shift[c], beta);
    }
    __syncthreads();

    // A thread's packs are all of channels c0 .. c0 + 7: the threads are a
    // multiple of the packs of a position.
    const int c0 = (tid % (C / kPackChannels)) * kPackChannels;
    float ca[kPackChannels], cb[kPackChannels];
#pragma unroll
    for (int c = 0; c < kPackChannels; ++c) {
      ca[c] = a[c0 + c];
      cb[c] = b[c0 + c];
    }
#pragma unroll
    for (int k = 0; k < kPacks; ++k) {
      const int q = tid + k * kSeThreads;
      if (q < packs) {
        float v[kPackChannels], x[kPackChannels];
        unpack<kPackChannels>(row_y[q], v);
        unpack<kPackChannels>(sk[k], x);
#pragma unroll
        for (int c = 0; c < kPackChannels; ++c) {
          const float o = x[c] + fmaf(ca[c], v[c], cb[c]);
          v[c] = o < 0.f ? 0.f : o;
        }
        out[first + q] = pack_rn<kPackChannels>(v);
      }
    }
    __syncthreads();  // the buffer, a and b are free for the next rows
  }
}

template <int C, bool kResident>
int launch_se_as(const SePlan& plan, const void* y, const void* skip, const void* weight,
                 const void* bias, const void* mean, const void* var, float eps,
                 const void* w1, const void* b1, const void* w2, const void* b2, int hidden,
                 int rows, int hw, int sms, void* out, void* stream) {
  const auto kernel = tafl_se_block_kernel<C, kResident>;
  int per_sm = 1;
#ifndef TAFL_HOST_SIM
  // The limit is raised once to the most any shape asks for; the CTAs an
  // SM holds are looked up once a device and plan size.
  static bool raised[TAFL_MAX_DEVICES];
  static int known_bytes[TAFL_MAX_DEVICES], known_per_sm[TAFL_MAX_DEVICES];
  cudaError_t e = tafl_raise_smem_limit(kernel, kSmemBytes, raised);
  if (e != cudaSuccess) return (int)e;
  int dev = 0;
  cudaGetDevice(&dev);
  if (known_bytes[dev] != plan.bytes) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSeThreads, plan.bytes);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    known_bytes[dev] = plan.bytes;
    known_per_sm[dev] = per_sm;
  }
  per_sm = known_per_sm[dev];
#endif
  const long resident = (long)sms * per_sm;
  const int grid = rows < resident ? rows : (int)resident;
  TAFL_LAUNCH(kernel, grid, kSeThreads, plan.bytes, (cudaStream_t)stream,
              (const uint4*)y, (const uint4*)skip, (const float*)weight, (const float*)bias,
              (const float*)mean, (const float*)var, eps, (const float*)w1, (const float*)b1,
              (const float*)w2, (const float*)b2, hidden, rows, hw, (uint4*)out);
  return (int)cudaGetLastError();
}

template <int C>
int launch_se(const void* y, const void* skip, const void* weight, const void* bias,
              const void* mean, const void* var, float eps, const void* w1, const void* b1,
              const void* w2, const void* b2, int hidden, int rows, int hw, int sms, void* out,
              void* stream) {
  const SePlan plan = se_plan(C, hidden, hw);
  return (plan.resident ? launch_se_as<C, true> : launch_se_as<C, false>)(
      plan, y, skip, weight, bias, mean, var, eps, w1, b1, w2, b2, hidden, rows, hw, sms, out,
      stream);
}

// Whether tafl_se_block serves these shapes.
bool se_served(int channels, int hidden, int hw) {
  return (channels == 32 || channels == 64 || channels == 128 || channels == 256) &&
         1 <= hidden && hidden <= channels && 1 <= hw && hw * channels <= kMaxRowValues;
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
// H, W, C); weight, bias, mean, var: the norm's float32[C]; w1
// float32[hidden, C], b1 [hidden], w2 [2C, hidden], b2 [2C] -> out = the SE
// block's output, bf16 laid out as y. y, skip, w1, w2 and out start on
// 16-byte boundaries. C in {32, 64, 128, 256}; hw = H * W at most 32768 / C;
// 1 <= hidden <= C. At most `sms` SMs' worth of resident CTAs run (the
// card's SM count, or fewer for a test). Returns the CUDA error of the
// launch (0 on success).
extern "C" int tafl_se_block(const void* y, const void* skip, const void* weight,
                             const void* bias, const void* mean, const void* var, float eps,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             int hidden, int rows, int channels, int hw, int sms, void* out,
                             void* stream) {
  if (rows <= 0) return 0;
  if (!se_served(channels, hidden, hw) || sms <= 0 ||
      (((uintptr_t)y | (uintptr_t)skip | (uintptr_t)out | (uintptr_t)w1 | (uintptr_t)w2) & 15u)) {
    return (int)cudaErrorInvalidValue;
  }
  switch (channels) {
    case 32: return launch_se<32>(y, skip, weight, bias, mean, var, eps, w1, b1, w2, b2, hidden, rows, hw, sms, out, stream);
    case 64: return launch_se<64>(y, skip, weight, bias, mean, var, eps, w1, b1, w2, b2, hidden, rows, hw, sms, out, stream);
    case 128: return launch_se<128>(y, skip, weight, bias, mean, var, eps, w1, b1, w2, b2, hidden, rows, hw, sms, out, stream);
    default: return launch_se<256>(y, skip, weight, bias, mean, var, eps, w1, b1, w2, b2, hidden, rows, hw, sms, out, stream);
  }
}

// 1 where tafl_se_block holds the SE weights in shared memory for these
// shapes, 0 where it reads them from global memory, -1 where it does not
// serve them; `smem_bytes` (where not null) gets a CTA's dynamic shared
// memory.
extern "C" int tafl_se_block_plan(int channels, int hidden, int hw, int* smem_bytes) {
  if (!se_served(channels, hidden, hw)) return -1;
  const SePlan plan = se_plan(channels, hidden, hw);
  if (smem_bytes) *smem_bytes = plan.bytes;
  return plan.resident ? 1 : 0;
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
