// Legal-action mask of the side to move, for a batch of games.
//
// Replaces the Pallas TPU kernel of alphazeroforhnefatafl_tpu/ops/legal_mask.py
// (_build_kernel, launched by _make_batched_mask_fn).
//
// What bounds it: bytes, and almost all of them the output. At 11x11 a game
// reads 121 + 4 bytes and writes its 4840-byte mask row; there is no
// arithmetic to speak of, so the least time is (B * 4965 bytes) over the
// card's memory rate. Below about a thousand games the kernel's own chain of
// dependent steps (zero fill, board load, transposes, scan, copy out) and
// the launch decide its time, not the bytes.
//
// Design for the H100 (tafl_common.cuh holds the shared parts): a CTA serves
// a group of four consecutive games, one warp each. A warp reads
// its board into row bit masks (lane = row), gets each piece's reach from one
// __ffs on the row's or the column's mask, and writes the few legal bytes
// into the group's span of the mask staged in shared memory, which the CTA
// first zero-filled with 16-byte stores. After one barrier the span leaves
// in one bulk copy from shared to global memory. Only pieces of the side to
// move do any work, nothing is loaded in the ray loop, the rule switches are
// selected without indexing (no stack frame), and no thread divides a
// 64-bit index.
#include "tafl_common.cuh"

namespace {

__global__ void __launch_bounds__(32 * TAFL_GROUP)
tafl_legal_mask_kernel(const int8_t* __restrict__ boards,
                       const int* __restrict__ sides,
                       const uint32_t* __restrict__ tab, TaflParams p, int B,
                       int group, uint8_t* __restrict__ out) {
  TAFL_DYNAMIC_SHARED(smem);
  const int n = p.n, nn = n * n;
  const int A = nn * 4 * (n - 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g0 = blockIdx.x * group;
  const int count = tafl_min(group, B - g0);
  uint8_t* gout = out + (size_t)g0 * A;
  const int shift = tafl_stage_shift(gout);
  const int span = count * A;

  tafl_stage_zero(smem, shift + span);
  __syncthreads();
  if (warp < count) {
    const int b = g0 + warp;
    const TaflRows rows = tafl_load_rows(boards + (size_t)b * nn, n, lane);
    tafl_warp_mask(rows, sides[b], tab, p, lane, (uint8_t*)smem + shift + warp * A);
  }
  tafl_stage_fence();
  __syncthreads();
  tafl_stage_flush(smem, shift, span, gout);
}

}  // namespace

// boards int8[B, n, n], sides int32[B], tab uint32[TAFL_NUM_PLANES, 32] ->
// out bool[B, A]. Returns the CUDA error of the launch (0 on success).
extern "C" int tafl_legal_mask(const void* boards, const void* sides,
                               const void* tab, const TaflParams* params, int B,
                               void* out, void* stream) {
  if (B <= 0) return 0;
  const int n = params->n;
  if (n < 3 || n > TAFL_MAX_N) return (int)cudaErrorInvalidValue;
  const int A = n * n * 4 * (n - 1);
  const int g = tafl_group_size(A);
  const int smem_bytes = g * A + 32;
#ifndef TAFL_HOST_SIM
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        tafl_legal_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TAFL_STAGE_BYTES);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
#endif
  TAFL_LAUNCH(tafl_legal_mask_kernel, (B + g - 1) / g, 32 * g, smem_bytes,
              (cudaStream_t)stream, (const int8_t*)boards, (const int*)sides,
              (const uint32_t*)tab, *params, B, g, (uint8_t*)out);
  return (int)cudaGetLastError();
}
