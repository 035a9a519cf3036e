// Legal-action mask of the side to move, for a batch of games.
//
// Replaces the Pallas TPU kernel of alphazeroforhnefatafl_tpu/ops/legal_mask.py
// (_build_kernel, launched by _make_batched_mask_fn). One thread per
// (game, cell) walks the four rays of the piece on its cell and writes the
// 4 * (n - 1) bytes of that cell's row of bool[B, A], in action order.
//
// What bounds it: the output. At 11x11 a game's mask is 4840 bytes and its
// board 121, so the kernel is a store stream of B * A bytes with a few
// cached board reads per byte; there is no arithmetic to speak of. The rows
// of neighbouring threads are contiguous, so a warp's stores together cover
// one contiguous span of 32 * 40 bytes. Each store instruction still writes
// one byte per thread, 4 * (n - 1) bytes apart; staging the rows in shared memory
// for vector stores is left for when this kernel matters.
#include <cuda_runtime.h>

#include "tafl_common.cuh"

__global__ void tafl_legal_mask_kernel(const int8_t* __restrict__ boards,
                                       const int* __restrict__ sides,
                                       const int* __restrict__ table, int C,
                                       TaflParams p, int B,
                                       uint8_t* __restrict__ out) {
  const int nn = p.n * p.n;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * nn) return;
  const int b = (int)(idx / nn);
  const int cell = (int)(idx - (long long)b * nn);
  const int per_cell = 4 * (p.n - 1);
  tafl_ray_scan_cell(boards + (long long)b * nn, cell, sides[b], table, C, p,
                     out + idx * per_cell);
}

// boards int8[B, n, n], sides int32[B], table int32[nn, C] -> out bool[B, A].
// Returns the CUDA error of the launch (0 on success).
extern "C" int tafl_legal_mask(const void* boards, const void* sides,
                               const void* table, int C,
                               const TaflParams* params, int B, void* out,
                               void* stream) {
  if (B <= 0) return 0;
  const int nn = params->n * params->n;
  const int threads = 256;
  const long long total = (long long)B * nn;
  const int blocks = (int)((total + threads - 1) / threads);
  tafl_legal_mask_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)boards, (const int*)sides, (const int*)table, C, *params,
      B, (uint8_t*)out);
  return (int)cudaGetLastError();
}
