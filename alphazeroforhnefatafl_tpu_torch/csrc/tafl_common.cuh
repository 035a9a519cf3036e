// Shared pieces of the two tafl kernels: the rule switches, the layout of the
// rule table, a game's board as row bit masks held by the lanes of one warp,
// the legal-move ray scan on those masks, and the staged store of the mask.
//
// One warp serves one game. Lane r holds row r of the board as three bit
// masks (attackers, defender soldiers, king; bit c = column c); lanes at and
// beyond n hold zeros. Boards up to 21x21 fit: 21 lanes, 21-bit rows.
//
// The rule table is uint32[TAFL_NUM_PLANES][32]: word [p][i] is plane p's bit
// mask of row i (the *_ROW planes) or of column i (the *_COL planes, bit r =
// row r). It is built in numpy by ops/step_kernel.py (_bit_planes); the plane
// numbers below must match the ones there. At 17 * 128 bytes it stays in L1.
//
// Every warp-wide call below (__shfl_sync, __ballot_sync, ...) names all 32
// lanes, so every lane of the warp must reach it: no lane returns early and
// no such call sits behind a condition that differs between lanes.
#pragma once

#include <cstdint>

#ifdef TAFL_HOST_SIM
#include "sim/simt_host.h"
#define TAFL_LAUNCH(kernel, grid, block, smem, stream, ...) \
  simt::launch((grid), (block), (smem), [&]() { kernel(__VA_ARGS__); })
#define TAFL_DYNAMIC_SHARED(name) uint4* name = simt::dynamic_shared()
#else
#include <cuda_runtime.h>
#define TAFL_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#define TAFL_DYNAMIC_SHARED(name) extern __shared__ uint4 name[]
#endif

#ifndef TAFL_HOST_SIM
// Device indices whose limit the kernels raise; a higher index is refused.
#define TAFL_MAX_DEVICES 64

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device the first time it launches there. cudaFuncSetAttribute holds for
// the current device only, so a process that launches on two cards raises
// it on each; `raised` keeps one flag a device index.
template <typename Kernel>
static cudaError_t tafl_raise_smem_limit(Kernel kernel, int bytes,
                                         bool (&raised)[TAFL_MAX_DEVICES]) {
  int dev = 0, count = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaGetDeviceCount(&count);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= count || dev >= TAFL_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  return cudaSuccess;
}
#endif

// Bulk copies (TMA's one-dimensional form) from global into shared memory,
// each completing on an mbarrier: one thread inits the barrier with the
// copies a phase takes (then a __syncthreads before anyone waits on it) and
// issues each copy, which arrives on the barrier and adds its bytes to the
// phase; every thread that reads the copy waits on that phase's parity.
// Both ends of a copy and its size are multiples of 16 bytes.
#ifndef TAFL_HOST_SIM
__device__ __forceinline__ uint32_t tafl_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void tafl_mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tafl_smem_addr(bar)),
               "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void tafl_bulk_load(void* dst, const void* src, int bytes,
                                               uint64_t* bar) {
  const uint32_t b = tafl_smem_addr(bar);
  // Orders the CTA's earlier reads of dst (a barrier before this call
  // ended them) before the copy engine's writes.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(tafl_smem_addr(dst)), "l"(src), "r"(bytes), "r"(b) : "memory");
}
__device__ __forceinline__ void tafl_mbar_wait(uint64_t* bar, int parity) {
  const uint32_t b = tafl_smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  } while (!done);
}
#else
__device__ __forceinline__ void tafl_mbar_init(uint64_t* bar, int count) {
  simt::mbar_init(bar, count);
}
__device__ __forceinline__ void tafl_bulk_load(void* dst, const void* src, int bytes,
                                               uint64_t* bar) {
  simt::bulk_load(dst, src, bytes, bar);
}
__device__ __forceinline__ void tafl_mbar_wait(uint64_t* bar, int parity) {
  simt::mbar_wait(bar, parity);
}
#endif

// Cell codes (core/rules.py).
#define TAFL_EMPTY 0
#define TAFL_ATT 1
#define TAFL_DEF 2
#define TAFL_KING 3

// Planes of the rule table. Piece class cls = cell code - 1.
#define TAFL_PL_OCC_ROW(cls) (0 + (cls))      // tiles the class may stand on
#define TAFL_PL_PASS_ROW(cls) (3 + (cls))     // tiles the class may pass
#define TAFL_PL_OCC_COL(cls) (6 + (cls))      // the same two, by column
#define TAFL_PL_PASS_COL(cls) (9 + (cls))
#define TAFL_PL_HOSTILE_ROW(cls) (12 + (cls)) // empty special tiles hostile to it
#define TAFL_PL_CORNER_ROW 15
#define TAFL_PL_EDGE_ROW 16
#define TAFL_NUM_PLANES 17

#define TAFL_MAX_N 21
#define TAFL_FULL 0xffffffffu

// Number of int32 scalars the step kernel writes per game (see SCALAR_ROWS in
// ops/step_kernel.py).
#define TAFL_NUM_SCALARS 24

// Games per CTA (one warp each), and the dynamic shared memory a CTA may ask
// for its staged masks. Four games measured best or equal to the best of 1,
// 2, 4 and 8 at B = 256, 1024 and 4096 on the H100.
#define TAFL_GROUP 4
#define TAFL_STAGE_BYTES (96 * 1024)

// Rule switches of one ruleset: one compiled kernel serves every preset.
// Mirrored field for field by ops/step_kernel.TaflParams (ctypes); all ints,
// and per-class facts are bit fields (bit cls), so that nothing is indexed
// at run time and the struct stays in the constant bank.
struct TaflParams {
  int n;
  int thr_r;                // throne cell
  int thr_c;
  int slow_bits;            // class moves one tile at a time
  int king_attacks;         // king may initiate captures
  int king_hostile_when_enemy;
  int king_strength;        // KingStrength: 0 strong, 1 by throne, 2 weak
  int special_rules_on;     // strong-by-throne king beside the throne
  int linnaean;
  int enclosure_win;        // -1 off, else EnclosureWinRules
  int exit_fort;
  int sw_on;                // shieldwall captures on
  int sw_caps_bits;         // shieldwall may capture the class
  int sw_corners_close;     // a corner may close a shieldwall
  int edge_hostile_bits;    // off-board tiles hostile to the class
  int edge_escape;
  int rep_n;                // repetitions that end the game; 0 = no rule
  int rep_is_loss;
  int draw_on_no_plays;
};

struct TaflRows {
  uint32_t att, def, king;
};

__device__ __forceinline__ int tafl_dr(int d) { return d == 0 ? -1 : (d == 1 ? 1 : 0); }
__device__ __forceinline__ int tafl_dc(int d) { return d == 2 ? -1 : (d == 3 ? 1 : 0); }
__device__ __forceinline__ int tafl_min(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int tafl_max(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int tafl_clamp(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ uint32_t tafl_plane(const uint32_t* __restrict__ tab,
                                               int plane, int i) {
  return __ldg(tab + plane * 32 + i);
}

// Lane r reads row r of one game's int8[n, n] board into bit masks.
__device__ __forceinline__ TaflRows tafl_load_rows(const int8_t* __restrict__ board,
                                                   int n, int lane) {
  TaflRows b = {0u, 0u, 0u};
  if (lane < n) {
    const int8_t* row = board + lane * n;
    for (int c = 0; c < n; ++c) {
      const int v = row[c];
      b.att |= (uint32_t)(v == TAFL_ATT) << c;
      b.def |= (uint32_t)(v == TAFL_DEF) << c;
      b.king |= (uint32_t)(v == TAFL_KING) << c;
    }
  }
  return b;
}

// Legal distances of one ray toward higher positions of a line (a row or a
// column): bit j - 1 is distance j. `stop` holds the line's tiles that end
// the ray (occupied or not passable), `dest` its tiles the piece may land on
// (empty and occupiable, on the board). A destination at distance j is legal
// when every tile at distances 1..j-1 is open (ValidPlayIterator +
// validate_play_for_side, game/play.rs:189-225, game/game/logic.rs:159-214),
// so the first stopping tile may itself still be a destination.
__device__ __forceinline__ uint32_t tafl_ray_bits(uint32_t stop, uint32_t dest) {
  const int first = __ffs(stop);  // 1-based distance of the first stop, 0 = none
  return first == 0 ? dest : dest & (0xffffffffu >> (32 - first));
}
__device__ __forceinline__ uint32_t tafl_ray_higher(uint32_t stop, uint32_t dest,
                                                    int pos) {
  return tafl_ray_bits(stop >> (pos + 1), dest >> (pos + 1));
}
// Toward lower positions: the line is reversed so that position pos - 1 lands
// on bit 0.
__device__ __forceinline__ uint32_t tafl_ray_lower(uint32_t stop, uint32_t dest,
                                                   int pos) {
  if (pos == 0) return 0u;
  return tafl_ray_bits(__brev(stop << (32 - pos)), __brev(dest << (32 - pos)));
}

// Sets the bytes of `dst` named by `bits`; returns whether there were any.
__device__ __forceinline__ bool tafl_put_bits(uint8_t* dst, uint32_t bits) {
  const bool any = bits != 0u;
  while (bits) {
    dst[__ffs(bits) - 1] = 1;
    bits &= bits - 1u;
  }
  return any;
}

// The rays of every piece of one move class on one line held by this lane.
// `movers` are the class's pieces on the line; `cell0 + i * cell_step` is the
// board cell of position i; `dir_lower` / `dir_higher` are the action
// directions toward lower and higher positions.
__device__ __forceinline__ bool tafl_scan_line(uint32_t movers, uint32_t occ,
                                               uint32_t occupiable, uint32_t passable,
                                               uint32_t slow, int n, int cell0,
                                               int cell_step, int dir_lower,
                                               int dir_higher, uint8_t* stage) {
  const int nd = n - 1;
  const uint32_t stop = occ | ~passable;
  const uint32_t dest = ~occ & occupiable & ((1u << n) - 1u);
  bool any = false;
  while (movers) {
    const int pos = __ffs(movers) - 1;
    movers &= movers - 1u;
    uint8_t* row = stage + (cell0 + pos * cell_step) * 4 * nd;
    any |= tafl_put_bits(row + dir_lower * nd, tafl_ray_lower(stop, dest, pos) & slow);
    any |= tafl_put_bits(row + dir_higher * nd, tafl_ray_higher(stop, dest, pos) & slow);
  }
  return any;
}

// The legal-action mask of `side` on the board `b`, by one warp. `stage`
// points at the game's A zeroed bytes; a 1 is written for every legal action,
// in action order (cell, dir, dist). Returns whether any action is legal,
// the same value in every lane.
//
// Rows are scanned with lane = row. For the columns the warp transposes the
// occupancy and the movers' masks with one ballot per column, and scans with
// lane = column. A ray is one __ffs on the line's mask; only pieces of the
// side to move do any work.
__device__ __forceinline__ bool tafl_warp_mask(const TaflRows& b, int side,
                                               const uint32_t* __restrict__ tab,
                                               const TaflParams& p, int lane,
                                               uint8_t* stage) {
  const int n = p.n;
  const uint32_t occ = b.att | b.def | b.king;
  // The mover's piece classes: attackers, or defender soldiers and the king.
  const int cls0 = side == 0 ? 0 : 1;
  const uint32_t m0 = side == 0 ? b.att : b.def;
  const uint32_t m1 = side == 0 ? 0u : b.king;
  uint32_t occ_col = 0u, m0_col = 0u, m1_col = 0u;
  for (int c = 0; c < n; ++c) {
    const uint32_t o = __ballot_sync(TAFL_FULL, (occ >> c) & 1u);
    const uint32_t x0 = __ballot_sync(TAFL_FULL, (m0 >> c) & 1u);
    if (lane == c) {
      occ_col = o;
      m0_col = x0;
    }
  }
  if (side != 0) {  // the same in every lane: a warp is one game
    for (int c = 0; c < n; ++c) {
      const uint32_t x1 = __ballot_sync(TAFL_FULL, (m1 >> c) & 1u);
      if (lane == c) m1_col = x1;
    }
  }
  bool any = false;
  if (lane < n) {
    for (int k = 0; k < 2; ++k) {
      const int cls = k == 0 ? cls0 : 2;
      const uint32_t row_movers = k == 0 ? m0 : m1;
      const uint32_t col_movers = k == 0 ? m0_col : m1_col;
      const uint32_t slow = ((p.slow_bits >> cls) & 1) ? 1u : 0xffffffffu;
      // All four loads are issued before the first is needed.
      const uint32_t occ_r = tafl_plane(tab, TAFL_PL_OCC_ROW(cls), lane);
      const uint32_t pass_r = tafl_plane(tab, TAFL_PL_PASS_ROW(cls), lane);
      const uint32_t occ_c = tafl_plane(tab, TAFL_PL_OCC_COL(cls), lane);
      const uint32_t pass_c = tafl_plane(tab, TAFL_PL_PASS_COL(cls), lane);
      if (row_movers) {  // directions 2 (left) and 3 (right)
        any |= tafl_scan_line(row_movers, occ, occ_r, pass_r, slow, n, lane * n, 1, 2, 3,
                              stage);
      }
      if (col_movers) {  // directions 0 (up) and 1 (down)
        any |= tafl_scan_line(col_movers, occ_col, occ_c, pass_c, slow, n, lane, n, 0, 1,
                              stage);
      }
    }
  }
  return __any_sync(TAFL_FULL, any) != 0;
}

// The staged store. A CTA serves `count` consecutive games whose mask rows
// are one span of `span` bytes starting at `gout`. The span is built in
// shared memory at the offset `shift` = gout mod 16, so that 16-byte chunks
// of shared and of global memory line up; the whole chunks then go out in
// one bulk copy from shared to global memory, and the ragged head and tail
// byte by byte.
__device__ __forceinline__ int tafl_stage_shift(const uint8_t* gout) {
  return (int)((uintptr_t)gout & 15u);
}

// Every thread of the CTA calls it; a __syncthreads must follow.
__device__ __forceinline__ void tafl_stage_zero(uint4* smem, int bytes) {
  const int chunks = (bytes + 15) >> 4;
  uint4 zero;
  zero.x = zero.y = zero.z = zero.w = 0u;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) smem[i] = zero;
}

// Every thread of the CTA calls it after its last write to the staged span
// and before the __syncthreads that precedes tafl_stage_flush.
__device__ __forceinline__ void tafl_stage_fence() {
#ifndef TAFL_HOST_SIM
  // Makes this thread's shared-memory writes visible to the bulk copy engine.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

// Every thread of the CTA calls it, after a __syncthreads.
__device__ __forceinline__ void tafl_stage_flush(const uint4* smem, int shift,
                                                 int span, uint8_t* gout) {
  const uint8_t* sbytes = (const uint8_t*)smem;
  uint8_t* gbase = gout - shift;  // 16-byte aligned
  const int end = shift + span;
#ifndef TAFL_HOST_SIM
  // One bulk copy (TMA's one-dimensional form) of the span's whole 16-byte
  // chunks, issued by one thread; the ragged head and tail byte by byte.
  const int body_lo = tafl_min((shift + 15) & ~15, end);
  const int body_hi = tafl_max(end & ~15, body_lo);
  for (int j = shift + threadIdx.x; j < body_lo; j += blockDim.x) gbase[j] = sbytes[j];
  for (int j = body_hi + threadIdx.x; j < end; j += blockDim.x) gbase[j] = sbytes[j];
  if (threadIdx.x == 0 && body_hi > body_lo) {
    const uint32_t src = (uint32_t)__cvta_generic_to_shared(sbytes + body_lo);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 :: "l"(gbase + body_lo), "r"(src), "r"(body_hi - body_lo) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // The CTA's shared memory must outlive the copy's reads of it.
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
#else
  // The host simulation has no copy engine: the same copy with one uint4
  // store per whole chunk.
  const int chunks = (end + 15) >> 4;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const int lo = i << 4, hi = lo + 16;
    if (lo >= shift && hi <= end) {
      ((uint4*)gbase)[i] = smem[i];
    } else {
      for (int j = tafl_max(lo, shift); j < tafl_min(hi, end); ++j) gbase[j] = sbytes[j];
    }
  }
#endif
}

// Games per CTA: TAFL_GROUP, or as many as fit the staging budget on the
// largest boards (3 at 19x19 and 20x20, 2 at 21x21). At 19x19 three masks are
// not a multiple of 16 bytes, so every other CTA's span starts 8 bytes off a
// 16-byte boundary: the case tafl_stage_shift is for.
static inline int tafl_group_size(int num_actions) {
  const int fit = (TAFL_STAGE_BYTES - 32) / num_actions;
  return fit < TAFL_GROUP ? fit : TAFL_GROUP;
}
