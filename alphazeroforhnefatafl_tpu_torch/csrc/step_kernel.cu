// One env step per game, for a batch of games.
//
// Replaces the Pallas TPU kernel of alphazeroforhnefatafl_tpu/ops/step_kernel.py
// (_build_step_kernel, launched by _make_step_fn). It computes, per game:
// action decode and move; custodian captures (logic.rs:604-699); shieldwall
// captures (logic.rs:471-569); the surround-win and exit-fort flood fills
// (logic.rs:309-463, 572-601); the next player's legal mask, which is also
// the NoPlays check; the repetition ring (state.rs:92-113); and the outcome
// priority select (logic.rs:702-771).
//
// Design: one CTA per game and one thread per cell (blockDim = nn rounded up
// to 32; 448 at 21x21). The board lives in shared memory. Each cell decides
// its own custodian capture; thread 0 walks the shieldwall edge lane as the
// reference does; the floods iterate neighbour propagation until a
// __syncthreads_or says nothing changed; the next-player mask reuses the
// legal-mask kernel's ray scan; thread 0 runs the repetition ring and the
// outcome select and writes the 24 scalars.
//
// What bounds it: latency, not bandwidth. A game's inputs are ~150 bytes and
// its outputs ~5 KB (the mask), but the floods and the lane walk are chains
// of dependent steps with a block barrier each. The design keeps every step
// in shared memory and runs one game per CTA so that many games are in
// flight on each SM and hide one another's barriers.
#include <cuda_runtime.h>

#include "tafl_common.cuh"

namespace {

__device__ __forceinline__ bool in_board(int r, int c, int n) {
  return r >= 0 && r < n && c >= 0 && c < n;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// tile_hostile (logic.rs:85-99): is cell t of `bd` hostile to piece class cls?
__device__ __forceinline__ bool hostile_at(const int8_t* bd, int cls, int t,
                                           const int* table, int C,
                                           const TaflParams& p) {
  const int v = bd[t];
  const bool special =
      v == TAFL_EMPTY && table[t * C + TAFL_COL_SPECIAL_HOSTILE(cls)] != 0;
  if (cls == 0) {
    return v == TAFL_DEF || (p.king_hostile_when_enemy && v == TAFL_KING) ||
           special;
  }
  return v == TAFL_ATT || special;
}

// coords_hostile (logic.rs:103-114): off-board tiles are hostile iff the edge
// is hostile to cls.
__device__ __forceinline__ bool coords_hostile(const int8_t* bd, int cls,
                                               int r, int c, const int* table,
                                               int C, const TaflParams& p) {
  if (!in_board(r, c, p.n)) return p.edge_hostile[cls] != 0;
  return hostile_at(bd, cls, r * p.n + c, table, C, p);
}

// Grows `reach` from the seed cells to the whole 4-connected component of
// the allowed cells. Every thread of the block must call it.
__device__ void flood(uint8_t* reach, bool on, int cell, int r, int c, int n,
                      bool allowed, bool seed) {
  if (on) reach[cell] = (seed && allowed) ? 1 : 0;
  __syncthreads();
  while (true) {
    bool grow = false;
    if (on && !reach[cell] && allowed) {
      grow = (r > 0 && reach[cell - n]) || (r < n - 1 && reach[cell + n]) ||
             (c > 0 && reach[cell - 1]) || (c < n - 1 && reach[cell + 1]);
    }
    __syncthreads();
    if (grow) reach[cell] = 1;
    if (!__syncthreads_or(grow)) break;
  }
}

__device__ __forceinline__ bool touches(const uint8_t* reach, int cell, int r,
                                        int c, int n) {
  return reach[cell] || (r > 0 && reach[cell - n]) ||
         (r < n - 1 && reach[cell + n]) || (c > 0 && reach[cell - 1]) ||
         (c < n - 1 && reach[cell + 1]);
}

// enclosure_secure for one boundary piece (logic.rs:408-463): along each
// axis, at least one neighbour must make the piece safe.
__device__ bool secure_cell(const int8_t* bd, const uint8_t* region, int r,
                            int c, int b_cls, int hs_cls, bool inside_safe,
                            bool outside_safe, const int* table, int C,
                            const TaflParams& p) {
  const int n = p.n;
  bool all_axes = true;
  for (int axis = 0; axis < 2; ++axis) {
    bool safe = false;
    for (int j = 0; j < 2; ++j) {
      const int d = 2 * axis + j;
      const int ar = r + tafl_dr(d), ac = c + tafl_dc(d);
      if (!in_board(ar, ac, n)) {
        safe = safe || !p.edge_hostile[b_cls];
        continue;
      }
      const int t = ar * n + ac;
      const bool inside = region[t] != 0;
      const bool known = (inside_safe && inside) || (outside_safe && !inside);
      const bool safe_a =
          known && table[t * C + TAFL_COL_SPECIAL_HOSTILE(b_cls)] == 0;
      const bool safe_b =
          !hostile_at(bd, b_cls, t, table, C, p) &&
          (bd[t] != TAFL_EMPTY || table[t * C + TAFL_COL_CLS_OCC(hs_cls)] == 0);
      safe = safe || safe_a || safe_b;
    }
    all_axes = all_axes && safe;
  }
  return all_axes;
}

__global__ void tafl_step_kernel(
    const int8_t* __restrict__ boards, const int* __restrict__ sides,
    const int* __restrict__ actions, const int* __restrict__ recent,
    const int* __restrict__ first_i, const int* __restrict__ reps,
    const uint8_t* __restrict__ mid_pair, const int* __restrict__ psc,
    const int* __restrict__ table, int C, TaflParams p,
    int8_t* __restrict__ board3_out, uint8_t* __restrict__ cap_out,
    uint8_t* __restrict__ mask_out, int* __restrict__ scal_out) {
  __shared__ int8_t sb2[TAFL_MAX_NN];  // board after the move
  __shared__ int8_t sb3[TAFL_MAX_NN];  // board after the captures
  __shared__ uint8_t swall[TAFL_MAX_NN];
  __shared__ uint8_t reach[TAFL_MAX_NN];
  __shared__ int s_king;
  __shared__ int s_king_captured;

  const int n = p.n, nn = n * n, nd = n - 1;
  const int b = blockIdx.x;
  const int cell = threadIdx.x;
  const bool on = cell < nn;
  const int r = on ? cell / n : 0;
  const int c = on ? cell - r * n : 0;
  const int8_t* board = boards + (long long)b * nn;
  const int side = sides[b];
  const int action = actions[b];

  // ---- action decode (core/actions.py) ----
  const int per_tile = 4 * nd;
  const int from = action / per_tile;
  const int rem = action - from * per_tile;
  const int dir = rem / nd;
  const int dist = rem - dir * nd + 1;
  const int fr = from / n, fc = from - (from / n) * n;
  const int tr = fr + tafl_dr(dir) * dist, tc = fc + tafl_dc(dir) * dist;
  const bool to_in_b = in_board(tr, tc, n);
  const int trc = clampi(tr, 0, n - 1), tcc = clampi(tc, 0, n - 1);
  const int to = trc * n + tcc;
  // Actions lie in [0, A); the guard only keeps a bad one inside the board.
  const int moving = (from >= 0 && from < nn) ? board[from] : TAFL_EMPTY;
  const int moving_side = moving == TAFL_ATT ? 0 : 1;
  const bool valid_basic =
      to_in_b && moving != TAFL_EMPTY && moving_side == side;

  // ---- move the piece ----
  if (on) {
    int v = board[cell];
    if (cell == from) v = TAFL_EMPTY;
    if (cell == to) v = moving;
    sb2[cell] = (int8_t)v;
    swall[cell] = 0;
  }
  if (threadIdx.x == 0) s_king = nn;
  __syncthreads();
  // King position on the post-move board: the first king cell, 0 if none.
  if (on && sb2[cell] == TAFL_KING) atomicMin(&s_king, cell);
  __syncthreads();
  const int kflat = s_king == nn ? 0 : s_king;
  const int kr = kflat / n, kc = kflat - (kflat / n) * n;
  const int thr_r = p.thr_flat / n, thr_c = p.thr_flat - (p.thr_flat / n) * n;

  // ---- king strength (logic.rs:225-245) ----
  const bool king_on_throne = kflat == p.thr_flat;
  const int kdist = abs(kr - thr_r) + abs(kc - thr_c);
  const bool king_beside = kdist == 1;
  const bool king_strong = p.king_strength == 0
                               ? true
                               : (p.king_strength == 2
                                      ? false
                                      : (king_on_throne || king_beside));
  const bool may_attack = moving != TAFL_KING || p.king_attacks;

  // ---- Linnaean precondition (logic.rs:859-879) ----
  bool linn_ok = false;
  if (p.linnaean) {
    int cnt = 0;
    for (int d = 0; d < 4; ++d) {
      cnt += coords_hostile(sb2, 2, thr_r + tafl_dr(d), thr_c + tafl_dc(d),
                            table, C, p)
                 ? 1
                 : 0;
    }
    linn_ok = side == 0 && king_on_throne && cnt == 3;
  }

  // ---- custodian captures: each neighbour of the destination decides its own
  bool cap = false;
  if (on) {
    int dg = -1;
    for (int d = 0; d < 4; ++d) {
      if (r == trc + tafl_dr(d) && c == tcc + tafl_dc(d)) dg = d;
    }
    if (dg >= 0) {
      const int dr = tafl_dr(dg), dc = tafl_dc(dg);
      const int q = sb2[cell];
      const bool enemy = side == 0 ? (q == TAFL_DEF || q == TAFL_KING)
                                   : q == TAFL_ATT;
      const int q_cls = clampi(q - 1, 0, 2);
      const int far_r = trc + 2 * dr, far_c = tcc + 2 * dc;
      const bool far_h = coords_hostile(sb2, q_cls, far_r, far_c, table, C, p);
      bool p1, p2;
      if (dr == 0) {
        p1 = coords_hostile(sb2, 2, r + 1, c, table, C, p);
        p2 = coords_hostile(sb2, 2, r - 1, c, table, C, p);
      } else {
        p1 = coords_hostile(sb2, 2, r, c + 1, table, C, p);
        p2 = coords_hostile(sb2, 2, r, c - 1, table, C, p);
      }
      const bool king_cust = far_h && (!king_strong || (p1 && p2));
      bool king_special = false;
      if (p.special_rules_on) {
        bool all_nbr = true;
        for (int d2 = 0; d2 < 4; ++d2) {
          const int ar = r + tafl_dr(d2), ac = c + tafl_dc(d2);
          if (!in_board(ar, ac, n)) continue;
          const int t = ar * n + ac;
          all_nbr = all_nbr &&
                    (t == p.thr_flat || hostile_at(sb2, 2, t, table, C, p));
        }
        king_special = king_beside && all_nbr;
      }
      const bool king_capt = king_special || king_cust;
      const bool linn_here = linn_ok && far_r == thr_r && far_c == thr_c &&
                             q == TAFL_DEF;
      const bool soldier_capt = far_h || linn_here;
      cap = enemy && may_attack && (q == TAFL_KING ? king_capt : soldier_capt);
    }
  }

  // ---- shieldwall (logic.rs:471-569): thread 0 walks the edge lane ----
  if (p.sw_on && threadIdx.x == 0) {
    // Lane priority as the reference: row 0, row n-1, column 0, column n-1.
    const int lane_case =
        trc == 0 ? 0 : (trc == n - 1 ? 1 : (tcc == 0 ? 2 : (tcc == n - 1 ? 3 : 4)));
    if (lane_case < 4) {
      // Lane tile i and the tile one step off the edge from it.
      auto lane = [&](int i) {
        return lane_case == 0 ? i
                              : (lane_case == 1 ? (n - 1) * n + i
                                                : (lane_case == 2 ? i * n : i * n + n - 1));
      };
      auto pin = [&](int i) {
        return lane_case == 0 ? n + i
                              : (lane_case == 1 ? (n - 2) * n + i
                                                : (lane_case == 2 ? i * n + 1 : i * n + n - 2));
      };
      auto enemy_pinned = [&](int i) {
        const int v = sb2[lane(i)];
        if (v == TAFL_EMPTY || (v == TAFL_ATT ? 0 : 1) == side) return false;
        const int pv = sb2[pin(i)];
        return pv != TAFL_EMPTY && (pv == TAFL_ATT ? 0 : 1) == side;
      };
      auto closing_corner = [&](int i) {
        return table[lane(i) * C + TAFL_COL_CC] != 0;
      };
      auto extender = [&](int i) { return enemy_pinned(i) && !closing_corner(i); };
      auto closer = [&](int i) {
        const int v = sb2[lane(i)];
        const bool friendly = v != TAFL_EMPTY && (v == TAFL_ATT ? 0 : 1) == side;
        return friendly || (v == TAFL_EMPTY && closing_corner(i)) ||
               (enemy_pinned(i) && closing_corner(i));
      };
      const int pos0 = lane_case < 2 ? tcc : trc;
      // The reference tries the negative direction first (logic.rs:551-554).
      for (int step = -1; step <= 1; step += 2) {
        int q = pos0 + step;
        while (q >= 0 && q < n && extender(q)) q += step;
        const bool q_in = q >= 0 && q < n;
        const bool close = q_in && closer(q);
        const bool incl_q = q_in && enemy_pinned(q) && closing_corner(q);
        const int lo = pos0 < q ? pos0 : q, hi = pos0 < q ? q : pos0;
        const int count = hi - lo - 1 + (incl_q ? 1 : 0);
        if (close && count >= 2) {
          for (int i = 0; i < n; ++i) {
            const bool in_wall = (i > lo && i < hi) || (incl_q && i == q);
            if (!in_wall) continue;
            const int v = sb2[lane(i)];
            if (v != TAFL_EMPTY && p.sw_caps[v - 1]) swall[lane(i)] = 1;
          }
          break;
        }
      }
    }
  }
  __syncthreads();
  if (on) cap = cap || swall[cell];

  // ---- board after the captures ----
  int v3 = TAFL_EMPTY;
  if (on) {
    v3 = cap ? TAFL_EMPTY : sb2[cell];
    sb3[cell] = (int8_t)v3;
    board3_out[(long long)b * nn + cell] = (int8_t)v3;
    cap_out[(long long)b * nn + cell] = cap ? 1 : 0;
    if (cell == kflat) s_king_captured = cap ? 1 : 0;
  }
  const int n_caps = __syncthreads_count(on && cap);
  const int n_att3 = __syncthreads_count(on && v3 == TAFL_ATT);
  const int n_def3 =
      __syncthreads_count(on && (v3 == TAFL_DEF || v3 == TAFL_KING));
  const bool is_corner = on && table[cell * C + TAFL_COL_CORNER] != 0;
  const bool is_edge = on && table[cell * C + TAFL_COL_EDGE] != 0;

  // ---- attacker surround win (logic.rs:720-734) ----
  // The reference aborts a fill once it has failed; a fill run to its
  // fixpoint gives the same verdict because every fail test grows with the
  // reached set.
  bool o_enclosed = false;
  if (p.enclosure_win >= 0) {
    const bool defender3 = v3 == TAFL_DEF || v3 == TAFL_KING;
    flood(reach, on, cell, r, c, n, v3 == TAFL_EMPTY || defender3,
          side == 0 && cell == kflat);
    const bool in_reach = on && reach[cell];
    const bool fail = __syncthreads_or(
        in_reach && (is_corner || (p.enclosure_win == 1 && is_edge)));
    const int def_in = __syncthreads_count(in_reach && defender3);
    const bool boundary =
        on && !in_reach && v3 == TAFL_ATT && touches(reach, cell, r, c, n);
    const bool insecure = boundary && !secure_cell(sb3, reach, r, c, 0, 1,
                                                   false, true, table, C, p);
    const bool any_insecure = __syncthreads_or(insecure);
    o_enclosed = !fail && def_in == n_def3 && !any_insecure;
  }

  // ---- defender exit fort (logic.rs:572-601) ----
  bool o_exit_fort = false;
  if (p.exit_fort) {
    const bool king_at_edge = table[kflat * C + TAFL_COL_EDGE] != 0;
    flood(reach, on, cell, r, c, n, v3 == TAFL_EMPTY || cell == kflat,
          side == 1 && king_at_edge && cell == kflat);
    const bool in_reach = on && reach[cell];
    const bool near = on && touches(reach, cell, r, c, n);
    const bool fail_neither = __syncthreads_or(near && v3 == TAFL_ATT);
    const bool fail_corner = __syncthreads_or(in_reach && is_corner);
    const bool boundary = near && !in_reach && v3 == TAFL_DEF;
    const bool insecure = boundary && !secure_cell(sb3, reach, r, c, 1, 0,
                                                   true, false, table, C, p);
    const bool any_insecure = __syncthreads_or(insecure);
    bool king_free = false;
    for (int d = 0; d < 4; ++d) {
      const int ar = kr + tafl_dr(d), ac = kc + tafl_dc(d);
      king_free = king_free ||
                  (in_board(ar, ac, n) && sb3[ar * n + ac] == TAFL_EMPTY);
    }
    o_exit_fort = king_at_edge && !fail_neither && !fail_corner && king_free &&
                  !any_insecure;
  }

  // ---- next player's legal mask on the post-capture board ----
  bool any_play = false;
  if (on) {
    any_play = tafl_ray_scan_cell(
        sb3, cell, 1 - side, table, C, p,
        mask_out + ((long long)b * nn + cell) * per_tile);
  }
  const bool has_play = __syncthreads_or(any_play);

  if (threadIdx.x != 0) return;

  // ---- repetition ring (state.rs:92-113) ----
  const int* ring = recent + 4 * b;
  const int fi = first_i[b];
  const int reps_att = reps[2 * b], reps_def = reps[2 * b + 1];
  const int mid_att = mid_pair[2 * b], mid_def = mid_pair[2 * b + 1];
  const int capt_any = n_caps > 0 ? 1 : 0;
  const int rec = side + 2 * capt_any + 4 * action;
  const int oldest = (fi >= 0 && fi < 4) ? ring[fi] : 0;
  const bool match = !capt_any && oldest == rec;
  const bool side_att = side == 0;
  const int mid = side_att ? mid_att : mid_def;
  const int cur = side_att ? reps_att : reps_def;
  const int new_rep_side = match ? cur + (mid ? 0 : 1) : 0;
  const int new_mid_side = (match && !mid) ? 1 : 0;

  // ---- outcome priority select (logic.rs:702-771) ----
  const bool to_at_edge = table[to * C + TAFL_COL_EDGE] != 0;
  const bool to_at_corner = table[to * C + TAFL_COL_CORNER] != 0;
  const bool king_captured = s_king_captured != 0;
  const int other_count = side_att ? n_def3 : n_att3;
  const bool escape_tile = p.edge_escape ? to_at_edge : to_at_corner;
  const bool conds[7] = {
      other_count == 0,                                // all captured
      side_att && king_captured,                       // king captured
      side_att && o_enclosed,                          // enclosed
      !side_att && moving == TAFL_KING && escape_tile,  // king escaped
      !side_att && o_exit_fort,                        // exit fort
      p.rep_n > 0 && new_rep_side >= p.rep_n,          // repetition
      !has_play,                                       // no plays
  };
  const int results[7] = {
      side, 0, 0, 1, 1, p.rep_is_loss ? 1 - side : 2,
      p.draw_on_no_plays ? 2 : side};
  const int reasons[7] = {3, 2, 4, 0, 1, p.rep_is_loss ? 6 : 16,
                          p.draw_on_no_plays ? 17 : 5};
  int result = -1, reason = -1, done = 0;
  for (int i = 0; i < 7; ++i) {
    if (conds[i] && !done) {
      result = results[i];
      reason = reasons[i];
      done = 1;
    }
  }

  int* out = scal_out + (long long)b * TAFL_NUM_SCALARS;
  out[0] = valid_basic ? 1 : 0;
  out[1] = moving;
  out[2] = trc;
  out[3] = tcc;
  out[4] = kflat;
  out[5] = king_captured ? 1 : 0;
  out[6] = to_at_edge ? 1 : 0;
  out[7] = to_at_corner ? 1 : 0;
  out[8] = o_enclosed ? 1 : 0;
  out[9] = o_exit_fort ? 1 : 0;
  out[10] = result;
  out[11] = reason;
  out[12] = done;
  out[13] = (fi + 1) % 4;
  out[14] = side_att ? new_rep_side : reps_att;
  out[15] = side_att ? reps_def : new_rep_side;
  out[16] = side_att ? new_mid_side : mid_att;
  out[17] = side_att ? mid_def : new_mid_side;
  out[18] = psc[b] + (1 - capt_any);
  for (int i = 0; i < 4; ++i) out[19 + i] = (fi == i) ? rec : ring[i];
  out[23] = n_caps;
}

}  // namespace

// One step of B games. Inputs: boards int8[B, n, n], sides/actions int32[B],
// recent int32[B, 4], first_i int32[B], reps int32[B, 2], mid_pair
// bool[B, 2], psc int32[B], table int32[nn, C]. Outputs: board3 int8[B, n, n],
// cap bool[B, n, n], mask bool[B, A], scal int32[B, 24]. Returns the CUDA
// error of the launch (0 on success).
extern "C" int tafl_step(const void* boards, const void* sides,
                         const void* actions, const void* recent,
                         const void* first_i, const void* reps,
                         const void* mid_pair, const void* psc,
                         const void* table, int C, const TaflParams* params,
                         int B, void* board3, void* cap, void* mask,
                         void* scal, void* stream) {
  if (B <= 0) return 0;
  const int nn = params->n * params->n;
  if (nn > TAFL_MAX_NN || params->n < 3 || C < TAFL_NUM_COLS) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = (nn + 31) / 32 * 32;
  tafl_step_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)boards, (const int*)sides, (const int*)actions,
      (const int*)recent, (const int*)first_i, (const int*)reps,
      (const uint8_t*)mid_pair, (const int*)psc, (const int*)table, C,
      *params, (int8_t*)board3, (uint8_t*)cap, (uint8_t*)mask, (int*)scal);
  return (int)cudaGetLastError();
}
