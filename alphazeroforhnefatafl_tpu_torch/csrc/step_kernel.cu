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
// What bounds it: bytes. At 11x11 a game reads 163 bytes and writes 5178
// (two 121-byte boards, the 4840-byte mask, 96 bytes of scalars), with no
// arithmetic to speak of. What stands between the kernel and that bound:
// at small batches the latency of a step's dependent phases, at large ones
// the number of instructions those phases issue per game.
//
// Design for the H100: one warp per game, a CTA of four games, and no block
// barrier inside a step. The board lives in registers as row bit masks (lane
// = row, tafl_common.cuh), so
//  - the move, the king's position and the piece counts are lane-local bit
//    updates, ballots, shuffles and warp sums;
//  - the four neighbours of the destination are judged by four lanes at once,
//    each reading the few cells it needs by shuffles;
//  - a shieldwall is judged on the edge lane as one bit mask (a row by
//    shuffle, a column by ballot): the run of pinned enemies ends at the
//    nearest bit that does not extend it, negative direction first;
//  - a flood fill grows `reach` per lane, to the end of its row's allowed run
//    by log-step shifts and by one row up and down per iteration through
//    shuffles, until a vote reports no change; a flood whose seed is empty
//    (the side to move decides it, and a warp is one game) is skipped, and
//    its verdict is what an empty reach gives;
//  - the security of a region's boundary is evaluated on the masks of a row
//    and its two neighbours;
//  - the next player's mask is the legal-mask kernel's scan and staged store,
//    the CTA's games forming the group (the only two block barriers: after
//    the zero fill and before the copy out);
//  - every lane computes the ring, the outcome and the scalars; lanes 0-23
//    store one scalar each, one 96-byte store.
#include "tafl_common.cuh"

namespace {

__device__ __forceinline__ bool in_board(int r, int c, int n) {
  return r >= 0 && r < n && c >= 0 && c < n;
}

// The cell code at (r, c), 0 <= r, c < n. r and c may differ between lanes;
// every lane of the warp must call.
__device__ __forceinline__ int code_at(const TaflRows& b, int r, int c) {
  const uint32_t lo = __shfl_sync(TAFL_FULL, b.att | b.king, r);
  const uint32_t hi = __shfl_sync(TAFL_FULL, b.def | b.king, r);
  return (int)((lo >> c) & 1u) + 2 * (int)((hi >> c) & 1u);
}

// tile_hostile (logic.rs:85-99): is the cell (r, c) hostile to piece class
// cls? Every lane must call.
__device__ __forceinline__ bool hostile_at(const TaflRows& b, int cls, int r, int c,
                                           const uint32_t* __restrict__ tab,
                                           const TaflParams& p) {
  const int v = code_at(b, r, c);
  const bool special =
      v == TAFL_EMPTY && ((tafl_plane(tab, TAFL_PL_HOSTILE_ROW(cls), r) >> c) & 1u);
  const bool by_attacker = v == TAFL_ATT;
  const bool by_defender =
      v == TAFL_DEF || (p.king_hostile_when_enemy && v == TAFL_KING);
  return (cls == 0 ? by_defender : by_attacker) || special;
}

// coords_hostile (logic.rs:103-114): off-board tiles are hostile iff the edge
// is hostile to cls. Every lane must call.
__device__ __forceinline__ bool coords_hostile(const TaflRows& b, int cls, int r,
                                               int c, const uint32_t* __restrict__ tab,
                                               const TaflParams& p) {
  const int n = p.n;
  const bool h =
      hostile_at(b, cls, tafl_clamp(r, 0, n - 1), tafl_clamp(c, 0, n - 1), tab, p);
  return in_board(r, c, n) ? h : (((p.edge_hostile_bits >> cls) & 1) != 0);
}

// Rows r - 1 and r + 1 of a per-lane mask; zero off the board.
__device__ __forceinline__ uint32_t row_above(uint32_t x, int lane) {
  const uint32_t v = __shfl_up_sync(TAFL_FULL, x, 1);
  return lane > 0 ? v : 0u;
}
__device__ __forceinline__ uint32_t row_below(uint32_t x, int lane) {
  const uint32_t v = __shfl_down_sync(TAFL_FULL, x, 1);
  return lane < 31 ? v : 0u;
}

// A mask grown by one cell in the four directions (itself included).
__device__ __forceinline__ uint32_t dilate4(uint32_t x, int lane, uint32_t board_mask) {
  return (x | (x << 1) | (x >> 1) | row_above(x, lane) | row_below(x, lane)) &
         board_mask;
}

// The cells of `allowed` that `x` reaches along its row.
__device__ __forceinline__ uint32_t fill_row(uint32_t x, uint32_t allowed) {
  uint32_t g = x, pr = allowed;
  g |= pr & (g << 1);  pr &= pr << 1;
  g |= pr & (g << 2);  pr &= pr << 2;
  g |= pr & (g << 4);  pr &= pr << 4;
  g |= pr & (g << 8);  pr &= pr << 8;
  g |= pr & (g << 16);
  pr = allowed;
  g |= pr & (g >> 1);  pr &= pr >> 1;
  g |= pr & (g >> 2);  pr &= pr >> 2;
  g |= pr & (g >> 4);  pr &= pr >> 4;
  g |= pr & (g >> 8);  pr &= pr >> 8;
  g |= pr & (g >> 16);
  return g;
}

// The 4-connected component of `allowed` that holds `seed`, per lane's row.
// Every lane must call. An empty seed ends after the first vote.
__device__ __forceinline__ uint32_t flood(uint32_t seed, uint32_t allowed, int lane) {
  uint32_t reach = seed & allowed;
  while (true) {
    const uint32_t grown =
        fill_row((reach | row_above(reach, lane) | row_below(reach, lane)) & allowed,
                 allowed);
    const bool changed = grown != reach;
    reach = grown;
    if (!__any_sync(TAFL_FULL, changed)) return reach;
  }
}

// enclosure_secure (logic.rs:408-463) for every cell of this lane's row:
// along each axis, at least one neighbour must make a boundary piece of
// class b_cls safe. `region` is the flooded region, `b3` the board after the
// captures. Every lane must call.
__device__ __forceinline__ uint32_t secure_row(const TaflRows& b3, uint32_t region,
                                               int b_cls, int hs_cls, bool inside_safe,
                                               bool outside_safe, int lane,
                                               const uint32_t* __restrict__ tab,
                                               const TaflParams& p) {
  const int n = p.n;
  const uint32_t board_mask = (1u << n) - 1u;
  const int row = tafl_min(lane, n - 1);
  const uint32_t occupied = b3.att | b3.def | b3.king;
  const uint32_t special = tafl_plane(tab, TAFL_PL_HOSTILE_ROW(b_cls), row);
  const uint32_t pieces_hostile =
      b_cls == 0 ? (b3.def | (p.king_hostile_when_enemy ? b3.king : 0u)) : b3.att;
  const uint32_t hostile = pieces_hostile | (~occupied & special);
  const uint32_t known = (inside_safe ? region : 0u) | (outside_safe ? ~region : 0u);
  // Tiles of this row that make a neighbouring boundary piece safe.
  uint32_t safe = (known & ~special) |
                  (~hostile & (occupied | ~tafl_plane(tab, TAFL_PL_OCC_ROW(hs_cls), row)));
  safe = lane < n ? safe & board_mask : 0u;
  // An off-board neighbour is safe unless the edge is hostile to the piece.
  const bool off_safe = ((p.edge_hostile_bits >> b_cls) & 1) == 0;
  const uint32_t all_if_off = off_safe ? board_mask : 0u;
  const uint32_t up = __shfl_up_sync(TAFL_FULL, safe, 1);
  const uint32_t down = __shfl_down_sync(TAFL_FULL, safe, 1);
  const uint32_t vertical =
      (lane > 0 ? up : all_if_off) | (lane < n - 1 ? down : all_if_off);
  const uint32_t horizontal = (safe << 1) | (safe >> 1) |
                              (off_safe ? (1u | (1u << (n - 1))) : 0u);
  return vertical & horizontal & board_mask;
}

// One direction of the shieldwall scan: q is where the run of extenders from
// the destination ends. Returns the wall's tiles when the run closes and
// holds at least two pieces (so never 0 then), else 0.
__device__ __forceinline__ uint32_t wall_try(int q, int pos0, int n, uint32_t closer,
                                             uint32_t pinned_corner) {
  const bool q_in = q >= 0 && q < n;
  const uint32_t qb = q_in ? 1u << q : 0u;
  const bool close = (closer & qb) != 0u;
  const bool incl_q = (pinned_corner & qb) != 0u;
  const int lo = tafl_min(pos0, q), hi = tafl_max(pos0, q);
  const int count = hi - lo - 1 + (incl_q ? 1 : 0);
  if (!close || count < 2) return 0u;
  // q is on the board here, so 0 <= lo < hi < n.
  return (((1u << hi) - 1u) & ~((2u << lo) - 1u)) | (incl_q ? qb : 0u);
}

__global__ void __launch_bounds__(32 * TAFL_GROUP)
tafl_step_kernel(const int8_t* __restrict__ boards, const int* __restrict__ sides,
                 const int* __restrict__ actions, const int* __restrict__ recent,
                 const int* __restrict__ first_i, const int* __restrict__ reps,
                 const uint8_t* __restrict__ mid_pair, const int* __restrict__ psc,
                 const uint32_t* __restrict__ tab, TaflParams p, int B, int group,
                 int8_t* __restrict__ board3_out, uint8_t* __restrict__ cap_out,
                 uint8_t* __restrict__ mask_out, int* __restrict__ scal_out) {
  TAFL_DYNAMIC_SHARED(smem);
  const int n = p.n, nn = n * n, nd = n - 1;
  const int A = nn * 4 * nd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g0 = blockIdx.x * group;
  const int count = tafl_min(group, B - g0);
  uint8_t* gmask = mask_out + (size_t)g0 * A;
  const int shift = tafl_stage_shift(gmask);
  const int span = count * A;

  tafl_stage_zero(smem, shift + span);
  __syncthreads();

  // `warp < count` is the same for every lane of a warp, and nothing below
  // it, down to the closing brace, waits for another warp.
  if (warp < count) {
    const int b = g0 + warp;
    const uint32_t board_mask = (1u << n) - 1u;
    const uint32_t lane_bit_row = lane < n ? board_mask : 0u;
    const int side = sides[b];
    const int action = actions[b];
    // The ring's inputs are needed last; their loads are issued first.
    const int* ring = recent + 4 * b;
    const int ring0 = ring[0], ring1 = ring[1], ring2 = ring[2], ring3 = ring[3];
    const int fi = first_i[b];
    const int reps_att = reps[2 * b], reps_def = reps[2 * b + 1];
    const int mid_att = mid_pair[2 * b], mid_def = mid_pair[2 * b + 1];
    const int psc_in = psc[b];

    // ---- action decode (core/actions.py) ----
    const int per_tile = 4 * nd;
    const int from = action / per_tile;
    const int rem = action - from * per_tile;
    const int dir = rem / nd;
    const int dist = rem - dir * nd + 1;
    const int fr = from / n, fc = from - fr * n;
    const int tr = fr + tafl_dr(dir) * dist, tc = fc + tafl_dc(dir) * dist;
    const bool to_in_b = in_board(tr, tc, n);
    const int trc = tafl_clamp(tr, 0, n - 1), tcc = tafl_clamp(tc, 0, n - 1);
    // Actions lie in [0, A); the guard only keeps a bad one inside the board.
    const bool from_ok = from >= 0 && from < nn;
    const int frc = tafl_clamp(fr, 0, n - 1), fcc = tafl_clamp(fc, 0, n - 1);

    TaflRows b2 = tafl_load_rows(boards + (size_t)b * nn, n, lane);
    const int at_from = code_at(b2, frc, fcc);
    const int moving = from_ok ? at_from : TAFL_EMPTY;
    const int moving_side = moving == TAFL_ATT ? 0 : 1;
    const bool valid_basic = to_in_b && moving != TAFL_EMPTY && moving_side == side;

    // ---- move the piece ----
    if (from_ok && lane == frc) {
      const uint32_t keep = ~(1u << fcc);
      b2.att &= keep;
      b2.def &= keep;
      b2.king &= keep;
    }
    if (lane == trc) {
      const uint32_t bit = 1u << tcc;
      b2.att = (b2.att & ~bit) | (moving == TAFL_ATT ? bit : 0u);
      b2.def = (b2.def & ~bit) | (moving == TAFL_DEF ? bit : 0u);
      b2.king = (b2.king & ~bit) | (moving == TAFL_KING ? bit : 0u);
    }
    // King position on the post-move board: the first king cell, 0 if none.
    const uint32_t king_rows = __ballot_sync(TAFL_FULL, b2.king != 0u);
    const int kr = king_rows ? __ffs(king_rows) - 1 : 0;
    const uint32_t king_row = __shfl_sync(TAFL_FULL, b2.king, kr);
    const int kc = king_rows ? __ffs(king_row) - 1 : 0;
    const int kflat = kr * n + kc;
    const int thr_r = p.thr_r, thr_c = p.thr_c;

    // ---- king strength (logic.rs:225-245) ----
    const bool king_on_throne = kr == thr_r && kc == thr_c;
    const int kdist = abs(kr - thr_r) + abs(kc - thr_c);
    const bool king_beside = kdist == 1;
    const bool king_strong =
        p.king_strength == 0
            ? true
            : (p.king_strength == 2 ? false : (king_on_throne || king_beside));
    const bool may_attack = moving != TAFL_KING || p.king_attacks;

    // ---- Linnaean precondition (logic.rs:859-879) ----
    bool linn_ok = false;
    if (p.linnaean) {
      int cnt = 0;
      for (int d = 0; d < 4; ++d) {
        const bool h = coords_hostile(b2, 2, thr_r + tafl_dr(d), thr_c + tafl_dc(d), tab, p);
        cnt += h ? 1 : 0;
      }
      linn_ok = side == 0 && king_on_throne && cnt == 3;
    }

    // ---- custodian captures: lane d (and every lane d + 4k with it) judges
    // the neighbour of the destination in direction d ----
    bool cap_d;
    {
      const int d = lane & 3;
      const int dr = tafl_dr(d), dc = tafl_dc(d);
      const int nr = trc + dr, nc = tcc + dc;
      const bool n_in = in_board(nr, nc, n);
      const int r = tafl_clamp(nr, 0, n - 1), c = tafl_clamp(nc, 0, n - 1);
      const int q = code_at(b2, r, c);
      const bool enemy =
          n_in && (side == 0 ? (q == TAFL_DEF || q == TAFL_KING) : q == TAFL_ATT);
      const int q_cls = tafl_clamp(q - 1, 0, 2);
      const int far_r = trc + 2 * dr, far_c = tcc + 2 * dc;
      const bool far_h = coords_hostile(b2, q_cls, far_r, far_c, tab, p);
      // The king's other two neighbours, across the line of attack.
      const int ar = dr == 0 ? 1 : 0, ac = dr == 0 ? 0 : 1;
      const bool p1 = coords_hostile(b2, 2, r + ar, c + ac, tab, p);
      const bool p2 = coords_hostile(b2, 2, r - ar, c - ac, tab, p);
      const bool king_cust = far_h && (!king_strong || (p1 && p2));
      bool king_special = false;
      if (p.special_rules_on) {
        bool all_nbr = true;
        for (int d2 = 0; d2 < 4; ++d2) {
          const int r2 = r + tafl_dr(d2), c2 = c + tafl_dc(d2);
          const bool h = hostile_at(b2, 2, tafl_clamp(r2, 0, n - 1),
                                    tafl_clamp(c2, 0, n - 1), tab, p);
          const bool is_throne = r2 == thr_r && c2 == thr_c;
          all_nbr = all_nbr && (!in_board(r2, c2, n) || is_throne || h);
        }
        king_special = king_beside && all_nbr;
      }
      const bool king_capt = king_special || king_cust;
      const bool linn_here =
          linn_ok && far_r == thr_r && far_c == thr_c && q == TAFL_DEF;
      const bool soldier_capt = far_h || linn_here;
      cap_d = enemy && may_attack && (q == TAFL_KING ? king_capt : soldier_capt);
    }
    const uint32_t cap_dirs = __ballot_sync(TAFL_FULL, cap_d) & 0xfu;
    uint32_t cap = 0u;
    for (int d = 0; d < 4; ++d) {
      if (((cap_dirs >> d) & 1u) && lane == trc + tafl_dr(d)) {
        cap |= 1u << (tcc + tafl_dc(d));
      }
    }

    // ---- shieldwall (logic.rs:471-569) on the edge lane as a bit mask ----
    // Lane priority as the reference: row 0, row n-1, column 0, column n-1.
    const int lane_case =
        trc == 0 ? 0 : (trc == n - 1 ? 1 : (tcc == 0 ? 2 : (tcc == n - 1 ? 3 : 4)));
    if (p.sw_on && lane_case < 4) {
      // The edge lane and the line one step off the edge from it.
      const int li = (lane_case & 1) ? n - 1 : 0;
      const int pi = (lane_case & 1) ? n - 2 : 1;
      uint32_t la, ld, lk, pa, pd, pk;
      if (lane_case < 2) {
        la = __shfl_sync(TAFL_FULL, b2.att, li);
        ld = __shfl_sync(TAFL_FULL, b2.def, li);
        lk = __shfl_sync(TAFL_FULL, b2.king, li);
        pa = __shfl_sync(TAFL_FULL, b2.att, pi);
        pd = __shfl_sync(TAFL_FULL, b2.def, pi);
        pk = __shfl_sync(TAFL_FULL, b2.king, pi);
      } else {
        la = __ballot_sync(TAFL_FULL, (b2.att >> li) & 1u);
        ld = __ballot_sync(TAFL_FULL, (b2.def >> li) & 1u);
        lk = __ballot_sync(TAFL_FULL, (b2.king >> li) & 1u);
        pa = __ballot_sync(TAFL_FULL, (b2.att >> pi) & 1u);
        pd = __ballot_sync(TAFL_FULL, (b2.def >> pi) & 1u);
        pk = __ballot_sync(TAFL_FULL, (b2.king >> pi) & 1u);
      }
      const uint32_t lane_occ = la | ld | lk;
      const uint32_t lane_mine = side == 0 ? la : (ld | lk);
      const uint32_t pin_mine = side == 0 ? pa : (pd | pk);
      const uint32_t enemy_pinned = lane_occ & ~lane_mine & pin_mine;
      const uint32_t corners = p.sw_corners_close ? (1u | (1u << (n - 1))) : 0u;
      const uint32_t not_extender = ~(enemy_pinned & ~corners);
      const uint32_t closer =
          lane_mine | (~lane_occ & corners) | (enemy_pinned & corners);
      const int pos0 = lane_case < 2 ? tcc : trc;
      // The reference tries the negative direction first (logic.rs:551-554).
      const uint32_t below = not_extender & ((1u << pos0) - 1u);
      const uint32_t above = not_extender & board_mask & ~((2u << pos0) - 1u);
      const int q_neg = below ? 31 - __clz(below) : -1;
      const int q_pos = above ? __ffs(above) - 1 : n;
      uint32_t wall = wall_try(q_neg, pos0, n, closer, enemy_pinned & corners);
      if (wall == 0u) wall = wall_try(q_pos, pos0, n, closer, enemy_pinned & corners);
      const uint32_t caps = (uint32_t)p.sw_caps_bits;
      wall &= ((caps & 1u) ? la : 0u) | ((caps & 2u) ? ld : 0u) | ((caps & 4u) ? lk : 0u);
      if (lane_case < 2) {
        if (lane == li) cap |= wall;
      } else if ((wall >> lane) & 1u) {
        cap |= 1u << li;
      }
    }

    // ---- board after the captures ----
    TaflRows b3;
    b3.att = b2.att & ~cap;
    b3.def = b2.def & ~cap;
    b3.king = b2.king & ~cap;
    {
      int8_t* b3_out = board3_out + (size_t)b * nn;
      uint8_t* c_out = cap_out + (size_t)b * nn;
      for (int base = 0; base < nn; base += 32) {
        const int cell = tafl_min(base + lane, nn - 1);
        const int r = cell / n, c = cell - r * n;
        const int v = code_at(b3, r, c);
        const uint32_t cap_row = __shfl_sync(TAFL_FULL, cap, r);
        if (base + lane < nn) {
          b3_out[cell] = (int8_t)v;
          c_out[cell] = (uint8_t)((cap_row >> c) & 1u);
        }
      }
    }
    const int n_caps = (int)__reduce_add_sync(TAFL_FULL, (unsigned)__popc(cap));
    const int n_att3 = (int)__reduce_add_sync(TAFL_FULL, (unsigned)__popc(b3.att));
    const int n_def3 =
        (int)__reduce_add_sync(TAFL_FULL, (unsigned)__popc(b3.def | b3.king));
    const bool king_captured = ((__shfl_sync(TAFL_FULL, cap, kr) >> kc) & 1u) != 0u;
    const uint32_t empty3 = ~(b3.att | b3.def | b3.king) & lane_bit_row;
    const int my_row = tafl_min(lane, n - 1);
    const uint32_t corner_row =
        lane < n ? tafl_plane(tab, TAFL_PL_CORNER_ROW, my_row) : 0u;
    const uint32_t edge_row = lane < n ? tafl_plane(tab, TAFL_PL_EDGE_ROW, my_row) : 0u;
    const uint32_t king_bit = lane == kr ? 1u << kc : 0u;  // the cell kflat

    // ---- attacker surround win (logic.rs:720-734) ----
    // The reference aborts a fill once it has failed; a fill run to its
    // fixpoint gives the same verdict because every fail test grows with the
    // reached set. When the defender moved the seed is empty: nothing is
    // reached, nothing fails, and the verdict is "no defender is left".
    bool o_enclosed = false;
    if (p.enclosure_win >= 0 && side != 0) {
      o_enclosed = n_def3 == 0;
    } else if (p.enclosure_win >= 0) {
      const uint32_t defenders3 = b3.def | b3.king;
      const uint32_t reach = flood(king_bit, empty3 | defenders3, lane);
      const uint32_t fail_tiles = corner_row | (p.enclosure_win == 1 ? edge_row : 0u);
      const bool fail = __any_sync(TAFL_FULL, (reach & fail_tiles) != 0u) != 0;
      const int def_in =
          (int)__reduce_add_sync(TAFL_FULL, (unsigned)__popc(reach & defenders3));
      const uint32_t boundary = dilate4(reach, lane, lane_bit_row) & ~reach & b3.att;
      const uint32_t secure = secure_row(b3, reach, 0, 1, false, true, lane, tab, p);
      const bool any_insecure = __any_sync(TAFL_FULL, (boundary & ~secure) != 0u) != 0;
      o_enclosed = !fail && def_in == n_def3 && !any_insecure;
    }

    // ---- defender exit fort (logic.rs:572-601) ----
    // The flood has a seed only when the defender moved and the king is on
    // an edge. Without one nothing is reached and nothing fails, and the
    // verdict is "the king is on an edge with a free neighbour".
    bool o_exit_fort = false;
    if (p.exit_fort) {
      const bool king_at_edge =
          ((tafl_plane(tab, TAFL_PL_EDGE_ROW, kr) >> kc) & 1u) != 0u;
      const uint32_t beside_king = dilate4(king_bit, lane, lane_bit_row) & ~king_bit;
      const bool king_free = __any_sync(TAFL_FULL, (beside_king & empty3) != 0u) != 0;
      o_exit_fort = king_at_edge && king_free;
      if (o_exit_fort && side == 1) {  // the same in every lane
        const uint32_t reach = flood(king_bit, empty3 | king_bit, lane);
        const uint32_t near = dilate4(reach, lane, lane_bit_row);
        const bool fail_neither = __any_sync(TAFL_FULL, (near & b3.att) != 0u) != 0;
        const bool fail_corner = __any_sync(TAFL_FULL, (reach & corner_row) != 0u) != 0;
        const uint32_t boundary = near & ~reach & b3.def;
        const uint32_t secure = secure_row(b3, reach, 1, 0, true, false, lane, tab, p);
        const bool any_insecure =
            __any_sync(TAFL_FULL, (boundary & ~secure) != 0u) != 0;
        o_exit_fort = !fail_neither && !fail_corner && !any_insecure;
      }
    }

    // ---- next player's legal mask on the post-capture board ----
    const bool has_play = tafl_warp_mask(b3, 1 - side, tab, p, lane,
                                         (uint8_t*)smem + shift + warp * A);

    // ---- repetition ring (state.rs:92-113) ----
    const int capt_any = n_caps > 0 ? 1 : 0;
    const int rec = side + 2 * capt_any + 4 * action;
    const int oldest =
        fi == 0 ? ring0 : (fi == 1 ? ring1 : (fi == 2 ? ring2 : (fi == 3 ? ring3 : 0)));
    const bool match = !capt_any && oldest == rec;
    const bool side_att = side == 0;
    const int mid = side_att ? mid_att : mid_def;
    const int cur = side_att ? reps_att : reps_def;
    const int new_rep_side = match ? cur + (mid ? 0 : 1) : 0;
    const int new_mid_side = (match && !mid) ? 1 : 0;

    // ---- outcome priority select (logic.rs:702-771) ----
    const bool to_at_edge = ((tafl_plane(tab, TAFL_PL_EDGE_ROW, trc) >> tcc) & 1u) != 0u;
    const bool to_at_corner =
        ((tafl_plane(tab, TAFL_PL_CORNER_ROW, trc) >> tcc) & 1u) != 0u;
    const int other_count = side_att ? n_def3 : n_att3;
    const bool escape_tile = p.edge_escape ? to_at_edge : to_at_corner;
    int result = -1, reason = -1, done = 0;
    if (!has_play) {  // no plays
      result = p.draw_on_no_plays ? 2 : side;
      reason = p.draw_on_no_plays ? 17 : 5;
      done = 1;
    }
    if (p.rep_n > 0 && new_rep_side >= p.rep_n) {  // repetition
      result = p.rep_is_loss ? 1 - side : 2;
      reason = p.rep_is_loss ? 6 : 16;
      done = 1;
    }
    if (!side_att && o_exit_fort) { result = 1; reason = 1; done = 1; }
    if (!side_att && moving == TAFL_KING && escape_tile) { result = 1; reason = 0; done = 1; }
    if (side_att && o_enclosed) { result = 0; reason = 4; done = 1; }
    if (side_att && king_captured) { result = 0; reason = 2; done = 1; }
    if (other_count == 0) { result = side; reason = 3; done = 1; }  // all captured

    // ---- the 24 scalars, one per lane ----
    int v = valid_basic ? 1 : 0;
    v = lane == 1 ? moving : v;
    v = lane == 2 ? trc : v;
    v = lane == 3 ? tcc : v;
    v = lane == 4 ? kflat : v;
    v = lane == 5 ? (king_captured ? 1 : 0) : v;
    v = lane == 6 ? (to_at_edge ? 1 : 0) : v;
    v = lane == 7 ? (to_at_corner ? 1 : 0) : v;
    v = lane == 8 ? (o_enclosed ? 1 : 0) : v;
    v = lane == 9 ? (o_exit_fort ? 1 : 0) : v;
    v = lane == 10 ? result : v;
    v = lane == 11 ? reason : v;
    v = lane == 12 ? done : v;
    v = lane == 13 ? (fi + 1) % 4 : v;
    v = lane == 14 ? (side_att ? new_rep_side : reps_att) : v;
    v = lane == 15 ? (side_att ? reps_def : new_rep_side) : v;
    v = lane == 16 ? (side_att ? new_mid_side : mid_att) : v;
    v = lane == 17 ? (side_att ? mid_def : new_mid_side) : v;
    v = lane == 18 ? psc_in + (1 - capt_any) : v;
    v = lane == 19 ? (fi == 0 ? rec : ring0) : v;
    v = lane == 20 ? (fi == 1 ? rec : ring1) : v;
    v = lane == 21 ? (fi == 2 ? rec : ring2) : v;
    v = lane == 22 ? (fi == 3 ? rec : ring3) : v;
    v = lane == 23 ? n_caps : v;
    if (lane < TAFL_NUM_SCALARS) scal_out[(size_t)b * TAFL_NUM_SCALARS + lane] = v;
  }

  tafl_stage_fence();
  __syncthreads();
  tafl_stage_flush(smem, shift, span, gmask);
}

}  // namespace

// One step of B games. Inputs: boards int8[B, n, n], sides/actions int32[B],
// recent int32[B, 4], first_i int32[B], reps int32[B, 2], mid_pair
// bool[B, 2], psc int32[B], tab uint32[TAFL_NUM_PLANES, 32]. Outputs: board3
// int8[B, n, n], cap bool[B, n, n], mask bool[B, A], scal int32[B, 24].
// Returns the CUDA error of the launch (0 on success).
extern "C" int tafl_step(const void* boards, const void* sides,
                         const void* actions, const void* recent,
                         const void* first_i, const void* reps,
                         const void* mid_pair, const void* psc,
                         const void* tab, const TaflParams* params, int B,
                         void* board3, void* cap, void* mask, void* scal,
                         void* stream) {
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
        tafl_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TAFL_STAGE_BYTES);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
#endif
  TAFL_LAUNCH(tafl_step_kernel, (B + g - 1) / g, 32 * g, smem_bytes,
              (cudaStream_t)stream, (const int8_t*)boards, (const int*)sides,
              (const int*)actions, (const int*)recent, (const int*)first_i,
              (const int*)reps, (const uint8_t*)mid_pair, (const int*)psc,
              (const uint32_t*)tab, *params, B, g, (int8_t*)board3,
              (uint8_t*)cap, (uint8_t*)mask, (int*)scal);
  return (int)cudaGetLastError();
}
