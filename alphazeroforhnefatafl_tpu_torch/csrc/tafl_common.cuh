// Shared pieces of the two tafl kernels: the rule switches, the layout of the
// per-cell rule table, and the legal-move ray scan of one piece.
//
// The table is int32[nn, C] with C >= TAFL_COL_MOVE_END; the step kernel gets
// the full TAFL_NUM_COLS columns, the legal-mask kernel only the move columns.
// Its layout is built in numpy by ops/legal_mask.py (_move_tables) and
// ops/step_kernel.py (_static_tables); the column numbers below must match
// the ones there.
#pragma once

#include <cstdint>

// Cell codes (core/rules.py).
#define TAFL_EMPTY 0
#define TAFL_ATT 1
#define TAFL_DEF 2
#define TAFL_KING 3

// Table columns. Move class i (piece classes deduplicated by rule config):
// occupiable at 2i, passable at 2i + 1.
#define TAFL_COL_MOVE_OCC(i) (2 * (i))
#define TAFL_COL_MOVE_PASS(i) (2 * (i) + 1)
#define TAFL_COL_MOVE_END 6
// Piece class c = cell code - 1.
#define TAFL_COL_SPECIAL_HOSTILE(c) (6 + (c))
#define TAFL_COL_CLS_OCC(c) (9 + (c))
#define TAFL_COL_CORNER 12
#define TAFL_COL_EDGE 13
#define TAFL_COL_CC 14  // corner that may close a shieldwall
#define TAFL_NUM_COLS 15

// Largest board the step kernel takes: 21x21 = 441 cells, one thread each.
#define TAFL_MAX_NN 448

// Number of int32 scalars the step kernel writes per game (see SCALAR_ROWS in
// ops/step_kernel.py).
#define TAFL_NUM_SCALARS 24

// Rule switches of one ruleset: one compiled kernel serves every preset.
// Mirrored field for field by ops/step_kernel.TaflParams (ctypes); all ints.
struct TaflParams {
  int n;
  int num_move_classes;
  int move_max_dist[3];     // per move class; 1 for slow pieces
  int move_cls_of_code[4];  // cell code -> move class ([0] unused)
  int thr_flat;             // throne cell
  int king_attacks;         // king may initiate captures
  int king_hostile_when_enemy;
  int king_strength;        // KingStrength: 0 strong, 1 by throne, 2 weak
  int special_rules_on;     // strong-by-throne king beside the throne
  int linnaean;
  int enclosure_win;        // -1 off, else EnclosureWinRules
  int exit_fort;
  int sw_on;                // shieldwall captures on
  int sw_caps[3];           // shieldwall may capture piece class c
  int edge_hostile[3];      // off-board tiles hostile to piece class c
  int edge_escape;
  int rep_n;                // repetitions that end the game; 0 = no rule
  int rep_is_loss;
  int draw_on_no_plays;
};

__device__ __forceinline__ int tafl_dr(int d) { return d == 0 ? -1 : (d == 1 ? 1 : 0); }
__device__ __forceinline__ int tafl_dc(int d) { return d == 2 ? -1 : (d == 3 ? 1 : 0); }

// Legal destinations of the piece on `cell` for the side `side`, written as
// the 4 * (n - 1) bytes of the cell's row of the action mask, in action
// order (dir, dist). Returns whether any destination is legal.
//
// A destination at distance k is legal when it is empty and occupiable by
// the piece's class and every tile at distances 1..k-1 is empty and passable
// (ValidPlayIterator + validate_play_for_side, game/play.rs:189-225,
// game/game/logic.rs:159-214). Slow pieces stop at k = 1.
__device__ __forceinline__ bool tafl_ray_scan_cell(
    const int8_t* board, int cell, int side, const int* table, int C,
    const TaflParams& p, uint8_t* out_row) {
  const int n = p.n;
  const int nd = n - 1;
  const int code = board[cell];
  int cls = -1;
  if (code != TAFL_EMPTY) {
    const int piece_side = code == TAFL_ATT ? 0 : 1;
    if (piece_side == side) cls = p.move_cls_of_code[code];
  }
  const int r = cell / n;
  const int c = cell - r * n;
  const int max_dist = cls >= 0 ? p.move_max_dist[cls] : 0;
  bool any = false;
  for (int d = 0; d < 4; ++d) {
    const int dr = tafl_dr(d), dc = tafl_dc(d);
    bool open = cls >= 0;  // every tile before distance k is passable
    for (int k = 1; k <= nd; ++k) {
      bool legal = false;
      if (open && k <= max_dist) {
        const int rr = r + dr * k, cc = c + dc * k;
        if (rr < 0 || rr >= n || cc < 0 || cc >= n) {
          open = false;
        } else {
          const int t = rr * n + cc;
          const bool empty = board[t] == TAFL_EMPTY;
          legal = empty && table[t * C + TAFL_COL_MOVE_OCC(cls)] != 0;
          open = empty && table[t * C + TAFL_COL_MOVE_PASS(cls)] != 0;
        }
      } else {
        open = false;
      }
      out_row[d * nd + (k - 1)] = legal ? 1 : 0;
      any = any || legal;
    }
  }
  return any;
}
