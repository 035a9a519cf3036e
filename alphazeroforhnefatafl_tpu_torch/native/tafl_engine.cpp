// Native tafl rules engine.
//
// C++ successor of the reference's Rust game crate (game/): the host-side
// runtime component of the framework — fast single-game rules evaluation
// for interactive play and differential testing of the batched env at
// scale. Semantics are a line-for-line behavioral match of the Python
// oracle (core/oracle.py), which is itself golden-tested against the
// reference's test fixtures.
//
// The PyTorch port's own copy of the repository's native/tafl_engine.cpp:
// everything from the first #include on is the same, byte for byte
// (tests/test_torch_oracle.py).
//
// Exposed as a C ABI for ctypes, so the build needs no binding library.
//
// Build: g++ -O2 -shared -fPIC -o libtafl.so tafl_engine.cpp

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int MAX_N = 21;

// Cell codes (rules.py: EMPTY/CELL_ATT/CELL_DEF/CELL_KING).
enum Cell : int8_t { EMPTY = 0, ATT = 1, DEF = 2, KING = 3 };

// Piece-class bits in the u16 PieceSet layout (pieces.rs:31-38, 157-273):
// attacker types in the low byte, defender types in the high byte.
constexpr unsigned PS_ATT_SOLDIER = 0x0002;
constexpr unsigned PS_DEF_SOLDIER = 0x0200;
constexpr unsigned PS_KING = 0x0100;

inline unsigned cell_bit(int8_t cell) {
  switch (cell) {
    case ATT: return PS_ATT_SOLDIER;
    case DEF: return PS_DEF_SOLDIER;
    case KING: return PS_KING;
    default: return 0;
  }
}

inline int side_of(int8_t cell) { return cell == ATT ? 0 : 1; }

// Enums mirror rules.py.
enum class Throne { NO_THRONE = 0, NO_PASS, KING_PASS, NO_ENTRY, KING_ENTRY };
enum class KStrength { STRONG = 0, STRONG_BY_THRONE, WEAK };
enum class KAttack { ARMED = 0, ANVIL, HAMMER };

// Result codes (env.py).
enum { ONGOING = -1, WIN_ATT = 0, WIN_DEF = 1, DRAW_ = 2 };
// Reason codes (rules.WinReason + env draw offsets).
enum {
  R_KING_ESCAPED = 0, R_EXIT_FORT, R_KING_CAPTURED, R_ALL_CAPTURED,
  R_ENCLOSED, R_NO_PLAYS, R_REPETITION,
  R_DRAW_REPETITION = 16, R_DRAW_NO_PLAYS = 17, R_NONE = -1
};

}  // namespace

extern "C" {

struct TaflRules {
  int32_t edge_escape;
  int32_t king_strength;   // KStrength
  int32_t king_attack;     // KAttack
  int32_t has_shieldwall;
  int32_t sw_corners_may_close;
  uint32_t sw_captures;    // PieceSet mask
  int32_t exit_fort;
  int32_t throne_movement; // Throne
  uint32_t may_enter_corners;
  uint32_t hostility_throne;
  uint32_t hostility_corners;
  uint32_t hostility_edge;
  uint32_t slow_pieces;
  int32_t starting_side;
  int32_t has_enclosure_win;
  int32_t enclosure_without_edge_access;
  int32_t has_repetition_rule;
  int32_t rep_n;
  int32_t rep_is_loss;
  int32_t draw_on_no_plays;
  int32_t linnaean_capture;
};

}  // extern "C"

namespace {

struct ShortRec {
  int32_t side = -1;
  int32_t action = -1;
  bool captures = false;
  bool valid = false;
  bool operator==(const ShortRec& o) const {
    return valid && o.valid && side == o.side && action == o.action &&
           captures == o.captures;
  }
};

struct Engine {
  TaflRules rules;
  int n = 0;
  int A = 0;
  int8_t board[MAX_N * MAX_N] = {0};
  int side_to_play = 0;
  int result = ONGOING;
  int reason = R_NONE;
  int64_t turn = 0;
  int64_t plays_since_capture = 0;
  // Repetition tracker (game/game/state.rs:41-114).
  int64_t reps[2] = {0, 0};
  bool mid_pair[2] = {false, false};
  ShortRec recent[4];
  int rep_first_i = 0;
  // Last step effects.
  std::vector<int> last_captures;

  int thr_r() const { return n / 2; }
  int thr_c() const { return n / 2; }
  bool in_bounds(int r, int c) const { return r >= 0 && r < n && c >= 0 && c < n; }
  bool is_corner(int r, int c) const {
    return (r == 0 || r == n - 1) && (c == 0 || c == n - 1);
  }
  bool is_throne(int r, int c) const { return r == thr_r() && c == thr_c(); }
  bool at_edge(int r, int c) const {
    return r == 0 || r == n - 1 || c == 0 || c == n - 1;
  }
  int8_t at(int r, int c) const { return board[r * n + c]; }
  void set(int r, int c, int8_t v) { board[r * n + c] = v; }

  bool parse_fen(const char* fen) {
    // BitfieldBoardState::from_fen semantics (board/state.rs:225-250).
    int r = 0, c = 0, n_empty = 0, side_len = 0;
    std::memset(board, 0, sizeof(board));
    int8_t tmp[MAX_N * MAX_N] = {0};
    for (const char* p = fen;; ++p) {
      char ch = *p;
      if (ch == '/' || ch == '\0') {
        c += n_empty;
        n_empty = 0;
        if (side_len == 0) side_len = c;
        else if (c != side_len) return false;
        ++r;
        c = 0;
        if (ch == '\0') break;
        continue;
      }
      if (ch >= '0' && ch <= '9') {
        n_empty = n_empty * 10 + (ch - '0');
        continue;
      }
      c += n_empty;
      n_empty = 0;
      int8_t cell;
      if (ch == 't') cell = ATT;
      else if (ch == 'T') cell = DEF;
      else if (ch == 'K') cell = KING;
      else return false;
      if (r >= MAX_N || c >= MAX_N) return false;
      tmp[r * MAX_N + c] = cell;
      ++c;
    }
    if (side_len <= 0 || side_len > MAX_N || r > side_len) return false;
    n = side_len;
    A = n * n * 4 * (n - 1);
    for (int rr = 0; rr < n; ++rr)
      for (int cc = 0; cc < n; ++cc) board[rr * n + cc] = tmp[rr * MAX_N + cc];
    return true;
  }

  // --- hostility (logic.rs:76-114) ---

  bool special_tile_hostile(int r, int c, unsigned piece_bit) const {
    if ((rules.hostility_throne & piece_bit) && is_throne(r, c)) return true;
    if ((rules.hostility_corners & piece_bit) && is_corner(r, c)) return true;
    if ((rules.hostility_edge & piece_bit) && !in_bounds(r, c)) return true;
    return false;
  }

  bool tile_hostile(int r, int c, int8_t piece) const {
    int8_t other = at(r, c);
    if (other != EMPTY) {
      if (side_of(other) == side_of(piece)) return false;
      if (other == KING && rules.king_attack == (int)KAttack::HAMMER) return false;
      return true;
    }
    return special_tile_hostile(r, c, cell_bit(piece));
  }

  bool coords_hostile(int r, int c, int8_t piece) const {
    if (in_bounds(r, c)) return tile_hostile(r, c, piece);
    return (rules.hostility_edge & cell_bit(piece)) != 0;
  }

  // --- occupiability / movement rules (logic.rs:119-266) ---

  bool throne_entry_blocked(int8_t piece) const {
    auto tm = (Throne)rules.throne_movement;
    return tm == Throne::NO_ENTRY || (tm == Throne::KING_ENTRY && piece != KING);
  }
  bool throne_pass_blocked(int8_t piece) const {
    auto tm = (Throne)rules.throne_movement;
    return tm == Throne::NO_PASS || (tm == Throne::KING_PASS && piece != KING);
  }
  bool coords_occupiable(int r, int c, int8_t piece) const {
    if (!in_bounds(r, c)) return false;
    if (is_throne(r, c) && throne_entry_blocked(piece)) return false;
    if (is_corner(r, c) && !(rules.may_enter_corners & cell_bit(piece))) return false;
    return true;
  }

  // Legal destinations of the piece at (r, c) -> fills actions into mask.
  // Mirror of ValidPlayIterator x can_occupy_or_pass (play.rs:189-225,
  // logic.rs:119-214): walk each ray, emitting occupiable tiles and
  // continuing while passable.
  int gen_piece_moves(int r, int c, uint8_t* mask) const {
    int8_t piece = at(r, c);
    if (piece == EMPTY) return 0;
    int count = 0;
    static const int DR[4] = {-1, 1, 0, 0};
    static const int DC[4] = {0, 0, -1, 1};
    bool slow = (rules.slow_pieces & cell_bit(piece)) != 0;
    bool entry_blocked = throne_entry_blocked(piece);
    bool pass_blocked = throne_pass_blocked(piece);
    bool corner_ok = (rules.may_enter_corners & cell_bit(piece)) != 0;
    for (int d = 0; d < 4; ++d) {
      bool passed_blocked_throne = false;
      for (int k = 1; k < n; ++k) {
        int tr = r + DR[d] * k, tc = c + DC[d] * k;
        if (!in_bounds(tr, tc)) break;
        if (at(tr, tc) != EMPTY) break;  // BlockedByPiece: no occupy, no pass
        if (passed_blocked_throne) break;  // MoveThroughBlockedTile
        bool can_occupy = true, can_pass = true;
        if (is_corner(tr, tc) && !corner_ok) {
          can_occupy = false;
          can_pass = false;  // corners are never passable (logic.rs:144-147)
        } else if (is_throne(tr, tc) && entry_blocked) {
          can_occupy = false;  // pass allowed: entry-blocking rules permit it
        } else if (slow && k > 1) {
          can_occupy = false;  // TooFar
          can_pass = false;
        }
        if (can_occupy) {
          if (mask) {
            int action = (r * n + c) * 4 * (n - 1) + d * (n - 1) + (k - 1);
            mask[action] = 1;
          }
          ++count;
        }
        if (is_throne(tr, tc) && pass_blocked) passed_blocked_throne = true;
        if (!can_pass) break;
      }
    }
    return count;
  }

  int legal_actions(int side, uint8_t* mask) const {
    if (result != ONGOING) return 0;
    int count = 0;
    for (int r = 0; r < n; ++r)
      for (int c = 0; c < n; ++c) {
        int8_t p = at(r, c);
        if (p == EMPTY || side_of(p) != side) continue;
        count += gen_piece_moves(r, c, mask);
      }
    return count;
  }

  bool side_can_play(int side) const {
    for (int r = 0; r < n; ++r)
      for (int c = 0; c < n; ++c) {
        int8_t p = at(r, c);
        if (p == EMPTY || side_of(p) != side) continue;
        if (gen_piece_moves(r, c, nullptr) > 0) return true;
      }
    return false;
  }

  // --- king status (logic.rs:225-245) ---

  bool find_king(int* kr, int* kc) const {
    for (int i = 0; i < n * n; ++i)
      if (board[i] == KING) {
        *kr = i / n;
        *kc = i % n;
        return true;
      }
    return false;
  }

  bool king_is_strong(int kr, int kc) const {
    auto ks = (KStrength)rules.king_strength;
    if (ks == KStrength::STRONG) return true;
    if (ks == KStrength::WEAK) return false;
    int dr = kr - thr_r(), dc = kc - thr_c();
    int man = (dr < 0 ? -dr : dr) + (dc < 0 ? -dc : dc);
    return man <= 1;
  }

  // --- flood fill (logic.rs:309-401) ---
  // allowed(cell): empty or enclosed piece. Returns false on abort/neither.
  template <typename EnclosedF, typename EnclosingF>
  bool find_enclosure(int sr, int sc, EnclosedF enclosed, EnclosingF enclosing,
                      bool abort_on_edge, bool abort_on_corner,
                      bool* region /*n*n*/, bool* boundary /*n*n*/) const {
    std::memset(region, 0, n * n);
    std::memset(boundary, 0, n * n);
    int8_t s = at(sr, sc);
    if (!(s == EMPTY || enclosed(s))) return false;
    std::vector<int> stack;
    stack.push_back(sr * n + sc);
    region[sr * n + sc] = true;
    static const int DR[4] = {-1, 1, 0, 0};
    static const int DC[4] = {0, 0, -1, 1};
    while (!stack.empty()) {
      int t = stack.back();
      stack.pop_back();
      int r = t / n, c = t % n;
      if (abort_on_edge && at_edge(r, c)) return false;
      if (abort_on_corner && is_corner(r, c)) return false;
      for (int d = 0; d < 4; ++d) {
        int nr = r + DR[d], nc = c + DC[d];
        if (!in_bounds(nr, nc) || region[nr * n + nc]) continue;
        int8_t cell = at(nr, nc);
        if (cell == EMPTY || enclosed(cell)) {
          region[nr * n + nc] = true;
          stack.push_back(nr * n + nc);
        } else if (enclosing(cell)) {
          boundary[nr * n + nc] = true;
        } else {
          return false;  // neither -> no enclosure
        }
      }
    }
    return true;
  }

  // --- enclosure security (logic.rs:408-463) ---
  bool enclosure_secure(const bool* region, const bool* boundary,
                        bool inside_safe, bool outside_safe) const {
    if (inside_safe && outside_safe) return true;
    static const int DR[4] = {-1, 1, 0, 0};
    static const int DC[4] = {0, 0, -1, 1};
    for (int t = 0; t < n * n; ++t) {
      if (!boundary[t]) continue;
      int r = t / n, c = t % n;
      int8_t piece = at(r, c);
      int8_t hostile_soldier = side_of(piece) == 0 ? DEF : ATT;
      for (int axis = 0; axis < 2; ++axis) {
        bool axis_safe = false;
        for (int di = 0; di < 2; ++di) {
          int d = axis * 2 + di;  // 0,1 vertical; 2,3 horizontal
          int nr = r + DR[d], nc = c + DC[d];
          if (in_bounds(nr, nc)) {
            bool is_inside = region[nr * n + nc];
            if ((inside_safe && is_inside) || (outside_safe && !is_inside)) {
              if (!special_tile_hostile(nr, nc, cell_bit(piece))) {
                axis_safe = true;
                break;
              }
            }
            if (!tile_hostile(nr, nc, piece) &&
                (at(nr, nc) != EMPTY || !coords_occupiable(nr, nc, hostile_soldier))) {
              axis_safe = true;
              break;
            }
          } else {
            if (!(rules.hostility_edge & cell_bit(piece))) {
              axis_safe = true;
              break;
            }
          }
        }
        if (!axis_safe) return false;
      }
    }
    return true;
  }

  // --- shieldwall (logic.rs:471-569) ---
  bool sw_search(int pr, int pc, int axis /*1=row walk*/, int away, int dir,
                 std::vector<int>* wall) const {
    wall->clear();
    int r = pr, c = pc;
    while (true) {
      if (axis == 1) c += dir; else r += dir;
      if (!in_bounds(r, c)) return false;
      int8_t cell = at(r, c);
      bool occupied = cell != EMPTY;
      bool corner_close = rules.sw_corners_may_close && is_corner(r, c);
      if (!occupied && !corner_close) return false;
      if (!occupied) return wall->size() >= 2;  // closing corner
      if (side_of(cell) != side_to_play) {
        int prr = r, pcc = c;
        if (axis == 1) prr += away; else pcc += away;
        if (!in_bounds(prr, pcc) || at(prr, pcc) == EMPTY) return false;
        if (side_of(at(prr, pcc)) == side_to_play) wall->push_back(r * n + c);
        else return false;
      }
      if (side_of(cell) == side_to_play || corner_close)
        return wall->size() >= 2;
    }
  }

  void detect_shieldwall(int tr, int tc, std::vector<int>* captures) const {
    if (!rules.has_shieldwall) return;
    int axis, away;
    if (tr == 0) { axis = 1; away = 1; }
    else if (tr == n - 1) { axis = 1; away = -1; }
    else if (tc == 0) { axis = 0; away = 1; }
    else if (tc == n - 1) { axis = 0; away = -1; }
    else return;
    std::vector<int> wall;
    bool found = sw_search(tr, tc, axis, away, -1, &wall);
    if (!found) found = sw_search(tr, tc, axis, away, 1, &wall);
    if (!found || wall.size() < 2) return;
    for (int t : wall)
      if (rules.sw_captures & cell_bit(board[t])) captures->push_back(t);
  }

  // --- captures (logic.rs:604-699, 859-879) ---
  void get_captures(int tr, int tc, int8_t moving, std::vector<int>* captures) const {
    static const int DR[4] = {-1, 1, 0, 0};
    static const int DC[4] = {0, 0, -1, 1};
    bool may_attack = moving != KING || rules.king_attack != (int)KAttack::ANVIL;
    int kr = -9, kc = -9;
    find_king(&kr, &kc);
    bool king_beside_throne =
        (std::abs(kr - thr_r()) + std::abs(kc - thr_c())) == 1;
    if (may_attack) {
      for (int d = 0; d < 4; ++d) {
        int nr = tr + DR[d], nc = tc + DC[d];
        if (!in_bounds(nr, nc)) continue;
        int8_t other = at(nr, nc);
        if (other == EMPTY || side_of(other) == side_of(moving)) continue;
        // strong-king-beside-throne special case (logic.rs:621-632)
        if (other == KING && king_beside_throne &&
            rules.king_strength == (int)KStrength::STRONG_BY_THRONE &&
            (rules.throne_movement == (int)Throne::NO_ENTRY ||
             rules.throne_movement == (int)Throne::KING_ENTRY)) {
          bool all = true;
          for (int d2 = 0; d2 < 4 && all; ++d2) {
            int ar = nr + DR[d2], ac = nc + DC[d2];
            if (!in_bounds(ar, ac)) continue;  // reference skips OOB neighbors
            if (!(is_throne(ar, ac) || tile_hostile(ar, ac, other))) all = false;
          }
          if (all) {
            captures->push_back(nr * n + nc);
            continue;
          }
        }
        int fr = tr + 2 * DR[d], fc = tc + 2 * DC[d];
        if (coords_hostile(fr, fc, other)) {
          if (other == KING && king_is_strong(kr, kc)) {
            bool perp;
            if (tr == nr)
              perp = coords_hostile(nr + 1, nc, other) &&
                     coords_hostile(nr - 1, nc, other);
            else
              perp = coords_hostile(nr, nc + 1, other) &&
                     coords_hostile(nr, nc - 1, other);
            if (!perp) continue;
          }
          captures->push_back(nr * n + nc);
        } else if (rules.linnaean_capture && side_to_play == 0) {
          // Linnaean capture (logic.rs:859-879)
          if (in_bounds(fr, fc) && is_throne(fr, fc) && at(fr, fc) == KING) {
            int hostile_count = 0;
            for (int d2 = 0; d2 < 4; ++d2) {
              int ar = fr + DR[d2], ac = fc + DC[d2];
              if (in_bounds(ar, ac) && tile_hostile(ar, ac, KING)) ++hostile_count;
            }
            if (hostile_count == 3) captures->push_back(nr * n + nc);
          }
        }
      }
    }
    detect_shieldwall(tr, tc, captures);
    // dedupe
    std::vector<int> out;
    for (int t : *captures) {
      bool dup = false;
      for (int u : out) dup |= (u == t);
      if (!dup) out.push_back(t);
    }
    *captures = out;
  }

  // --- exit fort (logic.rs:572-601) ---
  bool detect_exit_fort() const {
    int kr, kc;
    if (!find_king(&kr, &kc) || !at_edge(kr, kc)) return false;
    bool region[MAX_N * MAX_N], boundary[MAX_N * MAX_N];
    // enclosed = {king}, enclosing = defender pieces.
    bool ok = find_enclosure(
        kr, kc, [](int8_t c) { return c == KING; },
        [](int8_t c) { return c == DEF || c == KING; }, false, true, region,
        boundary);
    if (!ok) return false;
    static const int DR[4] = {-1, 1, 0, 0};
    static const int DC[4] = {0, 0, -1, 1};
    bool king_free = false;
    for (int d = 0; d < 4; ++d) {
      int ar = kr + DR[d], ac = kc + DC[d];
      if (in_bounds(ar, ac) && at(ar, ac) == EMPTY) king_free = true;
    }
    if (!king_free) return false;
    return enclosure_secure(region, boundary, true, false);
  }

  // --- surround win (logic.rs:720-734) ---
  bool surround_win() const {
    if (!rules.has_enclosure_win) return false;
    int kr, kc;
    if (!find_king(&kr, &kc)) return false;
    bool region[MAX_N * MAX_N], boundary[MAX_N * MAX_N];
    bool ok = find_enclosure(
        kr, kc, [](int8_t c) { return c == DEF || c == KING; },
        [](int8_t c) { return c == ATT; },
        rules.enclosure_without_edge_access != 0, true, region, boundary);
    if (!ok) return false;
    int defenders = 0, inside = 0;
    for (int t = 0; t < n * n; ++t) {
      if (board[t] == DEF || board[t] == KING) {
        ++defenders;
        if (region[t]) ++inside;
      }
    }
    if (inside != defenders) return false;
    return enclosure_secure(region, boundary, false, true);
  }

  // --- step (logic.rs:782-820) ---
  // Returns 0 ok; 1 invalid action; 2 game over.
  int step(int action) {
    if (result != ONGOING) return 2;
    if (action < 0 || action >= A) return 1;
    int per_tile = 4 * (n - 1);
    int from = action / per_tile;
    int rem = action % per_tile;
    int d = rem / (n - 1);
    int dist = rem % (n - 1) + 1;
    int fr = from / n, fc = from % n;
    static const int DR[4] = {-1, 1, 0, 0};
    static const int DC[4] = {0, 0, -1, 1};
    int tr = fr + DR[d] * dist, tc = fc + DC[d] * dist;
    // validate against generated moves
    uint8_t valid = 0;
    {
      std::vector<uint8_t> mask(A, 0);
      int8_t p = at(fr, fc);
      if (p != EMPTY && side_of(p) == side_to_play) {
        gen_piece_moves(fr, fc, mask.data());
        valid = mask[action];
      }
    }
    if (!valid) return 1;

    int8_t moving = at(fr, fc);
    set(fr, fc, EMPTY);
    set(tr, tc, moving);
    last_captures.clear();
    get_captures(tr, tc, moving, &last_captures);
    int kr = -1, kc = -1;
    bool king_alive = find_king(&kr, &kc);  // before removal
    bool king_captured = false;
    for (int t : last_captures) {
      if (king_alive && t == kr * n + kc) king_captured = true;
      board[t] = EMPTY;
    }
    bool captured_any = !last_captures.empty();

    // repetition tracking (state.rs:92-113)
    ShortRec rec{side_to_play, action, captured_any, true};
    ShortRec& oldest = recent[rep_first_i];
    if (!captured_any && oldest == rec) {
      if (!mid_pair[side_to_play]) reps[side_to_play] += 1;
      mid_pair[side_to_play] = !mid_pair[side_to_play];
    } else {
      reps[side_to_play] = 0;
      mid_pair[side_to_play] = false;
    }
    recent[rep_first_i] = rec;
    rep_first_i = (rep_first_i + 1) % 4;
    if (!captured_any) ++plays_since_capture;  // never reset (logic.rs:797)

    // outcome (logic.rs:702-771)
    int other = 1 - side_to_play;
    int other_count = 0;
    for (int t = 0; t < n * n; ++t) {
      int8_t cl = board[t];
      if (cl == EMPTY) continue;
      if (side_of(cl) == other) ++other_count;
    }
    int res = ONGOING, rsn = R_NONE;
    if (other_count == 0) {
      res = side_to_play;
      rsn = R_ALL_CAPTURED;
    } else if (side_to_play == 0) {
      if (king_captured) { res = WIN_ATT; rsn = R_KING_CAPTURED; }
      else if (surround_win()) { res = WIN_ATT; rsn = R_ENCLOSED; }
    } else {
      bool escape = rules.edge_escape ? at_edge(tr, tc) : is_corner(tr, tc);
      if (moving == KING && escape) { res = WIN_DEF; rsn = R_KING_ESCAPED; }
      else if (rules.exit_fort && detect_exit_fort()) {
        res = WIN_DEF; rsn = R_EXIT_FORT;
      }
    }
    if (res == ONGOING && rules.has_repetition_rule &&
        reps[side_to_play] >= rules.rep_n) {
      if (rules.rep_is_loss) { res = other; rsn = R_REPETITION; }
      else { res = DRAW_; rsn = R_DRAW_REPETITION; }
    }
    if (res == ONGOING && !side_can_play(other)) {
      if (rules.draw_on_no_plays) { res = DRAW_; rsn = R_DRAW_NO_PLAYS; }
      else { res = side_to_play; rsn = R_NO_PLAYS; }
    }
    ++turn;
    result = res;
    reason = rsn;
    side_to_play = other;
    return 0;
  }
};

}  // namespace

extern "C" {

Engine* tafl_new(const TaflRules* rules, const char* fen, int side_to_play) {
  Engine* e = new Engine();
  e->rules = *rules;
  if (!e->parse_fen(fen)) {
    delete e;
    return nullptr;
  }
  e->side_to_play = side_to_play;
  return e;
}

void tafl_free(Engine* e) { delete e; }
int tafl_n(Engine* e) { return e->n; }
int tafl_num_actions(Engine* e) { return e->A; }
int tafl_side_to_play(Engine* e) { return e->side_to_play; }
int tafl_result(Engine* e) { return e->result; }
int tafl_reason(Engine* e) { return e->reason; }
long long tafl_turn(Engine* e) { return e->turn; }
long long tafl_reps(Engine* e, int side) { return e->reps[side]; }

void tafl_board(Engine* e, int8_t* out) {
  std::memcpy(out, e->board, e->n * e->n);
}

int tafl_legal_actions(Engine* e, uint8_t* mask_out) {
  std::memset(mask_out, 0, e->A);
  return e->legal_actions(e->side_to_play, mask_out);
}

int tafl_step(Engine* e, int action) { return e->step(action); }

int tafl_last_captures(Engine* e, int32_t* tiles_out) {
  for (size_t i = 0; i < e->last_captures.size(); ++i)
    tiles_out[i] = e->last_captures[i];
  return (int)e->last_captures.size();
}

}  // extern "C"
