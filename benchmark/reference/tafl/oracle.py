"""Pure-Python tafl rules oracle — the behavioral specification.

The port's own copy of the JAX package's ``core/oracle.py``: a complete,
independent re-implementation of the reference's Rust game engine semantics
(``game/game/logic.rs``, ``game/game/state.rs``, ``game/board/state.rs``,
``game/play.rs``). It is deliberately written at tile level with plain Python
data structures: it is the *golden model* against which the port's batched
env (:mod:`.env`) is differentially tested, and the host-side engine of
``cli play``. ``tests/test_torch_oracle.py`` holds this copy equal to the
JAX package's.

Citations in docstrings point at the reference behavior being matched.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

import numpy as np

from . import fen
from .rules import (
    CELL_ATT,
    CELL_DEF,
    CELL_KING,
    EMPTY,
    KING,
    PIECE_CLASSES,
    DrawReason,
    EnclosureWinRules,
    KingAttack,
    KingStrength,
    Piece,
    PieceSet,
    PieceType,
    PlayInvalid,
    Ruleset,
    Side,
    ThroneRule,
    WinReason,
)

Tile = Tuple[int, int]  # (row, col)

NEIGHBOR_OFFSETS = ((-1, 0), (1, 0), (0, -1), (0, 1))  # game/board/geometry.rs:5


@dataclass(frozen=True)
class Play:
    """A move: source tile, axis and signed displacement (``game/play.rs:23-27``).

    ``axis`` is 0 for vertical (row changes), 1 for horizontal (col changes),
    matching ``tiles.rs:167-170`` (Vertical / Horizontal).
    """

    from_tile: Tile
    axis: int
    displacement: int

    @staticmethod
    def from_tiles(src: Tile, dst: Tile) -> "Play":
        """``Play::from_tiles`` (``game/play.rs:36-49``)."""
        if src[0] == dst[0]:
            return Play(src, 1, dst[1] - src[1])
        if src[1] == dst[1]:
            return Play(src, 0, dst[0] - src[0])
        raise ValueError(f"disjoint tiles {src} -> {dst}")

    @staticmethod
    def from_str(s: str) -> "Play":
        src, dst = fen.play_from_str(s)
        return Play.from_tiles(src, dst)

    @property
    def distance(self) -> int:
        return abs(self.displacement)

    @property
    def to(self) -> Tile:
        """Destination (may be out of bounds) (``game/play.rs:59-67``)."""
        r, c = self.from_tile
        if self.axis == 0:
            return (r + self.displacement, c)
        return (r, c + self.displacement)

    def __str__(self) -> str:
        return fen.play_to_str(self.from_tile, self.to)


@dataclass
class Enclosure:
    """An enclosed area (``game/game/logic.rs:24-38``)."""

    occupied: Set[Tile] = field(default_factory=set)
    unoccupied: Set[Tile] = field(default_factory=set)
    boundary: Set[Tile] = field(default_factory=set)

    def contains(self, tile: Tile) -> bool:
        return tile in self.occupied or tile in self.unoccupied


@dataclass(frozen=True)
class Outcome:
    """``GameOutcome`` (``game/game/mod.rs:46-51``): a win or a draw."""

    winner: Optional[Side]  # None => draw
    win_reason: Optional[WinReason] = None
    draw_reason: Optional[DrawReason] = None

    @staticmethod
    def win(reason: WinReason, side: Side) -> "Outcome":
        return Outcome(winner=side, win_reason=reason)

    @staticmethod
    def draw(reason: DrawReason) -> "Outcome":
        return Outcome(winner=None, draw_reason=reason)


@dataclass(frozen=True)
class PlayRecord:
    """A record of a single play (``game/play.rs:105-133``).

    ``str()`` uses the reference's capture notation: the play in ``a8-a11``
    form, then ``x`` and the captured tiles joined by ``/``.
    """

    side: Side
    play: Play
    captures: frozenset  # of Tile
    outcome: Optional[Outcome] = None

    def eq_ignore_outcome(self, other: "PlayRecord") -> bool:
        return self.side == other.side and self.play == other.play

    def __str__(self) -> str:
        s = str(self.play)
        if self.captures:
            tiles = sorted(self.captures)
            s += "x" + "/".join(fen.tile_to_str(r, c) for r, c in tiles)
        return s


@dataclass(frozen=True)
class ShortPlayRecord:
    """Play info relevant for repetition detection (``game/game/state.rs:15-19``)."""

    side: Side
    play: Play
    captures: bool


@dataclass
class RepetitionTracker:
    """Consecutive-repetition counter (``game/game/state.rs:41-114``).

    A play is a repetition iff it does not capture, equals the 4th-last play,
    and is not the second leg of an A-B-A pair (tracked by a per-side
    mid-pair toggle).
    """

    attacker_reps: int = 0
    defender_reps: int = 0
    attacker_mid_pair: bool = False
    defender_mid_pair: bool = False
    # Fixed-size-4 ring; index `first_i` holds the play made 4 plays ago
    # (game/utils.rs:30-72).
    recent: List[Optional[ShortPlayRecord]] = field(default_factory=lambda: [None] * 4)
    first_i: int = 0

    def get_repetitions(self, side: Side) -> int:
        return self.attacker_reps if side == Side.ATTACKER else self.defender_reps

    def track_play(self, side: Side, play: Play, captures: bool) -> None:
        """``RepetitionTracker::track_play`` (``game/game/state.rs:92-113``)."""
        record = ShortPlayRecord(side, play, captures)
        oldest = self.recent[self.first_i]
        if (not captures) and oldest == record:
            mid = self.attacker_mid_pair if side == Side.ATTACKER else self.defender_mid_pair
            if not mid:  # increment
                if side == Side.ATTACKER:
                    self.attacker_reps += 1
                else:
                    self.defender_reps += 1
            # toggle mid-pair, no reset
            if side == Side.ATTACKER:
                self.attacker_mid_pair = not self.attacker_mid_pair
            else:
                self.defender_mid_pair = not self.defender_mid_pair
        else:  # reset
            if side == Side.ATTACKER:
                self.attacker_reps = 0
                self.attacker_mid_pair = False
            else:
                self.defender_reps = 0
                self.defender_mid_pair = False
        self.recent[self.first_i] = record
        self.first_i = (self.first_i + 1) % 4


@dataclass
class GameState:
    """Mutable per-game state (``game/game/state.rs:119-133``)."""

    board: np.ndarray  # int8[N, N]
    side_to_play: Side
    repetitions: RepetitionTracker = field(default_factory=RepetitionTracker)
    plays_since_capture: int = 0
    outcome: Optional[Outcome] = None  # None => ongoing
    turn: int = 0

    @property
    def ongoing(self) -> bool:
        return self.outcome is None

    @staticmethod
    def from_fen(fen_str: str, side_to_play: Side) -> "GameState":
        return GameState(board=fen.board_from_fen(fen_str), side_to_play=side_to_play)

    def swap_pieces(self, t1: Tile, t2: Tile) -> None:
        """Swap the pieces at two tiles (``game/board/state.rs:68-79``).

        The reference must shepherd its packed king nibble through the swap;
        here the king is just cell value 3, so an array swap is exact.
        """
        a, b = self.board[t1], self.board[t2]
        self.board[t1], self.board[t2] = b, a

    def copy(self) -> "GameState":
        return GameState(
            board=self.board.copy(),
            side_to_play=self.side_to_play,
            repetitions=RepetitionTracker(
                self.repetitions.attacker_reps,
                self.repetitions.defender_reps,
                self.repetitions.attacker_mid_pair,
                self.repetitions.defender_mid_pair,
                list(self.repetitions.recent),
                self.repetitions.first_i,
            ),
            plays_since_capture=self.plays_since_capture,
            outcome=self.outcome,
            turn=self.turn,
        )


def _cell_piece(cell: int) -> Optional[Piece]:
    return None if cell == EMPTY else PIECE_CLASSES[cell - 1]


def _cell_side(cell: int) -> Optional[Side]:
    if cell == EMPTY:
        return None
    return Side.ATTACKER if cell == CELL_ATT else Side.DEFENDER


class GameLogic:
    """Stateless rules evaluator (``game/game/logic.rs:62-65``).

    Holds the :class:`Ruleset` and board geometry; methods take a
    :class:`GameState`.
    """

    def __init__(self, rules: Ruleset, side_len: int):
        self.rules = rules
        self.n = side_len
        self.throne: Tile = (side_len // 2, side_len // 2)
        self.corners: FrozenSet[Tile] = frozenset(
            [(0, 0), (0, side_len - 1), (side_len - 1, side_len - 1), (side_len - 1, 0)]
        )

    # ----- geometry (game/board/geometry.rs) -----

    def in_bounds(self, t: Tile) -> bool:
        return 0 <= t[0] < self.n and 0 <= t[1] < self.n

    def neighbors(self, t: Tile) -> List[Tile]:
        """In-bounds orthogonal neighbors (``geometry.rs:68-81``)."""
        out = []
        for dr, dc in NEIGHBOR_OFFSETS:
            nt = (t[0] + dr, t[1] + dc)
            if self.in_bounds(nt):
                out.append(nt)
        return out

    def tiles_between(self, t1: Tile, t2: Tile) -> List[Tile]:
        """``geometry.rs:85-108``; empty if no shared axis."""
        (r1, c1), (r2, c2) = t1, t2
        if r1 == r2:
            lo, hi = sorted((c1, c2))
            return [(r1, c) for c in range(lo + 1, hi)]
        if c1 == c2:
            lo, hi = sorted((r1, r2))
            return [(r, c1) for r in range(lo + 1, hi)]
        return []

    def at_edge(self, t: Tile) -> bool:
        return t[0] in (0, self.n - 1) or t[1] in (0, self.n - 1)

    # ----- board helpers (game/board/state.rs) -----

    def get_king(self, board: np.ndarray) -> Optional[Tile]:
        pos = np.argwhere(board == CELL_KING)
        if len(pos) == 0:
            return None
        return (int(pos[0][0]), int(pos[0][1]))

    def count_pieces(self, board: np.ndarray, side: Side) -> int:
        """Piece count incl. king for defenders (``board/state.rs:195-200``)."""
        if side == Side.ATTACKER:
            return int(np.sum(board == CELL_ATT))
        return int(np.sum((board == CELL_DEF) | (board == CELL_KING)))

    # ----- hostility (logic.rs:76-114) -----

    def special_tile_hostile(self, t: Tile, piece: Piece) -> bool:
        """``logic.rs:76-82``."""
        h = self.rules.hostility
        return (
            (h.throne.contains(piece) and t == self.throne)
            or (h.corners.contains(piece) and t in self.corners)
            or (h.edge.contains(piece) and not self.in_bounds(t))
        )

    def tile_hostile(self, board: np.ndarray, t: Tile, piece: Piece) -> bool:
        """``logic.rs:85-99``. ``t`` must be in bounds."""
        cell = int(board[t])
        other = _cell_piece(cell)
        if other is not None:
            return other.side != piece.side and (
                other.piece_type != PieceType.KING
                or self.rules.king_attack in (KingAttack.ARMED, KingAttack.ANVIL)
            )
        return self.special_tile_hostile(t, piece)

    def coords_hostile(self, board: np.ndarray, t: Tile, piece: Piece) -> bool:
        """``logic.rs:103-114``: out-of-bounds is hostile iff edge hostile."""
        if self.in_bounds(t):
            return self.tile_hostile(board, t, piece)
        return self.rules.hostility.edge.contains(piece)

    # ----- play validation (logic.rs:119-222) -----

    def validate_play_for_side(
        self, play: Play, side: Side, state: GameState
    ) -> Optional[PlayInvalid]:
        """``logic.rs:159-214``. Returns None if valid, else the error code."""
        if not state.ongoing:
            return PlayInvalid.GAME_OVER
        frm = play.from_tile
        to = play.to
        if not self.in_bounds(frm):
            return PlayInvalid.NO_PIECE  # get_piece on OOB tile: no piece
        piece = _cell_piece(int(state.board[frm]))
        if piece is None:
            return PlayInvalid.NO_PIECE
        if piece.side != side:
            return PlayInvalid.WRONG_PLAYER
        if not (self.in_bounds(frm) and self.in_bounds(to)):
            return PlayInvalid.OUT_OF_BOUNDS
        if frm[0] != to[0] and frm[1] != to[1]:
            return PlayInvalid.NO_COMMON_AXIS
        if state.board[to] != EMPTY:
            return PlayInvalid.BLOCKED_BY_PIECE
        between = self.tiles_between(frm, to)
        if any(state.board[t] != EMPTY for t in between):
            return PlayInvalid.BLOCKED_BY_PIECE
        if not self.rules.may_enter_corners.contains(piece) and to in self.corners:
            return PlayInvalid.MOVE_ONTO_BLOCKED_TILE
        tm = self.rules.throne_movement
        is_king = piece.piece_type == PieceType.KING
        if (
            tm == ThroneRule.NO_PASS or (tm == ThroneRule.KING_PASS and not is_king)
        ) and self.throne in between:
            return PlayInvalid.MOVE_THROUGH_BLOCKED_TILE
        if (
            tm == ThroneRule.NO_ENTRY or (tm == ThroneRule.KING_ENTRY and not is_king)
        ) and to == self.throne:
            return PlayInvalid.MOVE_ONTO_BLOCKED_TILE
        if self.rules.slow_pieces.contains(piece) and play.distance > 1:
            return PlayInvalid.TOO_FAR
        return None

    def validate_play(self, play: Play, state: GameState) -> Optional[PlayInvalid]:
        return self.validate_play_for_side(play, state.side_to_play, state)

    def can_occupy_or_pass(self, play: Play, piece: Piece, state: GameState) -> Tuple[bool, bool]:
        """``logic.rs:119-154``: (can_occupy, can_pass) for the move iterator."""
        err = self.validate_play_for_side(play, piece.side, state)
        can_occupy = err is None
        if can_occupy:
            return True, True
        if err == PlayInvalid.MOVE_ONTO_BLOCKED_TILE:
            if play.to == self.throne:
                tm = self.rules.throne_movement
                if tm == ThroneRule.NO_PASS:
                    return False, False
                if tm == ThroneRule.KING_PASS:
                    return False, piece.piece_type == PieceType.KING
                return False, True  # NoThrone / NoEntry / KingEntry
            return False, False  # corner: cannot pass
        return False, False

    # ----- legal move generation (game/play.rs:139-226) -----

    def iter_plays(self, tile: Tile, state: GameState) -> Iterator[Play]:
        """Legal plays of the piece at ``tile`` (``play.rs:186-225``)."""
        piece = _cell_piece(int(state.board[tile]))
        if piece is None:
            raise ValueError(f"no piece at {tile}")
        for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1)):
            for dist in range(1, self.n):
                play = Play(tile, axis, sign * dist)
                if not self.in_bounds(play.to):
                    break
                can_occupy, can_pass = self.can_occupy_or_pass(play, piece, state)
                if can_occupy:
                    yield play
                elif can_pass:
                    continue
                else:
                    break

    def iter_occupied(self, board: np.ndarray, side: Side) -> Iterator[Tile]:
        if side == Side.ATTACKER:
            mask = board == CELL_ATT
        else:
            mask = (board == CELL_DEF) | (board == CELL_KING)
        for r, c in np.argwhere(mask):
            yield (int(r), int(c))

    def all_plays(self, state: GameState, side: Optional[Side] = None) -> List[Play]:
        side = state.side_to_play if side is None else side
        out: List[Play] = []
        for tile in self.iter_occupied(state.board, side):
            out.extend(self.iter_plays(tile, state))
        return out

    def side_can_play(self, side: Side, state: GameState) -> bool:
        """``logic.rs:837-846``."""
        for tile in self.iter_occupied(state.board, side):
            for _ in self.iter_plays(tile, state):
                return True
        return False

    # ----- king status (logic.rs:225-245) -----

    def king_beside_throne(self, board: np.ndarray) -> bool:
        return self.get_king(board) in self.neighbors(self.throne)

    def king_on_throne(self, board: np.ndarray) -> bool:
        return self.get_king(board) == self.throne

    def king_is_strong(self, board: np.ndarray) -> bool:
        ks = self.rules.king_strength
        if ks == KingStrength.STRONG:
            return True
        if ks == KingStrength.WEAK:
            return False
        return self.king_beside_throne(board) or self.king_on_throne(board)

    def coords_occupiable(self, t: Tile, piece: Piece) -> bool:
        """Rule-level occupiability ignoring occupancy (``logic.rs:250-266``)."""
        if not self.in_bounds(t):
            return False
        tm = self.rules.throne_movement
        is_king = piece.piece_type == PieceType.KING
        if t == self.throne and (
            tm == ThroneRule.NO_ENTRY or (tm == ThroneRule.KING_ENTRY and not is_king)
        ):
            return False
        if not self.rules.may_enter_corners.contains(piece) and t in self.corners:
            return False
        return True

    # ----- enclosures (logic.rs:270-463) -----

    def find_enclosure(
        self,
        start: Tile,
        enclosed: PieceSet,
        enclosing: PieceSet,
        abort_on_edge: bool,
        abort_on_corner: bool,
        board: np.ndarray,
    ) -> Optional[Enclosure]:
        """Flood fill from ``start`` over empty/enclosed tiles (``logic.rs:309-401``).

        Returns None if: the start tile is not fillable; the fill (including
        the start tile) reaches an edge/corner tile while the respective abort
        flag is set; or any tile visited by the fill scan contains a piece that
        is neither enclosed nor enclosing. Boundary is the set of enclosing
        pieces adjacent to the filled region.
        """

        def classify(t: Tile) -> str:
            cell = int(board[t])
            if cell == EMPTY:
                return "fill"
            p = PIECE_CLASSES[cell - 1]
            if enclosed.contains(p):  # enclosed checked first (logic.rs:281-292)
                return "fill"
            if enclosing.contains(p):
                return "boundary"
            return "neither"

        encl = Enclosure()
        if classify(start) != "fill":
            # Start not fillable: boundary start => "no enclosure" per
            # row_col_enclosed returning false at logic.rs:320-326; neither
            # start => None. Both map to None here.
            return None
        stack = [start]
        region: Set[Tile] = {start}
        while stack:
            t = stack.pop()
            if abort_on_edge and self.at_edge(t):
                return None
            if abort_on_corner and t in self.corners:
                return None
            if board[t] == EMPTY:
                encl.unoccupied.add(t)
            else:
                encl.occupied.add(t)
            for nt in (
                (t[0] - 1, t[1]),
                (t[0] + 1, t[1]),
                (t[0], t[1] - 1),
                (t[0], t[1] + 1),
            ):
                if not self.in_bounds(nt) or nt in region:
                    continue
                kind = classify(nt)
                if kind == "neither":
                    return None
                if kind == "boundary":
                    encl.boundary.add(nt)
                else:
                    region.add(nt)
                    stack.append(nt)
        return encl

    def enclosure_secure(
        self, encl: Enclosure, inside_safe: bool, outside_safe: bool, board: np.ndarray
    ) -> bool:
        """No boundary piece is capturable (``logic.rs:408-463``)."""
        if inside_safe and outside_safe:
            return True
        for t in encl.boundary:
            piece = _cell_piece(int(board[t]))
            assert piece is not None, "boundary tile must be occupied"
            hostile_soldier = Piece(PieceType.SOLDIER, piece.side.other)
            for axis in (0, 1):
                axis_safe = False
                for d in (-1, 1):
                    nt = (t[0] + d, t[1]) if axis == 0 else (t[0], t[1] + d)
                    if self.in_bounds(nt):
                        is_inside = encl.contains(nt)
                        if (inside_safe and is_inside) or (outside_safe and not is_inside):
                            if not self.special_tile_hostile(nt, piece):
                                axis_safe = True
                                break
                        if (not self.tile_hostile(board, nt, piece)) and (
                            board[nt] != EMPTY or not self.coords_occupiable(nt, hostile_soldier)
                        ):
                            axis_safe = True
                            break
                    else:
                        if not self.rules.hostility.edge.contains(piece):
                            axis_safe = True
                            break
                if not axis_safe:
                    return False
        return True

    # ----- shieldwalls (logic.rs:471-569) -----

    def _dir_sw_search(
        self, play: Play, axis: int, away_from_edge: int, direction: int, state: GameState
    ) -> Optional[Set[Tile]]:
        """One-direction shieldwall scan (``logic.rs:471-530``).

        ``axis``: 1 (horizontal) walks along a row; 0 (vertical) along a col.
        """
        sw = self.rules.shieldwall
        assert sw is not None
        t = play.to
        wall: Set[Tile] = set()
        while True:
            t = (t[0], t[1] + direction) if axis == 1 else (t[0] + direction, t[1])
            if not self.in_bounds(t):
                return None
            occupied = state.board[t] != EMPTY
            if not (occupied or (sw.corners_may_close and t in self.corners)):
                return None
            if not occupied:
                # unoccupied closing corner
                return wall if len(wall) >= 2 else None
            piece = _cell_piece(int(state.board[t]))
            assert piece is not None
            if piece.side == state.side_to_play.other:
                pin = (t[0] + away_from_edge, t[1]) if axis == 1 else (t[0], t[1] + away_from_edge)
                if not self.in_bounds(pin) or state.board[pin] == EMPTY:
                    return None  # not pinned against the edge
                pin_piece = _cell_piece(int(state.board[pin]))
                if pin_piece.side == state.side_to_play:
                    wall.add(t)
                else:
                    return None
            if piece.side == state.side_to_play or (
                t in self.corners and sw.corners_may_close
            ):
                return wall if len(wall) >= 2 else None

    def detect_shieldwall(self, play: Play, state: GameState) -> Optional[Set[Tile]]:
        """``logic.rs:535-569``. Returns captured tiles (filtered by rules)."""
        sw = self.rules.shieldwall
        if sw is None:
            return None
        to = play.to
        if to[0] == 0:
            axis, away = 1, 1
        elif to[0] == self.n - 1:
            axis, away = 1, -1
        elif to[1] == 0:
            axis, away = 0, 1
        elif to[1] == self.n - 1:
            axis, away = 0, -1
        else:
            return None
        wall = self._dir_sw_search(play, axis, away, -1, state)
        if wall is None:
            wall = self._dir_sw_search(play, axis, away, 1, state)
        if wall is None or len(wall) < 2:
            return None
        return {
            t for t in wall if sw.captures.contains(_cell_piece(int(state.board[t])))
        }

    # ----- exit fort (logic.rs:572-601) -----

    def detect_exit_fort(self, board: np.ndarray) -> bool:
        king = self.get_king(board)
        if king is None or not self.at_edge(king):
            return False
        encl = self.find_enclosure(
            king,
            PieceSet.from_piece_type(PieceType.KING),
            PieceSet.from_side(Side.DEFENDER),
            abort_on_edge=False,
            abort_on_corner=True,
            board=board,
        )
        if encl is None:
            return False
        # King must have an empty in-bounds neighbor (logic.rs:590-592).
        if not any(board[t] == EMPTY for t in self.neighbors(king)):
            return False
        return self.enclosure_secure(encl, inside_safe=True, outside_safe=False, board=board)

    # ----- captures (logic.rs:604-699, 859-879) -----

    def _detect_linnaean_capture(
        self, tile: Tile, far: Tile, state: GameState
    ) -> bool:
        """``logic.rs:859-879``: soldier pinned against a throne occupied by a
        king who is surrounded by exactly 3 hostile tiles."""
        if not self.in_bounds(far):
            return False
        if far != self.throne or int(state.board[far]) != CELL_KING:
            return False
        n_hostile = sum(
            1 for t in self.neighbors(far) if self.tile_hostile(state.board, t, KING)
        )
        return n_hostile == 3

    def get_captures(self, play: Play, moving_piece: Piece, state: GameState) -> Set[Tile]:
        """Captured tiles for a play already applied to ``state.board``
        (``logic.rs:604-699``)."""
        captures: Set[Tile] = set()
        to = play.to
        rules = self.rules
        king_may_attack = (
            moving_piece.piece_type != PieceType.KING
            or rules.king_attack in (KingAttack.ARMED, KingAttack.HAMMER)
        )
        if king_may_attack:
            for n_tile in self.neighbors(to):
                other = _cell_piece(int(state.board[n_tile]))
                if other is None or other.side == moving_piece.side:
                    continue
                # Strong-king-beside-throne special case (logic.rs:621-632)
                if (
                    other.piece_type == PieceType.KING
                    and self.king_beside_throne(state.board)
                    and rules.king_strength == KingStrength.STRONG_BY_THRONE
                    and rules.throne_movement in (ThroneRule.NO_ENTRY, ThroneRule.KING_ENTRY)
                    and all(
                        t == self.throne or self.tile_hostile(state.board, t, other)
                        for t in self.neighbors(n_tile)
                    )
                ):
                    captures.add(n_tile)
                    continue
                far = (to[0] + 2 * (n_tile[0] - to[0]), to[1] + 2 * (n_tile[1] - to[1]))
                if self.coords_hostile(state.board, far, other):
                    if other.piece_type == PieceType.KING and self.king_is_strong(state.board):
                        # perpendicular axis must also be hostile (logic.rs:647-674)
                        if to[0] == n_tile[0]:
                            perp = ((n_tile[0] + 1, n_tile[1]), (n_tile[0] - 1, n_tile[1]))
                        else:
                            perp = ((n_tile[0], n_tile[1] + 1), (n_tile[0], n_tile[1] - 1))
                        if not all(self.coords_hostile(state.board, p, other) for p in perp):
                            continue
                    captures.add(n_tile)
                elif rules.linnaean_capture and state.side_to_play == Side.ATTACKER:
                    if self._detect_linnaean_capture(n_tile, far, state):
                        captures.add(n_tile)
        walled = self.detect_shieldwall(play, state)
        if walled is not None:
            captures |= walled
        return captures

    # ----- outcome (logic.rs:702-771) -----

    def get_game_outcome(
        self,
        play: Play,
        moving_piece: Piece,
        captures: Set[Tile],
        king_tile_before_removal: Optional[Tile],
        state: GameState,
    ) -> Optional[Outcome]:
        """``logic.rs:702-771``. ``state`` has the play applied and captures
        removed; ``king_tile_before_removal`` is the king's position on the
        post-move board before captured pieces were cleared (mirroring the
        reference's king-position bits surviving removal,
        ``logic.rs:714-716``)."""
        rules = self.rules
        side = state.side_to_play
        if self.count_pieces(state.board, side.other) == 0:
            return Outcome.win(WinReason.ALL_CAPTURED, side)
        if side == Side.ATTACKER:
            if king_tile_before_removal is not None and king_tile_before_removal in captures:
                return Outcome.win(WinReason.KING_CAPTURED, Side.ATTACKER)
            if rules.enclosure_win is not None:
                king = self.get_king(state.board)
                if king is not None:
                    encl = self.find_enclosure(
                        king,
                        PieceSet.from_side(Side.DEFENDER),
                        PieceSet.from_side(Side.ATTACKER),
                        abort_on_edge=(
                            rules.enclosure_win == EnclosureWinRules.WITHOUT_EDGE_ACCESS
                        ),
                        abort_on_corner=True,
                        board=state.board,
                    )
                    if (
                        encl is not None
                        and len(encl.occupied) == self.count_pieces(state.board, Side.DEFENDER)
                        and self.enclosure_secure(
                            encl, inside_safe=False, outside_safe=True, board=state.board
                        )
                    ):
                        return Outcome.win(WinReason.ENCLOSED, Side.ATTACKER)
        else:
            if moving_piece.piece_type == PieceType.KING and (
                (rules.edge_escape and self.at_edge(play.to))
                or (not rules.edge_escape and play.to in self.corners)
            ):
                return Outcome.win(WinReason.KING_ESCAPED, Side.DEFENDER)
            if rules.exit_fort and self.detect_exit_fort(state.board):
                return Outcome.win(WinReason.EXIT_FORT, Side.DEFENDER)
        if rules.repetition_rule is not None:
            if state.repetitions.get_repetitions(side) >= rules.repetition_rule.n_repetitions:
                if rules.repetition_rule.is_loss:
                    return Outcome.win(WinReason.REPETITION, side.other)
                return Outcome.draw(DrawReason.REPETITION)
        if not self.side_can_play(side.other, state):
            if rules.draw_on_no_plays:
                return Outcome.draw(DrawReason.NO_PLAYS)
            return Outcome.win(WinReason.NO_PLAYS, side)
        return None

    # ----- play execution (logic.rs:782-834) -----

    def do_valid_play(self, play: Play, state: GameState) -> Tuple[GameState, Set[Tile], Optional[Outcome]]:
        """``logic.rs:782-820``: apply a known-valid play to a copy of ``state``.

        Returns (new_state, captured_tiles, outcome).
        """
        state = state.copy()
        frm, to = play.from_tile, play.to
        moving_cell = int(state.board[frm])
        moving_piece = _cell_piece(moving_cell)
        assert moving_piece is not None, "no piece to move"
        state.board[frm] = EMPTY
        state.board[to] = moving_cell
        captures = self.get_captures(play, moving_piece, state)
        king_before_removal = self.get_king(state.board)
        for t in captures:
            state.board[t] = EMPTY
        state.repetitions.track_play(state.side_to_play, play, bool(captures))
        if not captures:
            state.plays_since_capture += 1
        outcome = self.get_game_outcome(
            play, moving_piece, captures, king_before_removal, state
        )
        state.turn += 1
        state.outcome = outcome
        state.side_to_play = state.side_to_play.other
        return state, captures, outcome

    def do_play(self, play: Play, state: GameState) -> Tuple[GameState, Set[Tile], Optional[Outcome]]:
        """``logic.rs:827-834``: validate then execute."""
        err = self.validate_play(play, state)
        if err is not None:
            raise InvalidPlayError(err, play)
        return self.do_valid_play(play, state)


class InvalidPlayError(ValueError):
    def __init__(self, reason: PlayInvalid, play: Play):
        super().__init__(f"invalid play {play}: {reason.name}")
        self.reason = reason
        self.play = play


class Game:
    """Convenience wrapper bundling logic + state + histories
    (``game/game/mod.rs:76-116``)."""

    def __init__(self, rules: Ruleset, starting_board_fen: str):
        board = fen.board_from_fen(starting_board_fen)
        self.logic = GameLogic(rules, board.shape[0])
        self.state = GameState(board=board, side_to_play=rules.starting_side)
        self.play_history: List[PlayRecord] = []
        # Starts empty, where the reference's ``Game::new`` seeds it with the
        # initial state (``game/game/mod.rs:90``) and its first ``do_play``
        # pushes that state again. ``do_play`` here pushes the pre-play state,
        # so this history holds one entry fewer, but the undo observables are
        # the same: the state, the play history, and an undo with no play
        # left being a silent no-op.
        self.state_history: List[GameState] = []

    def do_play(self, play: Play) -> Optional[Outcome]:
        side = self.state.side_to_play
        new_state, captures, outcome = self.logic.do_play(play, self.state)
        self.state_history.append(self.state)
        self.state = new_state
        self.play_history.append(
            PlayRecord(side, play, frozenset(captures), outcome)
        )
        return outcome

    def undo_last_play(self) -> None:
        """``game/game/mod.rs:103-108``: pop the previous state if any; with
        no plays to undo this is a silent no-op (the reference's own
        ``test_undo``, ``mod.rs:209-231``, undoes one extra time and asserts
        the state is unchanged)."""
        if self.state_history:
            self.state = self.state_history.pop()
            self.play_history.pop()
