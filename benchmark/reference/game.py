"""The rules reference in the env's terms: legal action ids, a checked play,
and a state's fields as the program's ``EnvState`` names them. Built on the
frozen oracle in :mod:`.tafl`; imports nothing of the program."""

from __future__ import annotations

import numpy as np

from .tafl import actions as A
from .tafl import oracle
from .tafl.fen import board_from_fen
from .tafl.rules import PRESETS

ONGOING, DRAW = -1, 2


class Rules:
    """One preset's rules: opening state, legal actions, plays."""

    def __init__(self, preset: str):
        self.rules, self.fen = PRESETS[preset]
        self.n = int(board_from_fen(self.fen).shape[0])
        self.num_actions = A.num_actions(self.n)
        self.logic = oracle.GameLogic(self.rules, self.n)

    def opening(self) -> oracle.GameState:
        return oracle.GameState.from_fen(self.fen, self.rules.starting_side)

    def legal(self, state: oracle.GameState) -> np.ndarray:
        """Sorted legal action ids of the side to move (none once ended)."""
        if not state.ongoing:
            return np.zeros((0,), np.int64)
        ids = [A.encode_from_tiles(self.n, p.from_tile, p.to) for p in self.logic.all_plays(state)]
        return np.array(sorted(ids), np.int64)

    def legal_mask(self, state: oracle.GameState) -> np.ndarray:
        m = np.zeros((self.num_actions,), bool)
        m[self.legal(state)] = True
        return m

    def play(self, state: oracle.GameState, action: int):
        """The state after ``action``, or None when it is not a legal play."""
        if not state.ongoing or not 0 <= action < self.num_actions:
            return None
        src, dst = A.decode_to_tiles(self.n, int(action))
        if not (0 <= dst[0] < self.n and 0 <= dst[1] < self.n):
            return None
        play = oracle.Play.from_tiles(src, dst)
        if self.logic.validate_play(play, state) is not None:
            return None
        new, _, _ = self.logic.do_valid_play(play, state)
        return new


def fields(state: oracle.GameState) -> dict:
    """The state as the env's fields: board, side to move, both repetition
    counts and mid-pair flags, plays since a capture, turn, and the outcome
    (terminated, result, reason: a win's reason, or 16 + a draw's)."""
    r, o = state.repetitions, state.outcome
    if o is None:
        result, reason = ONGOING, -1
    elif o.winner is None:
        result, reason = DRAW, 16 + int(o.draw_reason)
    else:
        result, reason = int(o.winner), int(o.win_reason)
    return {
        "board": state.board,
        "side": int(state.side_to_play),
        "reps": (r.attacker_reps, r.defender_reps),
        "mid_pair": (int(r.attacker_mid_pair), int(r.defender_mid_pair)),
        "plays_since_capture": state.plays_since_capture,
        "turn": state.turn,
        "terminated": int(o is not None),
        "result": result,
        "reason": reason,
    }


def mover_reps(state: oracle.GameState) -> int:
    r = state.repetitions
    return r.defender_reps if int(state.side_to_play) else r.attacker_reps


def terminal_value(state: oracle.GameState) -> float:
    """Value of an ended game for its side to move: +1 won, -1 lost, 0 drawn."""
    o = state.outcome
    if o is None or o.winner is None:
        return 0.0
    return 1.0 if int(o.winner) == int(state.side_to_play) else -1.0
