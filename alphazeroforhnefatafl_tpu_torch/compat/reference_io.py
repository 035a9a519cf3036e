"""API-parity helpers mirroring the reference's NN-facing sketches.

The port's own copy of the JAX package's ``compat/reference_io.py``, over
the port's oracle. The reference's demo binary sketches a training-data path
(``game/main.rs:33-132``): enumerate legal moves, produce a 0/1 validity
mask, encode the board as an integer matrix, and append examples to a
bounded text file acting as a replay buffer. These helpers reproduce that
surface for users migrating from the reference, while the real training path
uses :mod:`..train.replay`.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from ..core import actions as A
from ..core.oracle import Game, Play
from ..core.rules import CELL_ATT, CELL_DEF, CELL_KING


def get_all_possible_moves(game: Game) -> List[Play]:
    """All legal plays for the side to move (``game/main.rs:33-43``)."""
    return game.logic.all_plays(game.state)


def validate_moves(game: Game, plays: Sequence[Play]) -> List[int]:
    """0/1 validity mask over a move list (``game/main.rs:45-52``)."""
    return [
        1 if game.logic.validate_play(p, game.state) is None else 0 for p in plays
    ]


def board_to_matrix(board: np.ndarray, fix_side_blindness: bool = False) -> np.ndarray:
    """Integer-matrix board encoding (``game/main.rs:55-83``).

    The reference encoding: corners are 20, throne is 30, then piece values
    are *added* on top — soldier +1, knight +2, king +5 — without
    distinguishing attacker from defender (a defect noted in SURVEY.md §3.4).
    With ``fix_side_blindness=True``, defender soldiers add 3 instead of 1 so
    sides are distinguishable; the default reproduces the reference exactly.
    """
    board = np.asarray(board)
    n = board.shape[0]
    m = np.zeros((n, n), dtype=np.int64)
    for r, c in [(0, 0), (0, n - 1), (n - 1, 0), (n - 1, n - 1)]:
        m[r, c] = 20
    m[n // 2, n // 2] = 30
    soldier_def = 3 if fix_side_blindness else 1
    m += np.where(
        board == CELL_ATT, 1, np.where(board == CELL_DEF, soldier_def, 0)
    )
    m += np.where(board == CELL_KING, 5, 0)
    return m


def write_to_file(
    file_path: str,
    matrix: np.ndarray,
    vector: Sequence[int],
    value1: int,
    value2: int,
    max_entries: int,
) -> None:
    """Bounded-FIFO replay text file (``game/main.rs:86-132``).

    Each entry is the matrix rows (comma-separated), the mask vector, and
    two scalar values, newline-separated; when the file holds ``max_entries``
    entries the oldest is evicted (``main.rs:103-106``).

    Note: like the reference, an "entry" boundary is a *line*, so
    ``max_entries`` bounds the number of lines retained, and entries span
    multiple lines. This reproduces the reference behavior exactly, quirks
    included.
    """
    entries: List[str] = []
    if os.path.exists(file_path):
        with open(file_path) as f:
            entries = [line.rstrip("\n") for line in f]
    if len(entries) >= max_entries:
        entries.pop(0)
    matrix = np.asarray(matrix)
    new_entry = "\n".join(
        [",".join(str(int(v)) for v in row) for row in matrix]
        + [",".join(str(int(v)) for v in vector), str(int(value1)), str(int(value2))]
    )
    entries.append(new_entry)
    with open(file_path, "w") as f:
        for e in entries:
            f.write(e + "\n")


def read_entries(file_path: str, side_len: int) -> List[Tuple[np.ndarray, np.ndarray, int, int]]:
    """Parse a replay file written by :func:`write_to_file` back into
    (matrix, vector, value1, value2) tuples."""
    with open(file_path) as f:
        lines = [line.rstrip("\n") for line in f if line.strip()]
    out = []
    stride = side_len + 3
    for i in range(0, len(lines) - stride + 1, stride):
        matrix = np.array(
            [[int(x) for x in lines[i + r].split(",")] for r in range(side_len)]
        )
        vector = np.array([int(x) for x in lines[i + side_len].split(",")])
        v1 = int(lines[i + side_len + 1])
        v2 = int(lines[i + side_len + 2])
        out.append((matrix, vector, v1, v2))
    return out
