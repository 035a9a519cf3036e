"""FEN and display-string codecs, tile and play notation.

The port's own copy of the JAX package's ``core/fen.py``. Behavioral match
of the reference's serde surfaces:
``game/board/state.rs:225-311`` (FEN / display-string round trip),
``game/tiles.rs:137-157`` (``a8`` tile notation: column letter + 1-based row),
``game/play.rs:70-92`` (``a8-a11`` play notation).

Boards are int8 numpy arrays with cell codes from
:mod:`.rules` (0 empty, 1 attacker soldier,
2 defender soldier, 3 king).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .rules import CELL_ATT, CELL_DEF, CELL_KING, EMPTY

_CELL_TO_CHAR = {EMPTY: None, CELL_ATT: "t", CELL_DEF: "T", CELL_KING: "K"}
# Char serde mirrors ``game/pieces.rs:100-141``: lowercase = attacker,
# uppercase = defender; t soldier, k king, n knight, c commander, g guard,
# m mercenary. The reference's bitfield board stores only side + king (the
# king nibble, ``game/board/state.rs:127-147``), so like it we fold the
# extended piece types into their side's soldier plane; an attacker "king"
# char likewise folds to an attacker soldier, since only the defender king is
# representable.
_CHAR_TO_CELL = {"t": CELL_ATT, "T": CELL_DEF, "K": CELL_KING, "k": CELL_ATT}
for _c in "ncgm":
    _CHAR_TO_CELL[_c] = CELL_ATT
    _CHAR_TO_CELL[_c.upper()] = CELL_DEF


class ParseError(ValueError):
    """Parse failure (``game/error.rs:6-25``)."""


def board_from_fen(fen: str) -> np.ndarray:
    """Parse a FEN board string to an ``int8[N, N]`` array.

    Mirrors ``BitfieldBoardState::from_fen`` (``game/board/state.rs:225-250``):
    the side length is inferred from the first rank; ragged ranks raise.
    Multi-digit empty runs (e.g. ``11``) are supported.
    """
    rows = []
    side_len = 0
    for r, line in enumerate(fen.split("/")):
        cells = []
        n_empty = 0
        for ch in line:
            if ch.isdigit():
                n_empty = n_empty * 10 + int(ch)
            else:
                cells.extend([EMPTY] * n_empty)
                n_empty = 0
                if ch not in _CHAR_TO_CELL:
                    raise ParseError(f"bad piece char {ch!r}")
                cells.append(_CHAR_TO_CELL[ch])
        cells.extend([EMPTY] * n_empty)
        if side_len == 0:
            side_len = len(cells)
        elif len(cells) != side_len:
            raise ParseError(f"bad line length {len(cells)} (expected {side_len})")
        rows.append(cells)
    board = np.zeros((side_len, side_len), dtype=np.int8)
    for r, cells in enumerate(rows):
        if r >= side_len:
            raise ParseError(f"too many ranks ({len(rows)}) for side length {side_len}")
        board[r, : len(cells)] = cells
    return board


def board_to_fen(board: np.ndarray) -> str:
    """Inverse of :func:`board_from_fen` (``game/board/state.rs:271-295``)."""
    board = np.asarray(board)
    n = board.shape[0]
    ranks = []
    for r in range(n):
        s = ""
        n_empty = 0
        for c in range(n):
            ch = _CELL_TO_CHAR[int(board[r, c])]
            if ch is None:
                n_empty += 1
            else:
                if n_empty:
                    s += str(n_empty)
                    n_empty = 0
                s += ch
        if n_empty:
            s += str(n_empty)
        ranks.append(s)
    return "/".join(ranks)


def board_from_display_str(s: str) -> np.ndarray:
    """Parse the printable board format (``game/board/state.rs:252-269``)."""
    lines = s.strip().splitlines()
    side_len = len(lines[0])
    board = np.zeros((side_len, side_len), dtype=np.int8)
    for r, line in enumerate(lines):
        if len(line) != side_len:
            raise ParseError(f"bad line length {len(line)}")
        for c, ch in enumerate(line):
            if ch != ".":
                if ch not in _CHAR_TO_CELL:
                    raise ParseError(f"bad piece char {ch!r}")
                board[r, c] = _CHAR_TO_CELL[ch]
    return board


def board_to_display_str(board: np.ndarray) -> str:
    """Printable board (``game/board/state.rs:297-311``)."""
    board = np.asarray(board)
    n = board.shape[0]
    return "\n".join(
        "".join(_CELL_TO_CHAR[int(board[r, c])] or "." for c in range(n)) for r in range(n)
    ) + "\n"


def tile_from_str(s: str) -> Tuple[int, int]:
    """Parse ``a8``-style notation to ``(row, col)`` (``game/tiles.rs:143-157``)."""
    if not s:
        raise ParseError("empty tile string")
    col_byte = ord(s[0])
    if not (97 <= col_byte <= 122):
        raise ParseError(f"bad column char {s[0]!r}")
    try:
        row = int(s[1:]) - 1
    except ValueError as e:
        raise ParseError(f"bad row int in {s!r}") from e
    if row < 0:
        raise ParseError(f"bad row in {s!r}")
    return row, col_byte - 97


def tile_to_str(row: int, col: int) -> str:
    """Format ``(row, col)`` as ``a8`` notation (``game/tiles.rs:137-141``)."""
    return f"{chr(col + 97)}{row + 1}"


def play_from_str(s: str) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Parse ``a8-a11`` to ``((from_row, from_col), (to_row, to_col))``.

    Mirrors ``Play::from_str`` (``game/play.rs:70-86``), including the
    requirement that the tiles share a row or column.
    """
    tokens = s.split("-")
    if len(tokens) != 2:
        raise ParseError(f"bad play string {s!r}")
    src = tile_from_str(tokens[0])
    dst = tile_from_str(tokens[1])
    if src[0] != dst[0] and src[1] != dst[1]:
        raise ParseError(f"disjoint tiles in {s!r}")
    return src, dst


def play_to_str(src: Tuple[int, int], dst: Tuple[int, int]) -> str:
    return f"{tile_to_str(*src)}-{tile_to_str(*dst)}"
