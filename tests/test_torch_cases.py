"""Constructed positions for checking the env step, and tests that they
reach the branches they are built for.

Random play and random dense boards almost never close a shieldwall, hold an
enclosure or stand an exit fort, so a fault in those branches of a step would
pass a comparison on such inputs alone. The generators here build positions
around one such structure, vary it so that it both holds and fails, place
it under a random symmetry of the board, and name the move that tests it.
They use numpy only. ``test_torch_ops.py`` feeds their boards to the JAX env
and to the port's plain step, ``test_torch_kernel_sim.py`` to the CUDA
sources run on the CPU, and ``chip_smoke.py`` to the kernels on the card.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from alphazeroforhnefatafl_tpu_torch.core.actions import encode_from_tiles

ATT, DEF, KING = 1, 2, 3
Case = Tuple[np.ndarray, int, int]  # board int8[n, n], side to move, action


def _place(rng, n: int, board: np.ndarray, src, dst) -> Tuple[np.ndarray, int]:
    """``board`` and the move ``src -> dst`` under a random symmetry."""
    k = rng.randint(8)

    def cell(r, c):
        if k & 1:
            r = n - 1 - r
        if k & 2:
            c = n - 1 - c
        return (c, r) if k & 4 else (r, c)

    out = np.zeros_like(board)
    for r, c in np.argwhere(board != 0):
        out[cell(r, c)] = board[r, c]
    return out, encode_from_tiles(n, cell(*src), cell(*dst))


def near(n: int, cells, reach: int = 1) -> np.ndarray:
    """``bool[n, n]``: within ``reach`` king steps of any of ``cells``."""
    out = np.zeros((n, n), dtype=bool)
    for r, c in cells:
        out[max(0, r - reach): r + reach + 1, max(0, c - reach): c + reach + 1] = True
    return out


def _sprinkle(rng, board, free: np.ndarray, density: float, codes) -> None:
    pick = free & (board == 0) & (rng.rand(*board.shape) < density)
    board[pick] = rng.choice(codes, size=int(pick.sum()))


def bystander_move(rng, n: int, board, keep_out: np.ndarray, code: int):
    """Puts a piece of ``code`` away from the structure and moves it one
    tile; ``None`` when the board has no room."""
    for _ in range(64):
        r, c = rng.randint(n), rng.randint(n)
        dr, dc = ((-1, 0), (1, 0), (0, -1), (0, 1))[rng.randint(4)]
        r2, c2 = r + dr, c + dc
        if not (0 <= r2 < n and 0 <= c2 < n):
            continue
        if keep_out[r, c] or keep_out[r2, c2] or board[r, c] or board[r2, c2]:
            continue
        board[r, c] = code
        return (r, c), (r2, c2)
    return None


def shieldwall_case(rng, n: int, side: int) -> Case:
    """Runs of enemy pieces on an edge, pinned from the inside, that the
    mover closes by landing beside them; often a run on either side of the
    landing tile, so that the order of the two directions decides which one
    falls. A run's far end is a friendly piece, a corner, or (sometimes)
    nothing, and sometimes a pin is missing or the king stands in the run."""
    mine, foe = (ATT, DEF) if side == 0 else (DEF, ATT)
    board = np.zeros((n, n), dtype=np.int8)
    arrive = rng.randint(1, n - 1)
    sides_built = 0
    for step in (-1, 1):
        room = arrive - 1 if step < 0 else n - 2 - arrive  # tiles short of the corner
        if room < 2 or (sides_built and rng.rand() < 0.4):
            continue
        length = rng.randint(2, min(4, room) + 1)
        run = [arrive + step * k for k in range(1, length + 1)]
        far = arrive + step * (length + 1)
        for c in run:
            board[0, c], board[1, c] = foe, mine
        if side == 0 and rng.rand() < 0.3:
            board[0, run[rng.randint(length)]] = KING
        if rng.rand() < 0.2:
            board[1, run[rng.randint(length)]] = 0
        if far not in (0, n - 1) and rng.rand() < 0.8:
            board[0, far] = mine
        sides_built += 1
    start = rng.randint(2, n)
    board[start, arrive] = mine
    free = np.ones((n, n), dtype=bool)
    free[:3] = False
    free[:, arrive] = False
    if not (board == KING).any():
        spots = np.argwhere(free & (board == 0))
        board[tuple(spots[rng.randint(len(spots))])] = KING
    _sprinkle(rng, board, free, 0.12, (ATT, DEF))
    board, action = _place(rng, n, board, (start, arrive), (0, arrive))
    return board, side, action


def king_by_throne_case(rng, n: int) -> Case:
    """The king beside the throne with attackers on its other sides, the last
    of them arriving with this move; the throne is empty or holds a
    defender, and sometimes one attacker is missing."""
    t = n // 2
    board = np.zeros((n, n), dtype=np.int8)
    board[t, t + 1] = KING
    if rng.rand() < 0.5:
        board[t, t] = DEF
    around = [(t - 1, t + 1), (t + 1, t + 1), (t, t + 2)]
    last = around.pop(rng.randint(3))
    for cell in around:
        board[cell] = ATT
    if rng.rand() < 0.2:
        board[around[rng.randint(2)]] = 0
    # The last attacker slides in along the free line away from the king.
    dr, dc = last[0] - t, last[1] - (t + 1)
    room = last[0] if dr < 0 else (n - 1 - last[0] if dr > 0 else n - 1 - last[1])
    dist = rng.randint(1, room + 1)
    start = (last[0] + dr * dist, last[1] + dc * dist)
    board[start] = ATT
    line = {(last[0] + dr * k, last[1] + dc * k) for k in range(dist + 1)}
    free = ~near(n, [(t, t + 1)], 1)
    for cell in line:
        free[cell] = False
    _sprinkle(rng, board, free, 0.1, (ATT, DEF))
    board, action = _place(rng, n, board, start, last)
    return board, 0, action


def enclosure_case(rng, n: int) -> Case:
    """The king and some defenders inside a ring of attackers, while an
    attacker moves elsewhere; sometimes the ring has a gap or a defender
    stands outside it."""
    for _ in range(16):
        h, w = rng.randint(1, 4), rng.randint(1, 4)
        if h + 2 > n or w + 2 > n:
            continue
        r0, c0 = rng.randint(1, n - h), rng.randint(1, n - w)
        board = np.zeros((n, n), dtype=np.int8)
        inside = [(r, c) for r in range(r0, r0 + h) for c in range(c0, c0 + w)]
        ring = [(r, c) for r in range(r0 - 1, r0 + h + 1) for c in range(c0 - 1, c0 + w + 1)
                if ((r in (r0 - 1, r0 + h)) != (c in (c0 - 1, c0 + w)))]
        for cell in ring:
            board[cell] = ATT
        for cell in inside:
            if rng.rand() < 0.4:
                board[cell] = DEF
        board[inside[rng.randint(len(inside))]] = KING
        if rng.rand() < 0.25:
            board[ring[rng.randint(len(ring))]] = 0
        keep_out = near(n, ring + inside)
        if rng.rand() < 0.2:
            _sprinkle(rng, board, ~keep_out, 0.05, (DEF,))
        move = bystander_move(rng, n, board, keep_out, ATT)
        if move is None:
            continue
        _sprinkle(rng, board, ~near(n, ring + inside + list(move)), 0.1, (ATT,))
        board, action = _place(rng, n, board, *move)
        return board, 0, action
    raise ValueError(f"no room for an enclosure on a {n}x{n} board")


def exit_fort_case(rng, n: int) -> Case:
    """The king on an edge in a pocket of empty tiles walled by defenders,
    while a defender moves elsewhere; sometimes the wall has a gap, an
    attacker touches the pocket, or a wall piece stands unsupported."""
    for _ in range(16):
        board = np.zeros((n, n), dtype=np.int8)
        king = (0, rng.randint(2, n - 2))
        pocket = [king]
        for _ in range(rng.randint(1, 5)):
            r, c = pocket[rng.randint(len(pocket))]
            dr, dc = ((-1, 0), (1, 0), (0, -1), (0, 1))[rng.randint(4)]
            cell = (r + dr, c + dc)
            if 0 <= cell[0] <= 2 and 1 <= cell[1] <= n - 2 and cell not in pocket:
                pocket.append(cell)
        wall = sorted({(r + dr, c + dc) for r, c in pocket
                       for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1))
                       if 0 <= r + dr < n and 0 <= c + dc < n} - set(pocket))
        board[king] = KING
        for cell in wall:
            board[cell] = DEF
        if rng.rand() < 0.2:
            board[wall[rng.randint(len(wall))]] = 0
        # Support behind the wall decides whether its pieces are secure.
        _sprinkle(rng, board, near(n, wall) & ~near(n, pocket, 0), 0.4, (DEF,))
        if rng.rand() < 0.2:
            _sprinkle(rng, board, near(n, pocket), 0.3, (ATT,))
        keep_out = near(n, pocket + wall, 2)
        move = bystander_move(rng, n, board, keep_out, DEF)
        if move is None:
            continue
        _sprinkle(rng, board, ~near(n, pocket + wall + list(move), 2), 0.1, (ATT,))
        board, action = _place(rng, n, board, *move)
        return board, 1, action
    raise ValueError(f"no room for an exit fort on a {n}x{n} board")


def constructed_cases(rng, n: int, count: int):
    """``count`` cases in turn from the generators above: boards
    ``int8[count, n, n]``, sides ``int32[count]``, actions ``int32[count]``."""
    makers: Tuple[Callable[[], Case], ...] = (
        lambda: shieldwall_case(rng, n, 0),
        lambda: shieldwall_case(rng, n, 1),
        lambda: enclosure_case(rng, n),
        lambda: exit_fort_case(rng, n),
        lambda: king_by_throne_case(rng, n),
    )
    cases = [makers[i % len(makers)]() for i in range(count)]
    return (
        np.stack([c[0] for c in cases]),
        np.array([c[1] for c in cases], dtype=np.int32),
        np.array([c[2] for c in cases], dtype=np.int32),
    )


# ----------------------------------------------------------------------
# The cases reach what they are built for
# ----------------------------------------------------------------------


def _copenhagen_scalars(n: int, count: int, seed: int):
    """The cases through the port's plain step under Copenhagen rules (every
    branch on): sides, and the step's scalars by name."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.core.env import TaflEnv
    from alphazeroforhnefatafl_tpu_torch.core.rules import COPENHAGEN
    from alphazeroforhnefatafl_tpu_torch.ops.step_kernel import SCALAR_INDEX, step_plain

    env = TaflEnv(COPENHAGEN, "/".join([str(n)] * n), device="cpu")
    boards, sides, actions = constructed_cases(np.random.RandomState(seed), n, count)
    s = env.reset_batch(count)
    scal = step_plain(
        env, torch.from_numpy(boards), torch.from_numpy(sides), torch.from_numpy(actions),
        s.recent_plays, s.rep_first_i, s.reps, s.mid_pair, s.plays_since_capture,
    )[3].numpy()
    return sides, {name: scal[:, i] for name, i in SCALAR_INDEX.items()}


def test_cases_move_a_piece_of_the_side_to_move():
    for n in (7, 9, 11, 15):
        sides, got = _copenhagen_scalars(n, 100, n)
        assert (np.where(got["moving"] == ATT, 0, 1) == sides).all()
        assert (got["moving"] != 0).all()


def test_cases_close_and_fail_shieldwalls_for_both_sides():
    sides, got = _copenhagen_scalars(11, 200, 0)
    for side in (0, 1):
        walls = got["n_captures"][side::5][:40]
        assert (walls >= 2).any() and (walls == 0).any()


def test_cases_hold_and_leak_enclosures_and_exit_forts():
    _, got = _copenhagen_scalars(11, 200, 1)
    assert set(got["o_enclosed"][2::5]) == {0, 1}
    assert set(got["o_exit_fort"][3::5]) == {0, 1}
    assert (got["reason"][2::5] == 4).any() and (got["reason"][3::5] == 1).any()


def test_cases_capture_and_spare_the_king_by_the_throne():
    _, got = _copenhagen_scalars(11, 200, 2)
    assert set(got["king_captured"][4::5]) == {0, 1}
