"""What of the CUDA kernels' surroundings can be checked without a card: the
table layout and rule struct shared with csrc/tafl_common.cuh, the build's
error path, and the wrappers' device dispatch."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from alphazeroforhnefatafl_tpu_torch.core.env import make_env
from alphazeroforhnefatafl_tpu_torch.ops import _build, legal_mask, step_kernel
from tests.test_torch_learner import single_thread  # noqa: F401 (autouse fixture)

HEADER = Path(_build.CSRC_DIR, "tafl_common.cuh").read_text()


def _define(name):
    m = re.search(rf"#define {name}(\(\w+\))?\s+\(?([^\n]+)", HEADER)
    assert m, name
    return m.group(2).split("//")[0].strip()


def test_table_columns_match_the_header():
    assert int(_define("TAFL_NUM_PLANES")) == step_kernel.NUM_PLANES
    for name in ("CORNER_ROW", "EDGE_ROW"):
        assert int(_define(f"TAFL_PL_{name}")) == getattr(step_kernel, f"PL_{name}")
    for name in ("OCC_ROW", "PASS_ROW", "OCC_COL", "PASS_COL", "HOSTILE_ROW"):
        assert _define(f"TAFL_PL_{name}").startswith(f"{getattr(step_kernel, f'PL_{name}')} +")
    assert int(_define("TAFL_NUM_SCALARS")) == len(step_kernel.SCALAR_ROWS)


def test_params_struct_matches_the_header():
    body = re.search(r"struct TaflParams \{(.*?)\};", HEADER, re.S).group(1)
    fields = re.findall(r"int (\w+)(?:\[(\d)\])?;", body)
    want = [(name, int(k) if k else 1) for name, k in fields]
    got = [
        (name, getattr(ctype, "_length_", 1)) for name, ctype in step_kernel.TaflParams._fields_
    ]
    assert got == want


@pytest.mark.parametrize("preset", ["copenhagen", "tablut", "magpie"])
def test_params_and_tables_follow_the_rules(preset):
    env = make_env(preset, "cpu")
    table, st = step_kernel._static_tables(env)
    p = step_kernel.params_struct(env)
    n = env.n
    assert table.shape == (n * n, step_kernel.NUM_COLS)
    assert p.n == n and p.thr_r * n + p.thr_c == st["thr_flat"]
    assert p.rep_n == (3 if preset != "magpie" else 0)
    # Magpie's king is slow (one tile a move); no other preset has a slow piece.
    assert p.slow_bits == (0b100 if preset == "magpie" else 0)
    assert p.edge_hostile_bits == sum(int(h) << c for c, h in enumerate(st["edge_hostile"]))
    assert p.sw_caps_bits == sum(int(h) << c for c, h in enumerate(st["sw_caps"]))
    # The bit planes say what the plain version's per-cell table says.
    tab = step_kernel._bit_planes(env)
    assert tab.shape == (step_kernel.NUM_PLANES, 32) and tab.dtype == np.uint32

    def unpack(plane):
        return ((tab[plane, :n, None] >> np.arange(n)[None, :]) & 1).astype(bool)

    mt = legal_mask._move_tables(env)
    for c in range(3):
        i = mt.cls_of_code[c + 1]
        occ = table[:, 2 * i].reshape(n, n) != 0
        pas = table[:, 2 * i + 1].reshape(n, n) != 0
        assert np.array_equal(unpack(step_kernel.PL_OCC_ROW + c), occ)
        assert np.array_equal(unpack(step_kernel.PL_PASS_ROW + c), pas)
        assert np.array_equal(unpack(step_kernel.PL_OCC_COL + c), occ.T)
        assert np.array_equal(unpack(step_kernel.PL_PASS_COL + c), pas.T)
        assert np.array_equal(table[:, step_kernel.COL_CLS_OCC + c].reshape(n, n) != 0, occ)
        hostile = table[:, step_kernel.COL_SPECIAL_HOSTILE + c].reshape(n, n) != 0
        assert np.array_equal(unpack(step_kernel.PL_HOSTILE_ROW + c), hostile)
    assert np.array_equal(unpack(step_kernel.PL_CORNER_ROW), env.corner_mask)
    assert np.array_equal(unpack(step_kernel.PL_EDGE_ROW), env.edge_mask)
    assert (tab[:, n:] == 0).all() and (tab >> n == 0).all()
    cc = table[:, step_kernel.COL_CC].reshape(n, n) != 0
    assert np.array_equal(cc, env.corner_mask & bool(p.sw_corners_close))


def test_build_reports_nvcc_errors(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fake nvcc refused the sources' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    with pytest.raises(_build.KernelBuildError, match="fake nvcc refused"):
        _build.build()
    assert not any((tmp_path / "build").glob("*.so"))


def test_wrappers_take_the_plain_path_only_on_cpu():
    env = make_env("brandubh", "cpu")
    s = env.reset_batch(2)
    before = (legal_mask.batched_legal_mask.launches, step_kernel.step_arrays.launches)
    env.step_many(s, torch.zeros(2, dtype=torch.int32))
    assert (legal_mask.batched_legal_mask.launches, step_kernel.step_arrays.launches) == before
    meta = s.board.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        legal_mask.batched_legal_mask(env, meta, s.side_to_play.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        step_kernel.step_arrays(env, meta, *[torch.empty(0, device="meta")] * 7)


# ----------------------------------------------------------------------
# Conventions a kernel must keep: the plain version against the JAX package
# ----------------------------------------------------------------------
#
# Copenhagen rules (shieldwalls, surround win and exit fort all on) on a 7x7
# board, batches of 8, so that the JAX functions compile once. The JAX side
# runs its reference path, ``vmap(env.step)``, and its Pallas step kernel in
# interpret mode, as the JAX package's own tests do on the CPU. Every output
# is an integer or a bool: tolerance 0.

N7 = 7
EMPTY_7X7 = "/".join(["7"] * 7)


def _jax_env_7x7():
    from alphazeroforhnefatafl_tpu.core import env as jenv
    from alphazeroforhnefatafl_tpu.core.rules import COPENHAGEN

    return jenv.TaflEnv(COPENHAGEN, EMPTY_7X7)


def _jax_state(env, boards, sides):
    import jax.numpy as jnp

    return env.reset_batch(boards.shape[0]).replace(
        board=jnp.asarray(boards, jnp.int8), side_to_play=jnp.asarray(sides, jnp.int32)
    )


def _jax_reference_step(env, boards, sides, actions):
    """The JAX env's reference path: ``vmap(step)`` and the array phase
    ``vmap(_apply_play)`` it is built on."""
    import jax
    import jax.numpy as jnp

    state, acts = _jax_state(env, boards, sides), jnp.asarray(actions, jnp.int32)
    new_state, info = jax.vmap(lambda s, a: env.step(s, a, validate=False))(state, acts)
    ap = jax.vmap(lambda s, a: env._apply_play(s, a, validate=False))(state, acts)
    return new_state, info, ap


def _jax_kernel_step(env, boards, sides, actions):
    """The JAX package's Pallas step kernel, in interpret mode."""
    import jax.numpy as jnp

    from alphazeroforhnefatafl_tpu.ops.step_kernel import step_arrays as jax_step_arrays

    s = _jax_state(env, boards, sides)
    return jax_step_arrays(
        env, s.board, s.side_to_play, jnp.asarray(actions, jnp.int32),
        s.recent_plays, s.rep_first_i, s.reps, s.mid_pair, s.plays_since_capture,
        interpret=True,
    )


def _torch_env_7x7():
    from alphazeroforhnefatafl_tpu_torch.core.env import TaflEnv
    from alphazeroforhnefatafl_tpu_torch.core.rules import COPENHAGEN

    return TaflEnv(COPENHAGEN, EMPTY_7X7, device="cpu")


def _assert_plain_matches_jax(boards, sides, actions, kernel=True, envs=None):
    """``step_plain`` on the boards against the JAX env's reference path
    and, with ``kernel``, against the JAX Pallas kernel too (the only place
    where the raw ``o_enclosed`` and ``o_exit_fort`` show); returns the plain
    version's scalars by name. ``envs`` is the pair (JAX env, port's env) of
    one ruleset and board size; by default Copenhagen rules on 7x7, where
    the batch is 8 so that the JAX functions compile once."""
    if envs is None:
        envs = _jax_env_7x7(), _torch_env_7x7()
        assert boards.shape == (8, N7, N7)
    jax_env, env = envs
    n = env.n
    s = env.reset_batch(boards.shape[0])
    board3, cap, next_mask, scal = step_kernel.step_plain(
        env, torch.from_numpy(boards), torch.from_numpy(sides), torch.from_numpy(actions),
        s.recent_plays, s.rep_first_i, s.reps, s.mid_pair, s.plays_since_capture,
    )
    got = {name: scal[:, i].numpy() for name, i in step_kernel.SCALAR_INDEX.items()}

    def same(name, want):
        assert np.array_equal(np.asarray(want).astype(np.int32), got[name]), name

    # The reference path. The env freezes invalid games, the raw step does
    # not, so boards and outcomes are compared where the step is valid.
    new_state, info, ap = _jax_reference_step(jax_env, boards, sides, actions)
    for name, key in (("valid", "valid"), ("moving", "moving_cell"), ("trc", "trc"), ("tcc", "tcc"),
                      ("king_captured", "king_captured")):
        same(name, ap[key])
    same("kflat", np.asarray(ap["king_r"]) * n + np.asarray(ap["king_c"]))
    assert np.array_equal(np.asarray(ap["board3"]), board3.numpy())
    assert np.array_equal(np.asarray(ap["cap"]), cap.numpy())
    ok = got["valid"] != 0
    assert np.array_equal(np.asarray(info.invalid), ~ok)
    for name, want in (("result", info.result), ("reason", info.reason),
                       ("terminated", info.terminated), ("n_captures", info.n_captures)):
        assert np.array_equal(np.asarray(want).astype(np.int32)[ok], got[name][ok]), name
    live = ok & (got["terminated"] == 0)
    assert np.array_equal(np.asarray(info.legal_mask)[live], next_mask.numpy()[live])
    assert np.array_equal(np.asarray(new_state.board)[ok], board3.numpy()[ok])

    if kernel:
        kp = _jax_kernel_step(jax_env, boards, sides, actions)
        fin = kp["fin"]
        assert np.array_equal(np.asarray(kp["board3"]), board3.numpy())
        assert np.array_equal(np.asarray(kp["cap"]), cap.numpy())
        assert np.array_equal(np.asarray(kp["next_mask"]), next_mask.numpy())
        for name, want in (("o_enclosed", kp["o_enclosed"]), ("o_exit_fort", kp["o_exit_fort"]),
                           ("result", fin["result"]), ("reason", fin["reason"]),
                           ("terminated", fin["terminated"]), ("n_captures", fin["n_captures"]),
                           ("kflat", np.asarray(kp["king_r"]) * n + np.asarray(kp["king_c"]))):
            same(name, want)
    # The legal-mask function itself, on the post-capture boards.
    again = legal_mask.legal_mask_plain(env, board3, (1 - torch.from_numpy(sides)).to(torch.int32))
    assert torch.equal(again, next_mask)
    return got


def _bystander(rng, board, code):
    """Adds a piece of ``code`` on a free tile and returns its one-tile move."""
    from alphazeroforhnefatafl_tpu_torch.core.actions import encode_from_tiles
    from test_torch_cases import bystander_move, near

    taken = [tuple(c) for c in np.argwhere(board != 0)]
    move = bystander_move(rng, N7, board, near(N7, taken), code)
    assert move is not None
    return encode_from_tiles(N7, *move)


def _batch(make):
    rng = np.random.RandomState(17)
    cases = [make(rng, i) for i in range(8)]
    return (np.stack([c[0] for c in cases]).astype(np.int8),
            np.array([c[1] for c in cases], np.int32), np.array([c[2] for c in cases], np.int32))


def _fort(rng, i):
    """King at the top edge in a pocket walled by defenders; its exit fort
    stands in the even cases and has a gap in the odd ones."""
    board = np.zeros((N7, N7), np.int8)
    board[0, 3] = 3
    for cell in [(0, 1), (1, 2), (1, 3), (0, 4)]:
        board[cell] = 2
    if i % 2:
        board[1, 2] = 0
    board[5, 5] = 1  # an attacker far away, so that not all are captured
    return board


def test_empty_flood_seed_when_the_attacker_moves():
    """The attacker moved, so the exit-fort flood has no seed: its verdict is
    'king on an edge with a free neighbour', fort or no fort."""
    def make(rng, i):
        board = _fort(rng, i)
        return board, 0, _bystander(rng, board, 1)

    got = _assert_plain_matches_jax(*_batch(make))
    assert got["o_exit_fort"].all() and not got["terminated"].any()


def test_empty_flood_seed_when_the_defender_moves():
    """The defender moved, so the surround flood has no seed and
    ``o_enclosed`` is false while defenders remain; the fort decides."""
    def make(rng, i):
        board = _fort(rng, i)
        return board, 1, _bystander(rng, board, 2)

    got = _assert_plain_matches_jax(*_batch(make))
    assert not got["o_enclosed"].any()
    assert got["o_exit_fort"].tolist() == [1, 0] * 4
    assert got["reason"].tolist() == [1, -1] * 4


def test_no_defenders_left():
    """``n_def3 == 0``: the last defender, or a lone king, falls to this
    move, or there never was one. With nothing to enclose, ``o_enclosed``
    turns on 'no corner reached and no insecure attacker' alone."""
    from alphazeroforhnefatafl_tpu_torch.core.actions import encode_from_tiles

    def make(rng, i):
        board = np.zeros((N7, N7), np.int8)
        if i % 4 == 0:  # a lone king taken on all four sides
            board[2, 4] = 3
            for cell in [(1, 4), (3, 4), (2, 5)]:
                board[cell] = 1
            board[2, 1] = 1
            return board, 0, encode_from_tiles(N7, (2, 1), (2, 3))
        if i % 4 == 1:  # the last defender taken between two attackers
            board[4, 4], board[4, 5], board[4, 1] = 2, 1, 1
            return board, 0, encode_from_tiles(N7, (4, 1), (4, 3))
        if i % 4 == 2:  # no defender at all, the defender "moves" nothing
            board[5, 5] = 1
            return board, 1, 0
        board[1, 1] = board[5, 2] = 1  # attackers only, one moves
        return board, 0, encode_from_tiles(N7, (5, 2), (5, 4))

    got = _assert_plain_matches_jax(*_batch(make))
    assert got["kflat"].tolist() == [2 * N7 + 4, 0, 0, 0] * 2
    assert got["king_captured"].tolist() == [1, 0, 0, 0] * 2
    assert got["n_captures"].tolist() == [1, 1, 0, 0] * 2
    assert got["reason"].tolist()[:2] == [3, 3]  # all captured outranks the rest


@pytest.mark.parametrize("kings", [0, 3])
def test_no_king_and_several_kings(kings):
    """``kflat`` is 0 with no king on the board and the first king cell with
    several; everything downstream follows that cell."""
    def make(rng, i):
        board = np.zeros((N7, N7), np.int8)
        cells = rng.rand(N7, N7) < 0.35
        att = rng.rand(N7, N7) < 0.5
        board[cells & att], board[cells & ~att] = 1, 2
        empties = np.argwhere(board == 0)
        for cell in empties[rng.choice(len(empties), kings, replace=False)]:
            board[tuple(cell)] = 3
        side = i % 2
        mask = legal_mask.legal_mask_plain(
            _torch_env_7x7(), torch.from_numpy(board)[None], torch.tensor([side], dtype=torch.int32)
        )[0].numpy()
        return board, side, int(rng.choice(np.nonzero(mask)[0])) if mask.any() else 0

    boards, sides, actions = _batch(make)
    # With several kings the reference path defines the king's cell.
    got = _assert_plain_matches_jax(boards, sides, actions, kernel=kings == 0)
    if kings == 0:
        assert (got["kflat"] == 0).all()
    else:
        assert (got["kflat"] > 0).any()


@pytest.mark.parametrize("edge", ["top", "bottom", "left", "right"])
def test_shieldwall_closed_by_a_corner(edge):
    """Two enemy pieces on the edge between the landing tile and a corner,
    pinned from the inside: the corner closes the wall and both fall. The
    cases vary the mover's side, which corner closes, and a missing pin
    (no capture)."""
    from alphazeroforhnefatafl_tpu_torch.core.actions import encode_from_tiles

    def place(r, c):
        return {"top": (r, c), "bottom": (N7 - 1 - r, c), "left": (c, r),
                "right": (c, N7 - 1 - r)}[edge]

    def make(rng, i):
        side, high_corner, pin_missing = i & 1, bool(i & 2), bool(i & 4)
        mine, foe = (1, 2) if side == 0 else (2, 1)
        cols = (4, 5) if high_corner else (1, 2)
        board = np.zeros((N7, N7), np.int8)
        for c in cols:
            board[place(0, c)], board[place(1, c)] = foe, mine
        if pin_missing:
            board[place(1, cols[0])] = 0
        board[place(3, 3)] = mine
        board[place(6, 0)] = 3 if side == 0 else 1  # far away, so both sides have pieces
        return board, side, encode_from_tiles(N7, place(3, 3), place(0, 3))

    # Against the env's reference path, which the oracle tests hold.
    got = _assert_plain_matches_jax(*_batch(make), kernel=False)
    assert got["n_captures"].tolist() == [2, 2, 2, 2, 0, 0, 0, 0]


def test_a_side_with_no_legal_move():
    """A checkerboard of the two sides: the mover's piece cannot move, the
    step is invalid by its ray but runs, and the next player has no play."""
    def make(rng, i):
        rr, cc = np.indices((N7, N7))
        board = np.where((rr + cc) % 2 == 0, 1, 2).astype(np.int8)
        if i >= 4:
            board[3, 3] = 3
        return board, i % 2, 0

    boards, sides, actions = _batch(make)
    env = _torch_env_7x7()
    mask = legal_mask.legal_mask_plain(env, torch.from_numpy(boards), torch.from_numpy(sides))
    assert not mask.any()
    _assert_plain_matches_jax(boards, sides, actions)


CONSTRUCTED = ["brandubh", "copenhagen", "koch", "magpie", "tablut", "15x15"]


@pytest.mark.parametrize("where", CONSTRUCTED)
def test_constructed_cases_match_the_jax_env(where):
    """Shieldwalls on every edge, enclosures, exit forts and king captures
    beside the throne (test_torch_cases.py), which random boards almost
    never reach: the port's plain step against the JAX env's reference path
    under every preset's rules and under Copenhagen rules on 15x15, and on
    7x7 against the JAX Pallas kernel in interpret mode too."""
    from alphazeroforhnefatafl_tpu.core import env as jenv
    from alphazeroforhnefatafl_tpu.core import rules as jrules
    from alphazeroforhnefatafl_tpu_torch.core import rules as trules
    from alphazeroforhnefatafl_tpu_torch.core.env import TaflEnv
    from test_torch_cases import constructed_cases

    if where == "15x15":
        fen = "/".join(["15"] * 15)
        envs = jenv.TaflEnv(jrules.COPENHAGEN, fen), TaflEnv(trules.COPENHAGEN, fen, device="cpu")
    else:
        envs = (jenv.TaflEnv(*jrules.PRESETS[where]),
                TaflEnv(*trules.PRESETS[where], device="cpu"))
    n = envs[1].n
    boards, sides, actions = constructed_cases(np.random.RandomState(n), n, 200)
    got = _assert_plain_matches_jax(boards, sides, actions, kernel=n == 7, envs=envs)
    # Something happened: captures, and under Copenhagen rules every branch.
    assert (got["n_captures"] > 0).any()
    if where in ("copenhagen", "15x15"):
        assert (got["n_captures"] >= 2).any()
        assert {4, 1} <= set(got["reason"].tolist())
