"""The PyTorch env against the JAX env, bit for bit.

Inputs are made with numpy from a seed and fed to both packages. The JAX
side runs ``vmap(env.step)`` (which the JAX suite holds against its Pallas
kernels); one brandubh case also goes through the Pallas kernels themselves
in interpret mode. The port runs its plain PyTorch versions here: its
wrappers take them for CPU tensors.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazeroforhnefatafl_tpu.core import actions as A
from alphazeroforhnefatafl_tpu.core import env as jenv
from alphazeroforhnefatafl_tpu.core import fen
from alphazeroforhnefatafl_tpu.core.rules import COPENHAGEN, PRESETS, WinReason
from alphazeroforhnefatafl_tpu_torch.core import env as tenv
from alphazeroforhnefatafl_tpu_torch.core import rules as trules
from tests.test_env_golden import random_dense_board
from tests.test_torch_learner import single_thread  # noqa: F401 (autouse fixture)

STATE_FIELDS = [
    "board", "side_to_play", "reps", "mid_pair", "recent_plays", "rep_first_i",
    "plays_since_capture", "turn", "terminated", "result", "reason",
]
INFO_FIELDS = [
    "captures", "n_captures", "terminated", "result", "reason", "reward_mover",
    "legal_mask", "invalid",
]

_JAX_FNS = {}


def jax_fns(env):
    """Jitted batched step, legal mask and observe of a JAX env (cached per
    env value, so each ruleset compiles once per test process)."""
    if env not in _JAX_FNS:
        _JAX_FNS[env] = (
            jax.jit(jax.vmap(lambda s, a: env.step(s, a, validate=False))),
            jax.jit(jax.vmap(env.legal_mask_for_side)),
            jax.jit(jax.vmap(env.observe)),
        )
    return _JAX_FNS[env]


def to_torch(state) -> tenv.EnvState:
    """A batched JAX EnvState as a torch EnvState (same fields and dtypes)."""
    return tenv.EnvState(
        **{f: torch.from_numpy(np.array(getattr(state, f))) for f in STATE_FIELDS}
    )


def to_jax(state: tenv.EnvState):
    return jenv.EnvState(**{f: jnp.asarray(getattr(state, f).numpy()) for f in STATE_FIELDS})


def assert_same(jax_obj, torch_obj, fields, ctx):
    for name in fields:
        a = np.asarray(getattr(jax_obj, name))
        b = getattr(torch_obj, name).numpy()
        assert a.dtype == b.dtype, f"{ctx} {name}: dtype {a.dtype} vs {b.dtype}"
        assert np.array_equal(a, b), f"{ctx} {name}"


def pick_actions(rng, mask: np.ndarray) -> np.ndarray:
    return np.array(
        [int(rng.choice(np.nonzero(m)[0])) if m.any() else 0 for m in mask], np.int32
    )


def step_both(jax_env, torch_env, jstate, actions, ctx):
    """Step both envs from the same state; assert every field agrees."""
    step, _, _ = jax_fns(jax_env)
    js, ji = step(jstate, jnp.asarray(actions))
    ts, ti = torch_env.step_many(to_torch(jstate), torch.from_numpy(actions))
    assert_same(js, ts, STATE_FIELDS, ctx + " state")
    assert_same(ji, ti, INFO_FIELDS, ctx + " info")
    return js, ji


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_random_playouts_match_jax(preset):
    jax_env, torch_env = jenv.make_env(preset), tenv.make_env(preset, "cpu")
    _, jmask, _ = jax_fns(jax_env)
    B, steps = 4, 24
    rng = np.random.RandomState(sum(map(ord, preset)))
    state = jax_env.reset_batch(B)
    fresh = jax_env.reset_batch(B)
    mask = np.asarray(jmask(state.board, state.side_to_play))
    got = torch_env.legal_mask_many(to_torch(state)).numpy()
    assert np.array_equal(mask, got)
    for t in range(steps):
        state, info = step_both(jax_env, torch_env, state, pick_actions(rng, mask), f"{preset} step {t}")
        mask = np.asarray(info.legal_mask)
        done = np.asarray(state.terminated)
        if done.any():
            d = jnp.asarray(done)
            state = jax.tree_util.tree_map(
                lambda f, c: jnp.where(d.reshape((-1,) + (1,) * (c.ndim - 1)), f, c), fresh, state
            )
            mask = np.asarray(jmask(state.board, state.side_to_play))


def _states_from_boards(jax_env, boards: np.ndarray, side: int):
    B = boards.shape[0]
    return jax_env.reset_batch(B).replace(
        board=jnp.asarray(boards, jnp.int8),
        side_to_play=jnp.full((B,), side, jnp.int32),
    )


@pytest.mark.parametrize("preset", ["copenhagen", "tablut", "brandubh"])
def test_dense_boards_match_jax(preset):
    """Dense random boards fire captures, shieldwalls and floods far more
    often than playouts from the start."""
    jax_env, torch_env = jenv.make_env(preset), tenv.make_env(preset, "cpu")
    _, jmask, _ = jax_fns(jax_env)
    n = jax_env.n
    rng = np.random.RandomState(11 + n)
    B = 4  # the playout test's batch, so the jitted JAX functions are reused
    for round_i in range(6):
        boards = np.stack([random_dense_board(rng, n) for _ in range(B)])
        for side in (0, 1):
            state = _states_from_boards(jax_env, boards, side)
            mask = np.asarray(jmask(state.board, state.side_to_play))
            tstate = to_torch(state)
            assert np.array_equal(mask, torch_env.legal_mask_many(tstate).numpy())
            step_both(jax_env, torch_env, state, pick_actions(rng, mask), f"{preset} round {round_i} side {side}")


@pytest.mark.parametrize("n", [15, 21])
def test_large_boards_match_jax(n):
    """Copenhagen rules on 15x15 and 21x21 boards."""
    rng = np.random.RandomState(n)
    boards = []
    for _ in range(4):
        board = np.zeros((n, n), np.int8)
        cells = rng.rand(n, n) < 0.3
        sides = rng.rand(n, n) < 0.5
        board[cells & sides] = 1
        board[cells & ~sides] = 2
        for r, c in [(0, 0), (0, n - 1), (n - 1, 0), (n - 1, n - 1), (n // 2, n // 2)]:
            board[r, c] = 0
        empties = np.argwhere(board == 0)
        board[tuple(empties[rng.randint(len(empties))])] = 3
        boards.append(board)
    boards = np.stack(boards)
    start = fen.board_to_fen(boards[0])
    jax_env = jenv.TaflEnv(COPENHAGEN, start)
    torch_env = tenv.TaflEnv(trules.COPENHAGEN, start, device="cpu")
    _, jmask, _ = jax_fns(jax_env)
    for side in (0, 1):
        state = _states_from_boards(jax_env, boards, side)
        mask = np.asarray(jmask(state.board, state.side_to_play))
        assert np.array_equal(mask, torch_env.legal_mask_many(to_torch(state)).numpy())
        for k in range(2):
            step_both(jax_env, torch_env, state, pick_actions(rng, mask), f"{n}x{n} side {side} #{k}")


def _shuttle(torch_env):
    """A line of reversible one-tile moves for both sides, repeated until the
    repetition rule ends the game: [a, d, a^-1, d^-1] * 3 + [a]."""
    n = torch_env.n
    start = torch_env.reset()
    mask = torch_env.legal_mask_many(start)[0].numpy()

    def reverse(action):
        src, dst = A.decode_to_tiles(n, action)
        return A.encode_from_tiles(n, dst, src)

    for att in np.nonzero(mask)[0]:
        s1, i1 = torch_env.step_many(start, torch.tensor([att]))
        if int(i1.n_captures[0]):
            continue
        for dfd in np.nonzero(i1.legal_mask[0].numpy())[0][::7]:
            line = [int(att), int(dfd), reverse(att), reverse(dfd)] * 3 + [int(att)]
            s = start
            for k, a in enumerate(line):
                s, info = torch_env.step_many(s, torch.tensor([a]))
                if bool(info.invalid[0]) or int(info.n_captures[0]) or (
                    bool(s.terminated[0]) and k < len(line) - 1
                ):
                    break
            else:
                if bool(s.terminated[0]):
                    return line
    raise AssertionError("no shuttle line found")


@pytest.mark.parametrize(
    "preset, result, reason",
    [
        ("copenhagen", jenv.WIN_DEFENDER, int(WinReason.REPETITION)),
        ("tablut", jenv.DRAW, jenv.R_DRAW_REPETITION),
    ],
)
def test_repetition_line_matches_jax(preset, result, reason):
    """Copenhagen's repetition rule is a loss for the repeating side (the
    attacker moved first and repeats first); tablut's is a draw."""
    jax_env, torch_env = jenv.make_env(preset), tenv.make_env(preset, "cpu")
    line = _shuttle(torch_env)
    state = jax_env.reset_batch(4)  # the playout test's batch: no recompile
    for k, a in enumerate(line):
        state, _ = step_both(jax_env, torch_env, state, np.full(4, a, np.int32), f"{preset} ply {k}")
    assert np.asarray(state.terminated).all()
    assert (np.asarray(state.result) == result).all()
    assert (np.asarray(state.reason) == reason).all()


def test_observe_matches_jax():
    jax_env, torch_env = jenv.make_env("copenhagen"), tenv.make_env("copenhagen", "cpu")
    _, _, jobs = jax_fns(jax_env)
    rng = np.random.RandomState(3)
    boards = np.stack([random_dense_board(rng, jax_env.n) for _ in range(4)])
    state = _states_from_boards(jax_env, boards, 1).replace(
        reps=jnp.asarray(rng.randint(0, 3, size=(4, 2)), jnp.int32),
        side_to_play=jnp.asarray(rng.randint(0, 2, size=4), jnp.int32),
    )
    want = np.asarray(jobs(state))
    got = torch_env.observe(to_torch(state))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(want, got.numpy())
    # A JAX-style caller reads the plane count off the env.
    assert torch_env.num_observation_planes == jax_env.num_observation_planes == got.shape[-1]


def test_matches_pallas_kernels_in_interpret_mode():
    """Brandubh dense boards through the Pallas kernels themselves
    (interpret mode): the port's step and mask outputs, including the raw
    scalar rows of ``step_arrays``, equal the TPU kernels'."""
    from alphazeroforhnefatafl_tpu.ops.legal_mask import batched_legal_mask as jax_mask
    from alphazeroforhnefatafl_tpu.ops.step_kernel import step_arrays as jax_step_arrays
    from alphazeroforhnefatafl_tpu_torch.ops.legal_mask import batched_legal_mask
    from alphazeroforhnefatafl_tpu_torch.ops.step_kernel import SCALAR_INDEX, step_arrays

    jax_env, torch_env = jenv.make_env("brandubh"), tenv.make_env("brandubh", "cpu")
    rng = np.random.RandomState(5)
    B = 8
    boards = np.stack([random_dense_board(rng, jax_env.n) for _ in range(B)])
    sides = rng.randint(0, 2, size=B).astype(np.int32)
    state = _states_from_boards(jax_env, boards, 0).replace(side_to_play=jnp.asarray(sides))
    jm = np.asarray(jax_mask(jax_env, state.board, state.side_to_play, interpret=True))
    tm = batched_legal_mask(torch_env, torch.from_numpy(boards), torch.from_numpy(sides))
    assert np.array_equal(jm, tm.numpy())

    acts = pick_actions(rng, jm)
    ts = to_torch(state)
    ap = jax_step_arrays(
        jax_env, state.board, state.side_to_play, jnp.asarray(acts), state.recent_plays,
        state.rep_first_i, state.reps, state.mid_pair, state.plays_since_capture, interpret=True,
    )
    board3, cap, next_mask, scal = step_arrays(
        torch_env, ts.board, ts.side_to_play, torch.from_numpy(acts), ts.recent_plays,
        ts.rep_first_i, ts.reps, ts.mid_pair, ts.plays_since_capture,
    )
    assert np.array_equal(np.asarray(ap["board3"]), board3.numpy())
    assert np.array_equal(np.asarray(ap["cap"]), cap.numpy())
    assert np.array_equal(np.asarray(ap["next_mask"]), next_mask.numpy())
    s = scal.numpy()
    fin = ap["fin"]
    want = {
        "valid": ap["valid"], "moving": ap["moving_cell"], "trc": ap["trc"], "tcc": ap["tcc"],
        "king_captured": ap["king_captured"], "o_enclosed": ap["o_enclosed"],
        "o_exit_fort": ap["o_exit_fort"], "result": fin["result"], "reason": fin["reason"],
        "terminated": fin["terminated"], "rep_first_i": fin["rep_first_i"],
        "plays_since_capture": fin["plays_since_capture"], "n_captures": fin["n_captures"],
    }
    for name, v in want.items():
        assert np.array_equal(np.asarray(v).astype(np.int32), s[:, SCALAR_INDEX[name]]), name
    kflat = np.asarray(ap["king_r"]) * jax_env.n + np.asarray(ap["king_c"])
    assert np.array_equal(kflat, s[:, SCALAR_INDEX["kflat"]])
    i = SCALAR_INDEX
    assert np.array_equal(np.asarray(fin["reps"]), s[:, i["reps_att"]: i["reps_att"] + 2])
    assert np.array_equal(np.asarray(fin["mid_pair"]), s[:, i["mid_att"]: i["mid_att"] + 2] != 0)
    assert np.array_equal(np.asarray(fin["recent_plays"]), s[:, i["ring0"]: i["ring0"] + 4])

    js, ji = jax_env.step_batch(state, jnp.asarray(acts), interpret=True)
    tstate, tinfo = torch_env.step_many(ts, torch.from_numpy(acts))
    assert_same(js, tstate, STATE_FIELDS, "interpret state")
    assert_same(ji, tinfo, INFO_FIELDS, "interpret info")


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tenv.TaflEnv(*trules.PRESETS["brandubh"], device="cuda")


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax and flax unimported."""
    import subprocess

    code = (
        "import importlib, pkgutil, sys\n"
        "import alphazeroforhnefatafl_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in ('jax', 'flax', 'optax') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
