"""The CUDA kernels' sources, run on the CPU, against their plain versions.

``csrc/sim/simt_host.h`` stands in for the few CUDA features the kernels use
(warp shuffles and votes, block barriers, shared memory), so the same
``csrc/*.cu`` files compile with g++ and run on CPU buffers, one fiber per
GPU thread. That checks the kernels' logic bit for bit (tolerance 0: every
output is an integer or a bool) where there is no card; what nvcc makes of
the sources, and their speed, only ``chip_smoke.py`` on a GPU can say.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from alphazeroforhnefatafl_tpu_torch.core import env as tenv
from alphazeroforhnefatafl_tpu_torch.core.rules import PRESETS
from alphazeroforhnefatafl_tpu_torch.ops import _build, step_kernel
from alphazeroforhnefatafl_tpu_torch.ops.legal_mask import legal_mask_plain
from alphazeroforhnefatafl_tpu_torch.ops.step_kernel import SCALAR_ROWS, step_plain
from test_torch_cases import constructed_cases


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """The kernels' library built for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' host simulation")
    out = tmp_path_factory.mktemp("sim") / "libtafl_sim.so"
    cu, _ = _build._sources()
    cmd = [gxx, "-std=c++17", "-O1", "-DTAFL_HOST_SIM", "-shared", "-fPIC",
           "-fsanitize=undefined", "-fno-sanitize-recover=undefined",
           f"-I{_build.CSRC_DIR}", "-x", "c++", *map(str, cu), "-o", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return _build._declare(ctypes.CDLL(str(out)))


def sim_mask(lib, env, boards, sides):
    tab = torch.as_tensor(step_kernel._bit_planes(env).view(np.int32))
    params = step_kernel.params_struct(env)
    B = boards.shape[0]
    out = torch.full((B, env.num_actions), 7, dtype=torch.uint8)
    rc = lib.tafl_legal_mask(boards.data_ptr(), sides.data_ptr(), tab.data_ptr(),
                             ctypes.addressof(params), B, out.data_ptr(), None)
    assert rc == 0
    return out


def sim_step(lib, env, s, actions, offset=0):
    """The step kernel on CPU buffers; the mask lands ``offset`` bytes into
    its allocation, to reach the store's unaligned head and tail."""
    tab = torch.as_tensor(step_kernel._bit_planes(env).view(np.int32))
    params = step_kernel.params_struct(env)
    B, n = s.board.shape[0], env.n
    board3 = torch.full((B, n, n), 7, dtype=torch.int8)
    cap = torch.full((B, n, n), 7, dtype=torch.uint8)
    mask_buf = torch.full((B * env.num_actions + offset + 16,), 7, dtype=torch.uint8)
    mask = mask_buf[offset: offset + B * env.num_actions]
    scal = torch.full((B, len(SCALAR_ROWS)), 7, dtype=torch.int32)
    rc = lib.tafl_step(
        s.board.data_ptr(), s.side_to_play.data_ptr(), actions.data_ptr(),
        s.recent_plays.data_ptr(), s.rep_first_i.data_ptr(), s.reps.data_ptr(),
        s.mid_pair.data_ptr(), s.plays_since_capture.data_ptr(), tab.data_ptr(),
        ctypes.addressof(params), B, board3.data_ptr(), cap.data_ptr(),
        mask.data_ptr(), scal.data_ptr(), None,
    )
    assert rc == 0
    # Nothing outside the mask's span was written.
    assert (mask_buf[:offset] == 7).all() and (mask_buf[offset + B * env.num_actions:] == 7).all()
    return board3, cap, mask.reshape(B, env.num_actions), scal


def check(lib, env, s, actions, what, offset=0):
    want_mask = legal_mask_plain(env, s.board, s.side_to_play)
    got_mask = sim_mask(lib, env, s.board, s.side_to_play)
    assert torch.equal(got_mask, want_mask.to(torch.uint8)), f"{what}: legal mask"
    args = (env, s.board, s.side_to_play, actions, s.recent_plays, s.rep_first_i,
            s.reps, s.mid_pair, s.plays_since_capture)
    want = step_plain(*args)
    got = sim_step(lib, env, s, actions, offset)
    for name, g, w in zip(("board3", "cap", "next_mask", "scal"), got, want):
        if not torch.equal(g.long(), w.long()):
            bad = (g.long() != w.long()).flatten(1).any(1).nonzero()[:, 0].tolist()
            detail = ""
            if name == "scal":
                b = bad[0]
                detail = str({SCALAR_ROWS[i]: (int(g[b, i]), int(w[b, i]))
                              for i in range(len(SCALAR_ROWS)) if g[b, i] != w[b, i]})
            raise AssertionError(f"{what}: {name} differs in games {bad[:8]} {detail}")


def random_actions(rng, mask):
    """One random legal action per game (action 0 where there is none)."""
    acts = np.zeros(mask.shape[0], np.int32)
    for b, row in enumerate(mask.numpy()):
        legal = np.nonzero(row)[0]
        if len(legal):
            acts[b] = rng.choice(legal)
    return torch.from_numpy(acts)


def dense_states(rng, env, B, side, density=(0.15, 0.45), kings=1):
    n = env.n
    boards = np.zeros((B, n, n), np.int8)
    for b in range(B):
        cells = rng.rand(n, n) < rng.uniform(*density)
        att = rng.rand(n, n) < 0.5
        boards[b][cells & att] = 1
        boards[b][cells & ~att] = 2
        for r, c in [(0, 0), (0, n - 1), (n - 1, 0), (n - 1, n - 1), (n // 2, n // 2)]:
            boards[b, r, c] = 0
        for _ in range(kings):
            empties = np.argwhere(boards[b] == 0)
            boards[b][tuple(empties[rng.randint(len(empties))])] = 3
    s = env.reset_batch(B)
    return s.replace(
        board=torch.from_numpy(boards),
        side_to_play=torch.full((B,), side, dtype=torch.int32),
        recent_plays=torch.from_numpy(rng.randint(-1, 40, size=(B, 4)).astype(np.int32)),
        rep_first_i=torch.from_numpy(rng.randint(0, 4, size=B).astype(np.int32)),
        reps=torch.from_numpy(rng.randint(0, 3, size=(B, 2)).astype(np.int32)),
        mid_pair=torch.from_numpy(rng.rand(B, 2) < 0.5),
        plays_since_capture=torch.from_numpy(rng.randint(0, 9, size=B).astype(np.int32)),
    )


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_sim_playout_matches_plain(sim, preset):
    """Random legal playouts with auto-reset; B = 5 leaves the last group of
    four ragged."""
    env = tenv.make_env(preset, "cpu")
    rng = np.random.RandomState(11)
    s, fresh = env.reset_batch(5), env.reset_batch(5)
    for ply in range(40):
        actions = random_actions(rng, env.legal_mask_many(s))
        check(sim, env, s, actions, f"{preset} ply {ply}")
        s, _ = env.step_many(s, actions)
        s = tenv.where_state(s.terminated, fresh, s)


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("side", [0, 1])
def test_sim_dense_boards_match_plain(sim, preset, side):
    """Dense random boards (captures, shieldwalls, floods that fail and hold),
    at an odd batch so that the last group is ragged and, with the mask
    displaced by 5 bytes, its span starts and ends off a 16-byte boundary."""
    env = tenv.make_env(preset, "cpu")
    rng = np.random.RandomState(7 + side)
    s = dense_states(rng, env, 27, side)
    for k in range(3):
        actions = random_actions(rng, legal_mask_plain(env, s.board, s.side_to_play))
        check(sim, env, s, actions, f"{preset} dense side {side} #{k}", offset=5)


def constructed_states(rng, env, B):
    boards, sides, actions = constructed_cases(rng, env.n, B)
    s = dense_states(rng, env, B, 0).replace(
        board=torch.from_numpy(boards), side_to_play=torch.from_numpy(sides)
    )
    return s, torch.from_numpy(actions)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_sim_constructed_cases_match_plain(sim, preset):
    """Shieldwalls that close and fail on every edge, enclosures and exit
    forts that hold and leak (test_torch_cases.py)."""
    env = tenv.make_env(preset, "cpu")
    s, actions = constructed_states(np.random.RandomState(5), env, 61)
    check(sim, env, s, actions, f"{preset} constructed", offset=8)


@pytest.mark.parametrize("n", [15, 21])
def test_sim_constructed_cases_on_large_boards_match_plain(sim, n):
    env = tenv.TaflEnv(PRESETS["copenhagen"][0], "/".join([str(n)] * n), device="cpu")
    s, actions = constructed_states(np.random.RandomState(n), env, 12)
    check(sim, env, s, actions, f"{n}x{n} constructed")


@pytest.mark.parametrize("n", [15, 21])
@pytest.mark.parametrize("side", [0, 1])
def test_sim_large_boards_match_plain(sim, n, side):
    env = tenv.TaflEnv(PRESETS["copenhagen"][0], "/".join([str(n)] * n), device="cpu")
    rng = np.random.RandomState(n + side)
    s = dense_states(rng, env, 3, side)
    actions = random_actions(rng, legal_mask_plain(env, s.board, s.side_to_play))
    check(sim, env, s, actions, f"{n}x{n} side {side}")


def test_sim_spans_off_a_16_byte_boundary_match_plain(sim):
    """19x19 is the one board size whose group (three games: what fits the
    staging budget) spans a number of bytes that 16 does not divide, so the
    second CTA's span starts 8 bytes off a boundary with no displacement of
    the output at all; B = 7 gives groups of 3, 3 and 1."""
    n = 19
    env = tenv.TaflEnv(PRESETS["copenhagen"][0], "/".join([str(n)] * n), device="cpu")
    assert (3 * env.num_actions) % 16 == 8
    rng = np.random.RandomState(n)
    for side in (0, 1):
        s = dense_states(rng, env, 7, side)
        actions = random_actions(rng, legal_mask_plain(env, s.board, s.side_to_play))
        check(sim, env, s, actions, f"{n}x{n} side {side}")


@pytest.mark.parametrize("case", ["no_king", "three_kings", "full_of_attackers",
                                  "full_of_defenders", "no_legal_move", "batch_of_one"])
def test_sim_conventions_match_plain(sim, case):
    """The cases the env fixes by convention: kflat = 0 with no king, the
    first king cell when there are several, a side with nothing to move."""
    env = tenv.make_env("copenhagen", "cpu")
    rng = np.random.RandomState(3)
    n = env.n
    for side in (0, 1):
        if case == "no_king":
            s = dense_states(rng, env, 6, side, kings=0)
        elif case == "three_kings":
            s = dense_states(rng, env, 6, side, kings=3)
        elif case in ("full_of_attackers", "full_of_defenders"):
            s = dense_states(rng, env, 3, side)
            s.board[:] = 1 if case == "full_of_attackers" else 2
        elif case == "no_legal_move":
            s = dense_states(rng, env, 4, side)
            # Every piece walled in: a checkerboard of the two sides.
            rr, cc = np.indices((n, n))
            s.board[:] = torch.from_numpy(np.where((rr + cc) % 2 == 0, 1, 2).astype(np.int8))
        else:
            s = dense_states(rng, env, 1, side)
        actions = random_actions(rng, legal_mask_plain(env, s.board, s.side_to_play))
        check(sim, env, s, actions, f"{case} side {side}")
