"""The CUDA kernels' sources, run on the CPU, against their plain versions.

``csrc/sim/simt_host.h`` stands in for the few CUDA features the kernels use
(warp shuffles and votes, block barriers, shared memory), so the same
``csrc/*.cu`` files compile with g++ and run on CPU buffers, one fiber per
GPU thread. That checks the kernels' logic where there is no card: the
legal mask and the step bit for bit (tolerance 0: every output is an integer
or a bool), the GroupNorm epilogue within 1 bf16 ulp of exact math rounded
once (its float32 sums run in another order). What nvcc makes of the
sources, and their speed, only ``chip_smoke.py`` on a GPU can say.
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
from alphazeroforhnefatafl_tpu_torch.ops.group_norm import (
    GROUPS, bf16_ulp, exact_group_norm, group_norm_act_plain, group_norm_ulps, ordinal,
)
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


# The GroupNorm epilogue (csrc/group_norm.cu).

GN_EPS = 1e-6
CL = torch.channels_last


def sim_group_norm(lib, x, weight, bias, skip):
    """The kernel on CPU buffers: ``x`` (and ``skip``) bf16 channels-last."""
    R, C, H, W = x.shape
    out = torch.full((R, H, W, C), float("nan"), dtype=torch.bfloat16).permute(0, 3, 1, 2)
    rc = lib.tafl_group_norm_act(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                                 None if skip is None else skip.data_ptr(), R, C, H * W,
                                 GN_EPS, out.data_ptr(), None)
    assert rc == 0
    assert out.is_contiguous(memory_format=CL) and not out.isnan().any()
    return out


def gn_inputs(seed, R, C, H, offset=0.0, std=1.0, with_skip=True):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((offset + std * rng.randn(R, H, H, C)).astype(np.float32))
    x = x.to(torch.bfloat16).permute(0, 3, 1, 2)  # NHWC memory, NCHW shape
    weight = torch.from_numpy((1 + 0.5 * rng.randn(C)).astype(np.float32))
    bias = torch.from_numpy((0.5 * rng.randn(C)).astype(np.float32))
    skip = None
    if with_skip:
        skip = torch.from_numpy(rng.randn(R, H, H, C).astype(np.float32))
        skip = skip.to(torch.bfloat16).permute(0, 3, 1, 2)
    return x, weight, bias, skip


def check_group_norm(lib, x, weight, bias, skip, what, against_chain=True):
    """1 bf16 ulp against exact math rounded once and 2 against PyTorch's
    chain, as ``ops.group_norm.group_norm_ulps`` counts them."""
    got = sim_group_norm(lib, x, weight, bias, skip)
    exact_ulps, chain_ulps = group_norm_ulps(got, x, weight, bias, GN_EPS, skip, against_chain)
    assert exact_ulps <= 1 and chain_ulps <= 2, (what, exact_ulps, chain_ulps)


@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("C", [32, 64, 128])
@pytest.mark.parametrize("R", [1, 3])
def test_sim_group_norm_matches_exact_math(sim, R, C, with_skip):
    """Every served width below 256 on 11x11 (121 positions: the last warp's
    share is short), with and without the skip."""
    x, weight, bias, skip = gn_inputs(R * C, R, C, 11, with_skip=with_skip)
    check_group_norm(sim, x, weight, bias, skip, f"R={R} C={C}")


@pytest.mark.parametrize("C, n", [(256, 11), (64, 19), (32, 7), (128, 15)])
def test_sim_group_norm_other_shapes(sim, C, n):
    """The widest width, and other boards: 19x19 at 64 channels takes 23
    warps, 7x7 at 32 channels two, 15x15 at 128 channels all 32."""
    x, weight, bias, skip = gn_inputs(C + n, 2, C, n)
    check_group_norm(sim, x, weight, bias, skip, f"C={C} {n}x{n}")


def test_sim_group_norm_constant_group(sim):
    """Groups of one repeated value (and of zeros): the variance is 0, eps
    alone sets the scale, and the output is the bias through the ReLU
    (plus the skip)."""
    x, weight, bias, skip = gn_inputs(3, 2, 64, 11)
    x[0, 2:4] = 1.5  # group 1 of row 0
    x[1, 10:12] = 0.0  # group 5 of row 1
    check_group_norm(sim, x, weight, bias, skip, "constant")
    got = sim_group_norm(sim, x, weight, bias, None)
    want = bias.clamp(min=0)[:, None, None].expand(64, 11, 11).to(torch.bfloat16)
    assert torch.equal(got[0, 2:4], want[2:4]) and torch.equal(got[1, 10:12], want[10:12])


@pytest.mark.parametrize("C", [32, 64, 128])
def test_sim_group_norm_large_offset(sim, C):
    """Mean far above the spread (1000 against 2): E[x^2] - E[x]^2 in float32
    would lose the variance; the two-pass variance keeps it within 1 ulp.
    PyTorch's CPU chain, the yardstick of the other cases, is itself tens
    of ulps off here, so it is not compared."""
    x, weight, bias, skip = gn_inputs(C, 3, C, 11, offset=1000.0, std=2.0)
    check_group_norm(sim, x, weight, bias, skip, f"offset C={C}", against_chain=False)
    check_group_norm(sim, x, weight, bias, None, f"offset C={C} bare", against_chain=False)
    chain = group_norm_act_plain(x, GROUPS, weight, bias, GN_EPS)
    ref = exact_group_norm(x, weight, bias, GN_EPS)[0]
    assert (ordinal(chain) - ordinal(ref.float().to(torch.bfloat16))).abs().max() > 2


@pytest.mark.parametrize("value", [2.0 ** -126, 1e-30, 1e-3, 0.3, 1.0, 1.5, 3.14, 255.0, 1000.0,
                                   65504.0, 1e30, 3e38])
def test_ulp_counting(value):
    """The yardstick of the GroupNorm checks: a bf16 value and its neighbour
    away from 0 lie 1 apart in :func:`ordinal`, on both sides of 0, and
    :func:`bf16_ulp` is their spacing; +0 and -0 are the same point."""
    for sign in (1, -1):
        v = torch.tensor([sign * value]).to(torch.bfloat16)
        out = (v.view(torch.int16) + 1).view(torch.bfloat16)  # one step in magnitude
        assert int(ordinal(out) - ordinal(v)) == sign
        assert float(bf16_ulp(v.abs())) == float((out.double() - v.double()).abs())
    zeros = torch.tensor([0.0, -0.0]).to(torch.bfloat16)
    assert ordinal(zeros).tolist() == [0, 0]
