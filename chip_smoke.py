#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``alphazeroforhnefatafl_tpu_torch``) on one
CUDA card.

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build both CUDA kernels from ``alphazeroforhnefatafl_tpu_torch/csrc``;
3. kernel 1 (legal mask) against its plain PyTorch version on the card,
   bit for bit: Copenhagen playout states and dense random boards at
   B=4096, every preset at B=256, and 15x15 and 21x21 board batches; then
   the cases that a kernel serving a group of games per CTA makes risky:
   batches that the group does not divide (B = 1, 3, 257, odd batches of
   the 7x7 and 9x9 presets), 19x19 boards (whose groups of three start off
   a 16-byte boundary), games with no legal move, boards full of one side's
   pieces, and constructed shieldwalls, enclosures, exit forts and king
   captures beside the throne (``tests/test_torch_cases.py``) on every
   preset and on 15x15, 19x19 and 21x21 boards;
4. kernel 2 (env step) against its plain version on the same inputs, field
   for field over every output, the 24 scalar rows included; then the time
   of each kernel beside its plain version at the self-play shapes, with
   the least time the card could take for the same bytes (each input read
   once, each output written once, at 3.35 TB/s) and the share of that
   bound the kernel reaches; B=1 is timed too, as what a launch of either
   kernel costs with next to no work in it;
5. self-play at full width: 11x11 Copenhagen, a 64-channel 6-block
   GroupNorm net with a bf16 trunk and random weights from a seed,
   ``MCTSConfig()`` (128 simulations, 128 children), 256 games of at most 8
   moves in a batch of 256. Both kernels' launch counters must grow during
   this phase.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Run it from the repository root::

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
PRESETS = ("brandubh", "copenhagen", "koch", "magpie", "tablut")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def dense_boards(rng: np.random.RandomState, n: int, count: int) -> np.ndarray:
    """Random positions with one king at 15-40% piece density; corners and
    throne empty except that the king may hold the throne."""
    boards = np.zeros((count, n, n), np.int8)
    for b in range(count):
        board = boards[b]
        cells = rng.rand(n, n) < rng.uniform(0.15, 0.4)
        att = rng.rand(n, n) < 0.5
        board[cells & att] = 1
        board[cells & ~att] = 2
        for r, c in [(0, 0), (0, n - 1), (n - 1, 0), (n - 1, n - 1), (n // 2, n // 2)]:
            board[r, c] = 0
        empties = np.argwhere(board == 0)
        board[tuple(empties[rng.randint(len(empties))])] = 3
    return boards


def random_actions(mask, gen):
    """One uniformly random legal action per game (action 0 where none)."""
    import torch

    weights = mask.float()
    none = weights.sum(1) == 0
    weights[none, 0] = 1.0
    return torch.multinomial(weights, 1, generator=gen)[:, 0].to(torch.int32)


class KernelCheck:
    """Holds each kernel against its plain version and keeps the worst error."""

    def __init__(self):
        self.err = {"legal_mask": 0, "step": 0}
        self.cases = 0

    def check(self, env, states, actions, what):
        import torch

        from alphazeroforhnefatafl_tpu_torch.ops.legal_mask import (
            batched_legal_mask,
            legal_mask_plain,
        )
        from alphazeroforhnefatafl_tpu_torch.ops.step_kernel import step_arrays, step_plain

        got = batched_legal_mask(env, states.board, states.side_to_play)
        want = legal_mask_plain(env, states.board, states.side_to_play)
        err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
        self.err["legal_mask"] = max(self.err["legal_mask"], err)
        if not torch.equal(got, want):
            fail(f"kernel 1 disagrees with its plain version: {what}")
        args = (
            env, states.board, states.side_to_play, actions, states.recent_plays,
            states.rep_first_i, states.reps, states.mid_pair, states.plays_since_capture,
        )
        got = step_arrays(*args)
        want = step_plain(*args)
        for name, g, w in zip(("board3", "cap", "next_mask", "scal"), got, want):
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            self.err["step"] = max(self.err["step"], err)
            if not torch.equal(g, w):
                fail(f"kernel 2 disagrees with its plain version on {name}: {what}")
        self.cases += 1


def playout_states(env, B, plies, gen, checker, what):
    """Random legal playouts with auto-reset, each ply checked by ``checker``;
    returns the states after the last ply."""
    from alphazeroforhnefatafl_tpu_torch.core.env import where_state

    states = env.reset_batch(B)
    fresh = env.reset_batch(B)
    for t in range(plies):
        actions = random_actions(env.legal_mask_many(states), gen)
        checker.check(env, states, actions, f"{what} ply {t}")
        states, _ = env.step_many(states, actions)
        states = where_state(states.terminated, fresh, states)
    return states


def phase_kernels(device, checker):
    import torch

    from alphazeroforhnefatafl_tpu_torch.core.env import TaflEnv, make_env

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cases import constructed_cases

    gen = torch.Generator(device=device).manual_seed(SEED)
    rng = np.random.RandomState(SEED)

    def dense_case(env, B, what):
        boards = torch.as_tensor(dense_boards(rng, env.n, B), device=device)
        for side in (0, 1):
            states = env.reset_batch(B).replace(
                board=boards,
                side_to_play=torch.full((B,), side, dtype=torch.int32, device=device),
            )
            actions = random_actions(env.legal_mask_many(states), gen)
            checker.check(env, states, actions, f"{what} side {side}")

    cph = make_env("copenhagen", device)
    playout_states(cph, 4096, 24, gen, checker, "copenhagen B=4096 playout")
    for k in range(4):
        dense_case(cph, 4096, f"copenhagen B=4096 dense #{k}")
    for preset in PRESETS:
        env = make_env(preset, device)
        playout_states(env, 256, 24, gen, checker, f"{preset} B=256 playout")
        dense_case(env, 256, f"{preset} B=256 dense")
    big = {}
    for n in (15, 21):
        # Copenhagen rules on an n x n board (the start board is empty; the
        # dense boards replace it).
        big[n] = env = TaflEnv(cph.rules, "/".join([str(n)] * n), device)
        dense_case(env, 256, f"copenhagen rules {n}x{n}")

    # Batches that the group of four games per CTA does not divide.
    for B in (1, 3, 257):
        playout_states(cph, B, 6, gen, checker, f"copenhagen B={B} playout")
        dense_case(cph, B, f"copenhagen B={B} dense")
    for preset, B in (("brandubh", 255), ("tablut", 129)):
        env = make_env(preset, device)
        playout_states(env, B, 6, gen, checker, f"{preset} B={B} playout")
        dense_case(env, B, f"{preset} B={B} dense")
    dense_case(big[15], 5, "copenhagen rules 15x15 B=5")
    dense_case(big[21], 3, "copenhagen rules 21x21 B=3")
    # At 19x19 three games fit a CTA's staging memory and their masks span a
    # number of bytes that 16 does not divide: every other CTA's span starts
    # 8 bytes off a 16-byte boundary and its head leaves byte by byte.
    big[19] = TaflEnv(cph.rules, "/".join(["19"] * 19), device)
    dense_case(big[19], 64, "copenhagen rules 19x19 B=64")
    dense_case(big[19], 7, "copenhagen rules 19x19 B=7")

    def board_case(env, boards, what):
        """The same boards with either side to move."""
        B = boards.shape[0]
        for side in (0, 1):
            states = env.reset_batch(B).replace(
                board=torch.as_tensor(boards, device=device),
                side_to_play=torch.full((B,), side, dtype=torch.int32, device=device),
            )
            actions = random_actions(env.legal_mask_many(states), gen)
            checker.check(env, states, actions, f"{what} side {side}")

    # No legal move for either side (a checkerboard of the two sides), and
    # boards full of one side's pieces.
    for env in (cph, make_env("brandubh", device), big[21]):
        n = env.n
        rr, cc = np.indices((n, n))
        checker_board = np.where((rr + cc) % 2 == 0, 1, 2).astype(np.int8)
        board_case(env, np.repeat(checker_board[None], 7, 0), f"{n}x{n} no legal move")
        for code in (1, 2):
            board_case(env, np.full((7, n, n), code, np.int8), f"{n}x{n} full of {code}")

    # Constructed shieldwalls, enclosures, exit forts and king captures.
    def constructed(env, B, what):
        boards, sides, actions = constructed_cases(rng, env.n, B)
        states = env.reset_batch(B).replace(
            board=torch.as_tensor(boards, device=device),
            side_to_play=torch.as_tensor(sides, device=device),
        )
        checker.check(env, states, torch.as_tensor(actions, device=device), what)

    for preset in PRESETS:
        constructed(make_env(preset, device), 1001, f"{preset} constructed B=1001")
    for n in (15, 19, 21):
        constructed(big[n], 251, f"copenhagen rules {n}x{n} constructed")
    print(f"kernels: {checker.cases} cases bit-exact against the plain versions "
          f"(max_abs_err legal_mask={checker.err['legal_mask']} step={checker.err['step']})",
          flush=True)


def time_ms(fn, reps=20, device_only=False):
    """Mean milliseconds per call on the card (CUDA events, after warm-up).

    By default this is what a caller pays per call, host issue included:
    when a call's launches take the host longer than the card, the events
    time the host. With ``device_only`` the stream first spins for tens of
    milliseconds, so every call is queued before the first one runs and the
    events time the card alone; ``fn`` must not synchronize."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if device_only:
        torch.cuda._sleep(100_000_000)  # clock cycles: ~50 ms at 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if device_only and start.query():
        fail("the stream hold ended before the host had queued every call")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def timing_case(env, B, gen, checker):
    """Copenhagen playout states at batch B: each kernel's and its plain
    version's call, and the bytes each must move (every input read once,
    every output written once; the rule table is not counted)."""
    from alphazeroforhnefatafl_tpu_torch.ops.legal_mask import batched_legal_mask, legal_mask_plain
    from alphazeroforhnefatafl_tpu_torch.ops.step_kernel import step_arrays, step_plain

    s = playout_states(env, B, 16, gen, checker, f"timing states B={B}")
    actions = random_actions(env.legal_mask_many(s), gen)
    mask_in = (s.board, s.side_to_play)
    step_in = (s.board, s.side_to_play, actions, s.recent_plays, s.rep_first_i,
               s.reps, s.mid_pair, s.plays_since_capture)
    kernel = {
        "legal_mask": lambda: batched_legal_mask(env, *mask_in),
        "step": lambda: step_arrays(env, *step_in),
    }
    plain = {
        "legal_mask": lambda: legal_mask_plain(env, *mask_in),
        "step": lambda: step_plain(env, *step_in),
    }
    nbytes = {
        "legal_mask": tensor_bytes(mask_in) + tensor_bytes([kernel["legal_mask"]()]),
        "step": tensor_bytes(step_in) + tensor_bytes(kernel["step"]()),
    }
    return kernel, plain, nbytes


def phase_timing(device, checker, card):
    """Kernel and plain times at the self-play shapes (Copenhagen playout
    states at B=256, the self-play batch, and B=4096), each kernel beside
    the bound its bytes set; and at B=1, where the card's time is what a
    launch of the kernel costs with next to no work in it."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.core.env import make_env

    env = make_env("copenhagen", device)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    times = {}
    for B in (1, 256, 4096):
        kernel, plain, nbytes = timing_case(env, B, gen, checker)
        times[B] = {}
        for k in kernel:
            ms, plain_ms = time_ms(kernel[k]), time_ms(plain[k])
            dev_ms = time_ms(kernel[k], device_only=True)
            bound_ms = nbytes[k] / HBM_BYTES_PER_S * 1e3
            times[B][k] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bytes=nbytes[k])
            print(f"time copenhagen B={B} {k} on {card}: kernel {ms:.4f} ms per call "
                  f"({dev_ms:.4f} ms of it on the card), plain {plain_ms:.4f} ms; "
                  f"bound {nbytes[k]} bytes / 3.35 TB/s = {bound_ms:.5f} ms, "
                  f"{100 * bound_ms / dev_ms:.1f}% of it reached", flush=True)
    return times


def phase_net_check(device):
    """The port's net on the card against the same weights on the CPU, in
    float32 with TF32 off (tolerance 1e-4: the two devices sum convolutions
    in different orders)."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.models.network import init_params, make_network

    env = make_env("copenhagen", "cpu")
    net = make_network(env.n, channels=64, blocks=6, dtype=torch.float32)
    net = init_params(net, torch.Generator().manual_seed(SEED)).eval()
    boards = torch.as_tensor(dense_boards(np.random.RandomState(SEED), env.n, 8))
    obs = env.observe(env.reset_batch(8).replace(board=boards))
    with torch.inference_mode():
        want = net(obs)
        got = net.to(device)(obs.to(device))
    for name, g, w in zip(("logits", "value"), got, want):
        err = float((g.cpu() - w).abs().max())
        if not torch.allclose(g.cpu(), w, atol=1e-4, rtol=1e-4):
            fail(f"net {name} on the card differs from the CPU by {err}")
    print("net: float32 forward on the card matches the CPU within 1e-4", flush=True)


def phase_selfplay(device, card):
    import torch

    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.models.network import init_params, make_network
    from alphazeroforhnefatafl_tpu_torch.ops.legal_mask import batched_legal_mask
    from alphazeroforhnefatafl_tpu_torch.ops.step_kernel import step_arrays
    from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTSConfig
    from alphazeroforhnefatafl_tpu_torch.train.replay import ReplayBuffer
    from alphazeroforhnefatafl_tpu_torch.train.selfplay import SelfPlayActor, SelfPlayConfig

    env = make_env("copenhagen", device)
    net = make_network(env.n, channels=64, blocks=6, norm="group", dtype=torch.bfloat16)
    net = init_params(net, torch.Generator().manual_seed(SEED)).to(device).eval()
    mcts_cfg = MCTSConfig()
    sp_cfg = SelfPlayConfig(batch_size=256, max_game_len=8)
    actor = SelfPlayActor(env, net, mcts_cfg, sp_cfg, device=device)
    replay = ReplayBuffer(env, sp_cfg.batch_size * sp_cfg.max_game_len * 2, sp_cfg.policy_k)
    gen = torch.Generator(device=device).manual_seed(SEED)

    # Per-move wall times. The play loop copies each move's results to the
    # host right after the move, so these synchronizes add no wait of their
    # own to the run's wall time.
    move_s = []
    untimed_move = actor.move

    def timed_move(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = untimed_move(*args)
        torch.cuda.synchronize()
        move_s.append(time.perf_counter() - t)
        return out

    actor.move = timed_move

    batched_legal_mask.launches = 0
    step_arrays.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = actor.play(replay, gen, num_games=256)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"legal_mask": batched_legal_mask.launches, "step": step_arrays.launches}

    d = stats.as_dict()
    print(f"selfplay stats: {json.dumps(d)}", flush=True)
    if stats.games < 256:
        fail(f"self-play finished {stats.games} games, expected >= 256")
    if replay.size != stats.positions or replay.size == 0:
        fail(f"replay holds {replay.size} positions, stats say {stats.positions}")
    if not all(np.isfinite(v) for v in d.values()):
        fail("non-finite self-play stats")
    vals = replay.value[: replay.size]
    if not np.isin(vals, (-1.0, 0.0, 1.0)).all():
        fail("value targets outside {-1, 0, 1}")
    psum = replay.policy_p[: replay.size].sum(1)
    if not np.allclose(psum, 1.0, atol=1e-5):
        fail(f"policy targets do not sum to 1 (worst {np.abs(psum - 1).max()})")
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched during self-play")
    moves = actor.moves_played
    games_moves = moves * sp_cfg.batch_size
    rate = games_moves / wall
    print(f"selfplay on {card}: {moves} batched moves of B={sp_cfg.batch_size} in {wall:.3f} s; "
          f"{rate:.1f} moves/s, {rate * mcts_cfg.num_simulations:.1f} sims/s; launches {launches}",
          flush=True)
    q = np.percentile(move_s[1:], [25, 50, 75])
    print(f"selfplay move seconds: first {move_s[0]:.4f}; moves 2-{len(move_s)} quartiles "
          f"{q[0]:.4f} / {q[1]:.4f} / {q[2]:.4f}", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:
        from alphazeroforhnefatafl_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the port is not importable ({e}); run from the repository root")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # Phase 1: the card.
    card = card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)

    # Phase 2: build.
    path, seconds, log = _build.build()
    _build.load_library()
    print(f"build: {path.name} in {seconds:.2f} s", flush=True)
    for line in log.splitlines():
        if "ptxas" in line or "bytes stack frame" in line:
            print(f"build: {line.strip()}", flush=True)

    # Phases 3 and 4: both kernels against their plain versions, then times.
    checker = KernelCheck()
    phase_kernels(device, checker)
    times = phase_timing(device, checker, card)
    phase_net_check(device)

    # Phase 5: self-play at full width through both kernels.
    launches = phase_selfplay(device, card)

    sources = {
        "legal_mask": ("csrc/legal_mask.cu", "ops/legal_mask.py:148"),
        "step": ("csrc/step_kernel.cu", "ops/step_kernel.py:706"),
    }
    # Times at B=256, the self-play batch; "ms" is what a call of the wrapper
    # takes, the host's issue of it included, "device_ms" the kernel on the
    # card alone. No single PyTorch call computes either function, so there
    # is no library time.
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": f"alphazeroforhnefatafl_tpu_torch/{source}",
            "replaces": f"alphazeroforhnefatafl_tpu/{replaces}",
            "launches": launches[name],
            "max_abs_err": checker.err[name],
            "ms": times[256][name]["ms"],
            "plain_ms": times[256][name]["plain_ms"],
            "bound_ms": times[256][name]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "device_ms": times[256][name]["device_ms"],
            "bytes": times[256][name]["bytes"],
        }
        for name, (source, replaces) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
