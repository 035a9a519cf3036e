#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``alphazeroforhnefatafl_tpu_torch``) on one
CUDA card.

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build both CUDA kernels from ``alphazeroforhnefatafl_tpu_torch/csrc``;
3. kernel 1 (legal mask) against its plain PyTorch version on the card,
   bit for bit: Copenhagen playout states and dense random boards at
   B=4096, every preset at B=256, and 15x15 and 21x21 board batches;
4. kernel 2 (env step) against its plain version on the same inputs, field
   for field over every output, the 24 scalar rows included; then the time
   of each kernel beside its plain version at the self-play shapes;
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

import numpy as np

SEED = 0
PRESETS = ("brandubh", "copenhagen", "koch", "magpie", "tablut")


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
    for n in (15, 21):
        # Copenhagen rules on an n x n board (the start board is empty; the
        # dense boards replace it).
        env = TaflEnv(cph.rules, "/".join([str(n)] * n), device)
        dense_case(env, 256, f"copenhagen rules {n}x{n}")
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


def phase_timing(device, checker):
    """Kernel and plain times at the self-play shapes (Copenhagen playout
    states at B=256, the self-play batch, and B=4096)."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.ops.legal_mask import batched_legal_mask, legal_mask_plain
    from alphazeroforhnefatafl_tpu_torch.ops.step_kernel import step_arrays, step_plain

    env = make_env("copenhagen", device)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    times = {}
    for B in (256, 4096):
        s = playout_states(env, B, 16, gen, checker, f"timing states B={B}")
        actions = random_actions(env.legal_mask_many(s), gen)
        args = (env, s.board, s.side_to_play, actions, s.recent_plays, s.rep_first_i,
                s.reps, s.mid_pair, s.plays_since_capture)
        kernel = {
            "legal_mask": lambda: batched_legal_mask(env, s.board, s.side_to_play),
            "step": lambda: step_arrays(*args),
        }
        plain = {
            "legal_mask": lambda: legal_mask_plain(env, s.board, s.side_to_play),
            "step": lambda: step_plain(*args),
        }
        times[B] = {k: (time_ms(kernel[k]), time_ms(plain[k])) for k in kernel}
        for k, (ms, plain_ms) in times[B].items():
            dev_ms = time_ms(kernel[k], device_only=True)
            print(f"time copenhagen B={B} {k}: kernel {ms:.4f} ms per call "
                  f"({dev_ms:.4f} ms of it on the card), plain {plain_ms:.4f} ms", flush=True)
    return times


def phase_net_check(device):
    """The port's net on the card against the same weights on the CPU, in
    float32 with TF32 off (tolerance 1e-4: the two devices sum convolutions
    in different orders)."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.models.network import init_params, make_network

    env = make_env("copenhagen")
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
    ptxas = [line.strip() for line in log.splitlines() if "registers" in line]
    print(f"build: {path.name} in {seconds:.2f} s; ptxas: {ptxas}", flush=True)

    # Phases 3 and 4: both kernels against their plain versions, then times.
    checker = KernelCheck()
    phase_kernels(device, checker)
    times = phase_timing(device, checker)
    phase_net_check(device)

    # Phase 5: self-play at full width through both kernels.
    launches = phase_selfplay(device, card)

    kernels = [
        {
            "name": "legal_mask",
            "route": "cuda",
            "source": "alphazeroforhnefatafl_tpu_torch/csrc/legal_mask.cu",
            "replaces": "alphazeroforhnefatafl_tpu/ops/legal_mask.py:148",
            "launches": launches["legal_mask"],
            "max_abs_err": checker.err["legal_mask"],
            "ms": times[256]["legal_mask"][0],
            "plain_ms": times[256]["legal_mask"][1],
        },
        {
            "name": "step",
            "route": "cuda",
            "source": "alphazeroforhnefatafl_tpu_torch/csrc/step_kernel.cu",
            "replaces": "alphazeroforhnefatafl_tpu/ops/step_kernel.py:706",
            "launches": launches["step"],
            "max_abs_err": checker.err["step"],
            "ms": times[256]["step"][0],
            "plain_ms": times[256]["step"][1],
        },
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
