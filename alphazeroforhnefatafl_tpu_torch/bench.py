"""Headline benchmark of the port: env steps/s and MCTS sims/s on 11x11
Copenhagen Hnefatafl.

The counterpart of the JAX package's root ``bench.py``. On the card: 4096
lockstep games with the full capture and surround rules, a random legal
action a move and auto-reset, every step one launch of the fused step
kernel (``make_rollout``); then batched MCTS with the flagship net on 1024
games (``bench_mcts_sims``): 128 simulations with 32 children at two leaves
a wave, 800 simulations with 128 children at four leaves a wave, and the
serial search (one leaf a wave, the exact reference semantics) at 128
simulations. Prints ONE JSON line::

    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ..., ...}

Run it on the card, or at the JAX bench's CPU sizes with ``--cpu``::

    python -m alphazeroforhnefatafl_tpu_torch.bench
    python -m alphazeroforhnefatafl_tpu_torch.bench --cpu

It is ``cli bench`` under another name. Without CUDA and without ``--cpu``
(or ``--device cpu``) it exits with an error: it never
measures the CPU in place of a card. A bench that fails exits non-zero.
``vs_baseline`` is env steps/s over the north-star target of 100k env
steps/s per chip (BASELINE.md).
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time

import torch

from .core.env import EnvState, make_env, where_state
from .models.network import OBS_PLANES, init_params, make_network
from .search.mcts import MCTS, MCTSConfig
from .utils.profiling import annotate

TARGET_STEPS_PER_S = 100_000.0
#: H100 SXM dense bf16 tensor-core peak: the figure of NVIDIA's datasheet,
#: not a measurement. The MFU denominator.
CHIP_PEAK_FLOPS_BF16 = 989.4e12


def net_flops_per_eval(
    n: int, in_planes: int, channels: int, blocks: int, value_hidden: int = 128
) -> float:
    """Analytic forward-pass FLOPs of the flagship PolicyValueNet (MACs x 2).

    Counts the conv/dense contractions (norms and elementwise are noise at
    these shapes); identical for the group-norm and norm-free trunks.
    """
    nn2 = n * n
    conv = lambda cin, cout, k: 2.0 * nn2 * cin * cout * k * k
    f = conv(in_planes, channels, 3)  # stem
    f += blocks * 2 * conv(channels, channels, 3)  # residual trunk
    f += conv(channels, channels, 3)  # policy head 3x3
    f += conv(channels, 4 * (n - 1), 1)  # policy head 1x1 -> move planes
    f += conv(channels, 8, 1)  # value head 1x1
    f += 2.0 * (nn2 * 8) * value_hidden + 2.0 * value_hidden  # dense stack
    return f


def flagship_net(n: int, device, seed: int = 0):
    """The JAX package's flagship net: 64 channels, 6 GroupNorm blocks, bf16
    trunk, random weights from ``seed``, in eval mode on ``device``."""
    net = make_network(n, channels=64, blocks=6, norm="group", dtype=torch.bfloat16)
    return init_params(net, torch.Generator().manual_seed(seed)).to(device).eval()


def card_line() -> str:
    """The first card's ``name, power.limit`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_searches(env, net, cfg: MCTSConfig, batch: int, iters: int):
    """``(warm seconds, [seconds of each timed search])``: batched searches
    under ``cfg`` of ``batch`` games from the start position, no root noise,
    each ended by a copy of a checksum to the host. The warm search pays for
    cuDNN's algorithm choice and the allocator's growth."""
    mcts = MCTS(env, net, cfg)
    state = env.reset_batch(batch)
    legal = env.legal_mask_many(state)
    region = f"bench/mcts_b{batch}_s{cfg.num_simulations}_L{cfg.leaves_per_wave}"

    def run():
        with annotate(region):
            res = mcts.search(state, legal, add_noise=False)
            return float(res.root_visits.sum() + res.action_probs.sum())

    t0 = time.perf_counter()
    run()
    warm = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return warm, times


def bench_mcts_sims(device, seed: int = 0) -> dict:
    """MCTS sims/s with the flagship net: best and mean over timed searches
    after one warm search (:func:`time_searches`).

    On the card, three configurations at B=1024 (the JAX bench's two tuned
    ones and the serial search); on the CPU one small serial configuration.
    Keys of configurations not run hold None. ``topk_recall`` is passed as
    the JAX bench passes it; the port always takes the exact top-k, which
    the ``_exact`` of the config names records.
    """
    device = torch.device(device)
    env = make_env("copenhagen", device)
    net = flagship_net(env.n, device, seed)

    def one(batch, sims, children, iters, leaves=1, recall=0.99):
        cfg = MCTSConfig(
            num_simulations=sims, max_children=children, dirichlet_eps=0.0,
            leaves_per_wave=leaves, topk_recall=recall,
        )
        _, times = time_searches(env, net, cfg, batch, iters)
        return (
            round(batch * sims / min(times), 1),
            round(batch * sims * len(times) / sum(times), 1),
        )

    flops = net_flops_per_eval(env.n, OBS_PLANES, 64, 6)
    out = dict.fromkeys((
        "mcts_sims_per_s", "mcts_sims_per_s_mean", "mcts_config",
        "mcts_sims_per_s_800", "mcts_sims_per_s_800_mean", "mcts_config_800",
        "net_flops_per_eval", "mfu_128", "mfu_800", "chip_peak_tflops_bf16",
        "mcts_sims_per_s_serial", "mcts_sims_per_s_serial_mean", "mcts_config_serial",
    ))
    out["net_flops_per_eval"] = flops
    if device.type == "cuda":
        best128, mean128 = one(1024, 128, 32, 3, leaves=2, recall=0.9)
        best800, mean800 = one(1024, 800, 128, 2, leaves=4, recall=0.9)
        serial, serial_mean = one(1024, 128, 32, 3, leaves=1)
        out.update(
            mcts_sims_per_s=best128,
            mcts_sims_per_s_mean=mean128,
            mcts_config="b1024_s128_k32_L2_exact",
            mcts_sims_per_s_800=best800,
            mcts_sims_per_s_800_mean=mean800,
            mcts_config_800="b1024_s800_k128_L4_exact",
            # NN-forward MFU at each regime: one eval per simulation, so
            # evals/s == sims/s; everything the search spends beyond the
            # forward (traversal, env steps, backup) shows up as lost MFU.
            mfu_128=round(best128 * flops / CHIP_PEAK_FLOPS_BF16, 4),
            mfu_800=round(best800 * flops / CHIP_PEAK_FLOPS_BF16, 4),
            chip_peak_tflops_bf16=CHIP_PEAK_FLOPS_BF16 / 1e12,
            mcts_sims_per_s_serial=serial,
            mcts_sims_per_s_serial_mean=serial_mean,
            mcts_config_serial="b1024_s128_k32_L1_exact",
        )
    else:
        best, mean = one(16, 16, 16, 1)
        out.update(mcts_sims_per_s=best, mcts_sims_per_s_mean=mean, mcts_config="b16_s16_k16")
    return out


def make_rollout(env, batch: int, chunk: int):
    """``rollout(state, mask, generator=None, noise=None) -> (state, mask,
    checksum)``: ``chunk`` steps of every game with the policy
    ``argmax(mask * noise)``, finished games reset in place.

    ``noise`` (``f32[chunk, B, A]``) is used in place of draws from
    ``generator``. The carried mask is the step's fused next-player mask
    (``info.legal_mask``): the env computes it for the NoPlays check, so a
    second mask launch would double the ray scan. The checksum (finished
    games plus the sum of turns) is left on the device.
    """
    fresh = env.reset_batch(batch)
    # Every fresh game is the same start position, so its mask is computed
    # once here with kernel 1, where the JAX rollout computes it every step.
    fresh_mask = env.legal_mask_many(fresh)

    def rollout(state: EnvState, mask: torch.Tensor, generator=None, noise=None):
        with annotate("bench/rollout"):
            dones = torch.zeros((), dtype=torch.int64, device=mask.device)
            for t in range(chunk):
                u = noise[t] if noise is not None else torch.rand(
                    mask.shape, generator=generator, device=mask.device
                )
                action = torch.argmax(mask * u, dim=-1).to(torch.int32)
                state, info = env.step_many(state, action)
                done = state.terminated
                state = where_state(done, fresh, state)
                mask = torch.where(done[:, None], fresh_mask, info.legal_mask)
                dones = dones + info.terminated.sum()
            return state, mask, dones + state.turn.sum()

    return rollout


def run_bench(device="cuda", seed: int = 0) -> dict:
    """The bench's record: env steps/s over timed windows of rollouts, then
    the MCTS figures. Raises when ``device`` is a card and there is none."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    batch = 4096 if on_card else 256
    chunk = 32 if on_card else 8
    windows = 8 if on_card else 2
    # Rollouts per timed window, queued without a sync between them: the
    # host syncs once per window on the last checksum, so the wait for the
    # card is paid once per window and not once per rollout.
    pipeline = 8 if on_card else 2

    env = make_env("copenhagen", device)
    state = env.reset_batch(batch)
    mask = env.legal_mask_many(state)
    generator = torch.Generator(device=device).manual_seed(seed)
    rollout = make_rollout(env, batch, chunk)

    state, mask, checksum = rollout(state, mask, generator)  # warm
    int(checksum)
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(pipeline):
            state, mask, checksum = rollout(state, mask, generator)
        int(checksum)  # the one sync of the window
        times.append(time.perf_counter() - t0)

    window_steps = batch * chunk * pipeline
    steps_per_s = window_steps / min(times)
    state_bytes = sum(
        t.element_size() * t.numel()
        for t in (getattr(state, f.name) for f in dataclasses.fields(state))
    )
    card, power_limit_w = None, None
    if on_card:
        card, limit = (s.strip() for s in card_line().split(",", 1))
        power_limit_w = float(limit.split()[0])
    rec = {
        "metric": "env_steps_per_sec_per_chip_11x11",
        "value": round(steps_per_s, 1),
        "unit": "steps/s",
        "vs_baseline": round(steps_per_s / TARGET_STEPS_PER_S, 3),
        "mean_value": round(window_steps * len(times) / sum(times), 1),
        "timing": f"best_of_{windows}_windows_x{pipeline}_rollouts_sync_per_window",
        "env_state_bytes_per_game": round(state_bytes / batch, 1),
    }
    rec.update(bench_mcts_sims(device, seed))
    rec.update(
        card=card,
        power_limit_w=power_limit_w,
        device=torch.cuda.get_device_name(device) if on_card else "cpu",
    )
    return rec


def main(argv=None) -> int:
    """``cli bench`` with the same flags and the same line."""
    from . import cli

    return cli.main(["bench", *(sys.argv[1:] if argv is None else argv)]) or 0


if __name__ == "__main__":
    sys.exit(main())
