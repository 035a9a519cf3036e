"""Learning-curve ladder over a run's retained checkpoints.

The counterpart of the root ``scripts/eval_run.py``::

    python -m alphazeroforhnefatafl_tpu_torch.scripts.eval_run \\
        --ckpt runs/copenhagen_r4/ckpt --games 24 --sims 128 --anchors uniform,random

Restores the parameters of every checkpoint under ``--ckpt`` (at most
``--max-steps`` of them, evenly spaced, the last always in), each into a net
of its own, skipping any that fail to restore (a checkpoint of another
architecture raises ``ValueError``), then round-robins them with a fresh
init and the ``--anchors`` and fits Bradley-Terry Elo. Prints
``{"ratings", "wins"}``, the ratings shifted so that ``anchor_uniform`` is 0
when it is laddered.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..cli import _device
from ..core.env import make_env
from ..models.network import NORMS, make_network
from ..search.mcts import MCTSConfig
from ..train.anchors import ANCHOR_CODES, make_anchored_evaluate
from ..train.arena import ladder
from ..train.checkpoint import CheckpointManager
from ..train.learner import init_train_state
from . import add_device_flags


def select_steps(steps, max_steps: int):
    """At most ``max_steps`` of ``steps``, evenly spaced across the run,
    always including the last."""
    if len(steps) > max_steps:
        idx = np.unique(np.round(np.linspace(0, len(steps) - 1, max_steps)).astype(int))
        steps = [steps[i] for i in idx]
    return steps


def fresh_net_factory(env, args, device):
    """``fresh() -> TrainState``: a new net of the flags' architecture,
    initialized from seed 0, with its own optimizer. The checkpoint restore
    loads in place, so every ladder entry needs a state of its own."""

    def fresh():
        net = make_network(env.n, channels=args.channels, blocks=args.blocks, norm=args.norm,
                           se_ratio=args.se_ratio)
        return init_train_state(net, torch.Generator().manual_seed(0), device)

    return fresh


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="eval_run")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--preset", default="copenhagen")
    p.add_argument("--games", type=int, default=24)
    p.add_argument("--sims", type=int, default=128)
    p.add_argument("--children", type=int, default=32)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--blocks", type=int, default=6)
    p.add_argument("--norm", default="group", choices=NORMS)
    p.add_argument("--se-ratio", type=int, default=0,
                   help="SE unit ratio of --norm batch (channels / hidden units)")
    p.add_argument("--max-steps", type=int, default=8,
                   help="ladder size: evenly-spaced steps across the run")
    p.add_argument("--max-game-len", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--anchors",
        default="",
        help="comma-separated net-free anchors to ladder alongside the "
        "checkpoints: uniform,material,random (train/anchors.py). Fixed "
        "external reference points, comparable across runs.",
    )
    add_device_flags(p)
    return p


def main(argv=None) -> int:
    p = build_parser()
    a = p.parse_args(argv)

    device = _device(a)
    env = make_env(a.preset, device)
    fresh = fresh_net_factory(env, a, device)
    mgr = CheckpointManager(a.ckpt)
    named = [("init", fresh().net.eval())]
    for s in select_steps(mgr.all_iterations(), a.max_steps):
        state = fresh()
        try:
            mgr.restore(state, None, iteration=s)  # the replay ring is not read
        except Exception as e:  # a foreign or corrupt checkpoint: skip it, say so
            print(f"skip step {s}: {type(e).__name__}", file=sys.stderr)
            continue
        named.append((f"iter{s:03d}", state.net.eval()))
    for name in filter(None, a.anchors.split(",")):
        named.append((f"anchor_{name}", make_anchored_evaluate(env, ANCHOR_CODES[name])))

    print(f"laddering {[n for n, _ in named]}", file=sys.stderr)
    ratings, wins, _ = ladder(
        env,
        named,
        MCTSConfig(num_simulations=a.sims, max_children=a.children, dirichlet_eps=0.0),
        games_per_pair=a.games,
        generator=torch.Generator(device=device).manual_seed(a.seed),
        max_game_len=a.max_game_len,
    )
    if "anchor_uniform" in ratings:
        # Re-anchor the scale to the net-free uniform-prior MCTS: a fixed
        # external zero point, comparable across runs.
        shift = ratings["anchor_uniform"]
        ratings = {k: v - shift for k, v in ratings.items()}
    print(json.dumps({"ratings": ratings, "wins": wins.tolist()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
