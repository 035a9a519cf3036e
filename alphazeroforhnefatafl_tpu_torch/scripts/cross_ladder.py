"""Cross-run Elo ladder: round-robin checkpoints from different runs plus a
fresh init and fixed net-free anchors, one Bradley-Terry fit.

The counterpart of the root ``scripts/cross_ladder.py``::

    python -m alphazeroforhnefatafl_tpu_torch.scripts.cross_ladder \\
        --entry r4_final=runs/copenhagen_r4/ckpt:107 \\
        --entry gated=runs/cop_r5_gated/ckpt:latest \\
        --anchors uniform,random --games 16 --sims 128

Every entry is ``name=ckpt_dir:step`` (``step`` = integer, ``latest`` or
``mid``); all entries share one net architecture (--channels/--blocks/--norm/--se-ratio),
and each is restored into a net of its own. ``eval_run`` ladders within one
run; this is its cross-run companion.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Tuple

import torch

from ..cli import _device
from ..core.env import make_env
from ..search.mcts import MCTSConfig
from ..train.anchors import ANCHOR_CODES, make_anchored_evaluate
from ..train.arena import ladder
from ..train.checkpoint import CheckpointManager
from . import add_device_flags
from ..models.network import NORMS
from .eval_run import fresh_net_factory


def parse_entry(spec: str) -> Optional[Tuple[str, str, str]]:
    """``(name, ckpt_dir, step)`` of ``name=ckpt_dir:step``, split at the
    first ``=`` and the last ``:`` (a directory may hold a colon); None when
    a part is missing."""
    name, eq, loc = spec.partition("=")
    ckpt_dir, colon, step = loc.rpartition(":")
    if not (eq and colon and name and ckpt_dir and step):
        return None
    return name, ckpt_dir, step


def resolve_step(mgr: CheckpointManager, step: str) -> int:
    """The iteration an entry's ``step`` names: an integer, ``latest``, or
    ``mid`` (the middle of the retained checkpoints)."""
    if step == "latest":
        return mgr.latest_iteration()
    if step == "mid":
        steps = mgr.all_iterations()
        return steps[len(steps) // 2]
    return int(step)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cross_ladder")
    p.add_argument("--entry", action="append", default=[],
                   help="name=ckpt_dir:step (step int, 'latest' or 'mid'); repeatable")
    p.add_argument("--preset", default="copenhagen")
    p.add_argument("--games", type=int, default=16)
    p.add_argument("--sims", type=int, default=128)
    p.add_argument("--children", type=int, default=32)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--blocks", type=int, default=6)
    p.add_argument("--norm", default="group", choices=NORMS)
    p.add_argument("--se-ratio", type=int, default=0,
                   help="SE unit ratio of --norm batch (channels / hidden units)")
    p.add_argument("--max-game-len", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-init", action="store_true",
                   help="skip the fresh-init entry")
    p.add_argument("--anchors", default="uniform,random",
                   help="comma-separated: uniform,material,random ('' = none)")
    p.add_argument("--out", default=None, help="write the JSON result here too")
    add_device_flags(p)
    return p


def main(argv=None) -> int:
    p = build_parser()
    a = p.parse_args(argv)

    entries = []
    for spec in a.entry:
        parsed = parse_entry(spec)
        if parsed is None:
            p.error(
                f"--entry {spec!r}: expected name=ckpt_dir:step "
                "(step = integer, 'latest' or 'mid')"
            )
        entries.append(parsed)

    device = _device(a)
    env = make_env(a.preset, device)
    fresh = fresh_net_factory(env, a, device)
    named = [] if a.no_init else [("init", fresh().net.eval())]
    for name, ckpt_dir, step in entries:
        mgr = CheckpointManager(ckpt_dir)
        it = resolve_step(mgr, step)
        state = fresh()
        mgr.restore(state, None, iteration=it)
        named.append((name, state.net.eval()))
        print(f"loaded {name} <- {ckpt_dir}:{it}", file=sys.stderr)
    named += [
        (f"anchor_{n}", make_anchored_evaluate(env, ANCHOR_CODES[n]))
        for n in filter(None, a.anchors.split(","))
    ]

    print(f"laddering {[n for n, _ in named]}", file=sys.stderr)
    ratings, wins, games = ladder(
        env,
        named,
        MCTSConfig(num_simulations=a.sims, max_children=a.children, dirichlet_eps=0.0),
        games_per_pair=a.games,
        generator=torch.Generator(device=device).manual_seed(a.seed),
        max_game_len=a.max_game_len,
    )
    out = {
        "ratings": {k: round(float(v), 1) for k, v in ratings.items()},
        "score_matrix": wins.tolist(),
        "games_matrix": games.tolist(),
        "config": {
            "games_per_pair": a.games, "sims": a.sims,
            "children": a.children, "max_game_len": a.max_game_len,
        },
    }
    line = json.dumps(out)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
