"""Search-config A/B arena: one net, two MCTSConfigs head to head.

The counterpart of the root ``scripts/search_ab.py``: config A against
config B with one checkpoint through ``train.arena.play_config_match``
(candidate = A); ``--out`` appends the result line::

    python -m alphazeroforhnefatafl_tpu_torch.scripts.search_ab \\
        --ckpt runs/copenhagen_r4ab_puct/ckpt --games 64 --sims 128 \\
        --a leaves=2,recall=0.9 --b leaves=1,recall=0.99

A spec is ``key=value`` pairs: ``leaves`` (``leaves_per_wave``), ``recall``
(``topk_recall``), ``vloss`` (``virtual_loss``), or any other field of
``MCTSConfig`` by name, its value taken as that field's type. Unlike the
JAX script, a spec without ``vloss`` keeps ``MCTSConfig``'s default virtual
loss (0.25, where the JAX script takes 1.0), and an unknown key raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from ..cli import _device
from ..core.env import make_env
from ..search.mcts import MCTSConfig
from ..train.arena import play_config_match
from ..train.checkpoint import CheckpointManager
from . import add_device_flags
from ..models.network import NORMS
from .eval_run import fresh_net_factory

#: The short names of a spec, and the fields they set.
SHORT_KEYS = {"leaves": "leaves_per_wave", "recall": "topk_recall", "vloss": "virtual_loss"}
#: Fields the flags set, which a spec may not name.
FLAG_FIELDS = ("num_simulations", "max_children", "dirichlet_eps")


def _coerce(field: str, text: str):
    """``text`` as the type of ``MCTSConfig``'s ``field``; a field whose
    default is None (``dirichlet_alpha_scale``) takes a float or ``None``."""
    default = getattr(MCTSConfig(), field)
    if default is None:
        return None if text.lower() == "none" else float(text)
    return type(default)(text)


def parse_cfg(spec: str, sims: int, children: int) -> MCTSConfig:
    """The noise-free ``MCTSConfig`` of ``sims`` simulations and ``children``
    children that ``spec`` (``key=value,...``) describes."""
    fields = {f.name for f in dataclasses.fields(MCTSConfig)} - set(FLAG_FIELDS)
    kw = {}
    for part in filter(None, spec.split(",")):
        key, _, value = part.partition("=")
        field = SHORT_KEYS.get(key, key)
        if field not in fields:
            raise ValueError(
                f"search spec {spec!r}: unknown key {key!r} (expected leaves, recall, "
                f"vloss or an MCTSConfig field other than {', '.join(FLAG_FIELDS)})"
            )
        kw[field] = _coerce(field, value)
    return MCTSConfig(num_simulations=sims, max_children=children, dirichlet_eps=0.0, **kw)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="search_ab")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--step", default="latest")
    p.add_argument("--games", type=int, default=64)
    p.add_argument("--sims", type=int, default=128)
    p.add_argument("--children", type=int, default=32)
    p.add_argument("--max-game-len", type=int, default=300)
    p.add_argument("--a", default="leaves=2,recall=0.9")
    p.add_argument("--b", default="leaves=1,recall=0.99")
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--blocks", type=int, default=6)
    p.add_argument("--norm", default="group", choices=NORMS)
    p.add_argument("--se-ratio", type=int, default=0,
                   help="SE unit ratio of --norm batch (channels / hidden units)")
    p.add_argument("--preset", default="copenhagen")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    add_device_flags(p)
    return p


def main(argv=None) -> int:
    p = build_parser()
    a = p.parse_args(argv)

    cfg_a = parse_cfg(a.a, a.sims, a.children)
    cfg_b = parse_cfg(a.b, a.sims, a.children)
    device = _device(a)
    env = make_env(a.preset, device)
    mgr = CheckpointManager(a.ckpt)
    it = mgr.latest_iteration() if a.step == "latest" else int(a.step)
    state = fresh_net_factory(env, a, device)()
    mgr.restore(state, None, iteration=it)
    print(f"loaded {a.ckpt}:{it}", file=sys.stderr)
    net = state.net.eval()

    res = play_config_match(
        env, net, net, cfg_a, cfg_b,
        num_games=a.games,
        max_game_len=a.max_game_len,
        generator=torch.Generator(device=device).manual_seed(a.seed),
    )
    out = {"a": a.a, "b": a.b, "sims": a.sims, "ckpt_step": it, **res.as_dict()}
    line = json.dumps(out)
    print(line)
    if a.out:
        with open(a.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
