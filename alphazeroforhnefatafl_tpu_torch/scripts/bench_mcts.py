"""MCTS throughput bench: simulations/s on 11x11 Copenhagen at any batch,
budget, children, leaves, depth or net.

The counterpart of the root ``scripts/bench_mcts.py``, with its flags and
its JSON line (one per run). The searches are timed as the port's
``bench.bench_mcts_sims`` times them (:func:`..bench.time_searches`): one
warm search, whose seconds are ``compile_s``, then ``--iters`` timed
searches, each ended by a copy of a checksum to the host. ``--chunk``,
``--node-read`` and ``--unroll`` are TPU mechanisms: accepted, ignored, and
noted on stderr when off their defaults; the metric's name records them as
the JAX script records them::

    python -m alphazeroforhnefatafl_tpu_torch.scripts.bench_mcts --batch 1024 --sims 128 --leaves 2
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..bench import time_searches
from ..cli import _device
from ..core.env import make_env
from ..models.network import NORMS, init_params, make_network
from ..search.mcts import MCTSConfig
from . import add_device_flags, note_tpu_flags


def metric_name(batch, sims, children, chunk=0, node_read="auto", unroll=4,
                norm="group", leaves=1, max_depth=64, recall=0.99, se_ratio=0) -> str:
    """The metric's name, built as the JAX script builds it (the port's SE
    net, which the JAX package has not, adds ``_se<ratio>``)."""
    return (
        f"mcts_sims_per_s_11x11_b{batch}_s{sims}_k{children}"
        + (f"_c{chunk}" if chunk else "")
        + f"_{node_read}_u{unroll}"
        + (f"_L{leaves}" if leaves > 1 else "")
        + (f"_r{recall}" if recall != 0.99 else "")
        + (f"_d{max_depth}" if max_depth != 64 else "")
        + ("_nf" if norm == "none" else "")
        + (f"_se{se_ratio}" if norm == "batch" else "")
    )


def search_config(a: argparse.Namespace) -> MCTSConfig:
    """The noise-free search the flags ask for."""
    return MCTSConfig(
        num_simulations=a.sims, max_children=a.children, dirichlet_eps=0.0,
        node_read=a.node_read, traverse_unroll=a.unroll, leaves_per_wave=a.leaves,
        max_depth=a.max_depth, topk_recall=a.recall,
    )


def bench(a: argparse.Namespace, device) -> dict:
    """One bench line: the flags' net (bf16 trunk, random weights from seed
    0; by default the flagship's 64x6 GroupNorm net), searched under the
    flags' config."""
    env = make_env("copenhagen", device)
    net = make_network(env.n, channels=a.channels, blocks=a.blocks, norm=a.norm,
                       se_ratio=a.se_ratio)
    net = init_params(net, torch.Generator().manual_seed(0)).to(device).eval()
    compile_s, per_iter = time_searches(env, net, search_config(a), a.batch, a.iters)
    dt = min(per_iter)
    return {
        "metric": metric_name(a.batch, a.sims, a.children, a.chunk, a.node_read, a.unroll,
                              a.norm, a.leaves, a.max_depth, a.recall, a.se_ratio),
        "value": round(a.batch * a.sims / dt, 1),
        "unit": "sims/s",
        "compile_s": round(compile_s, 1),
        "best_ms_per_search": round(dt * 1000, 1),
        "mean_ms_per_search": round(sum(per_iter) / len(per_iter) * 1000, 1),
        "iter_ms": [round(t * 1000, 1) for t in per_iter],
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bench_mcts")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--sims", type=int, default=128)
    p.add_argument("--children", type=int, default=128)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--chunk", type=int, default=0,
                   help="TPU chunked search; accepted and ignored")
    p.add_argument("--node-read", default="auto", choices=["auto", "gather", "dot"],
                   help="TPU node-read form; accepted and ignored")
    p.add_argument("--unroll", type=int, default=4,
                   help="TPU traversal unroll; accepted and ignored")
    p.add_argument("--norm", default="group", choices=NORMS,
                   help="'none' = norm-free NFResBlock trunk, 'batch' = the SE net")
    p.add_argument("--se-ratio", type=int, default=0,
                   help="SE unit ratio of --norm batch (channels / hidden units)")
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--blocks", type=int, default=6)
    p.add_argument("--leaves", type=int, default=1,
                   help="leaves per tree per wave (virtual-loss multi-leaf)")
    p.add_argument("--max-depth", type=int, default=64)
    p.add_argument("--recall", type=float, default=0.99,
                   help="top-k recall target (the port takes the exact top-k)")
    add_device_flags(p)
    return p


def main(argv=None) -> int:
    p = build_parser()
    a = p.parse_args(argv)
    note_tpu_flags(p, a, "chunk", "node_read", "unroll")
    print(json.dumps(bench(a, _device(a))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
