"""Capture a ``torch.profiler`` trace of one batched MCTS search: the waves
of the flagship net's search at a fixed batch and budget.

The counterpart of the root ``scripts/profile_wave.py``, with its flags and
defaults (B=1024, 800 simulations, 128 children, one leaf a wave). The
flagship net (64 channels, 6 GroupNorm blocks, bf16 trunk, random weights
from seed 0) searches 11x11 Copenhagen from the start position without root
noise. The root mask is taken outside the trace, one warm search runs
outside it too, and then one search is traced with
``utils.profiling.device_trace``, inside a ``profile_wave/search`` region
that ends with a host copy of a checksum. ``--chunk`` is a TPU mechanism
(the JAX chunk-compiled search): accepted, ignored, and noted on stderr when
non-zero. The Chrome trace (``*.pt.trace.json``) lands under
``--trace-dir`` (by default ``tafl_trace`` in the temporary directory);
``scripts.analyze_trace`` reads it::

    python -m alphazeroforhnefatafl_tpu_torch.scripts.profile_wave --trace-dir trace
    python -m alphazeroforhnefatafl_tpu_torch.scripts.analyze_trace trace

Prints the JAX script's line (its seconds run from the profiler's start to
the trace on disk), then one JSON line with the traced search's seconds, the
seconds the profiler took to process and write the trace after it, and the
trace file with its size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from ..bench import flagship_net
from ..cli import _device
from ..core.env import make_env
from ..search.mcts import MCTS, MCTSConfig
from ..utils.profiling import annotate, device_trace
from . import add_device_flags, note_tpu_flags
from .analyze_trace import SEARCH_REGION, find_trace


def search_config(a: argparse.Namespace) -> MCTSConfig:
    """The noise-free search the flags ask for."""
    return MCTSConfig(
        num_simulations=a.sims, max_children=a.children, dirichlet_eps=0.0,
        leaves_per_wave=a.leaves,
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="profile_wave")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--sims", type=int, default=800)
    p.add_argument("--children", type=int, default=128)
    p.add_argument("--chunk", type=int, default=0,
                   help="TPU chunk-compiled search; accepted and ignored")
    p.add_argument("--leaves", type=int, default=1)
    p.add_argument("--trace-dir", default=os.path.join(tempfile.gettempdir(), "tafl_trace"))
    add_device_flags(p)
    return p


def main(argv=None) -> int:
    p = build_parser()
    a = p.parse_args(argv)
    note_tpu_flags(p, a, "chunk")
    device = _device(a)

    env = make_env("copenhagen", device)
    net = flagship_net(env.n, device, 0)
    mcts = MCTS(env, net, search_config(a))
    state = env.reset_batch(a.batch)
    legal = env.legal_mask_many(state)

    def run():
        res = mcts.search(state, legal, add_noise=False)
        return float(res.root_visits.sum() + res.action_probs.sum())

    run()  # warm, outside the trace: cuDNN's algorithm choice, the allocator
    t0 = time.perf_counter()
    with device_trace(a.trace_dir):
        t_search = time.perf_counter()
        with annotate(SEARCH_REGION):
            run()
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    print(f"traced one search in {t2 - t0:.2f}s -> {a.trace_dir}")
    trace = find_trace(a.trace_dir)
    print(json.dumps({
        "search_s": round(t1 - t_search, 4),
        "export_s": round(t2 - t1, 4),
        "trace": trace,
        "trace_mb": round(os.path.getsize(trace) / 2**20, 3),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
