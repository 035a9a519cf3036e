"""One full AlphaZero iteration across ranks on tiny shapes.

The counterpart of ``__graft_entry__.dryrun_multichip``: the same Brandubh
configuration (an 8-channel 1-block net, the flagship search recipe of two
leaves a wave and top-k recall 0.9, a Wilson gate, resignation), run by
``n_ranks`` processes joined by ``torch.distributed``::

    python -m alphazeroforhnefatafl_tpu_torch.parallel.dryrun 2          # the card
    python -m alphazeroforhnefatafl_tpu_torch.parallel.dryrun 2 --cpu    # the CPU

The ranks are started with the ``spawn`` method (no fork after CUDA is
initialised) and meet in a ``FileStore`` in a temporary directory (no race
for a TCP port).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
from typing import Optional

import torch

#: The arena's cap in plies. The JAX dryrun's 24 plies truncated all of its
#: games (VERDICT.md weak #6), so its gate decided nothing. With two ranks
#: and seed 0, 8 arena games on the CPU are decisive 0 times at 24 plies, 3
#: at 48, 4 at 64 and 4 at 96; on an H100, 5 at 96.
ARENA_MAX_GAME_LEN = 96


def dryrun_config(n_ranks: int):
    from ..search.mcts import MCTSConfig
    from ..train.loop import LoopConfig
    from ..train.selfplay import SelfPlayConfig

    b = max(8, n_ranks)
    return LoopConfig(
        preset="brandubh",
        iterations=1,
        games_per_iteration=b,
        train_steps_per_iteration=2,
        train_batch_size=2 * b,
        min_replay_size=8,
        replay_capacity=4_096,
        channels=8,
        blocks=1,
        arena_games=b,
        arena_sims=2,
        arena_every=1,  # run the arena in this single dryrun iteration
        arena_max_game_len=ARENA_MAX_GAME_LEN,
        gate_threshold=0.5,
        gate_on="wilson",
        seed=0,
        mcts=MCTSConfig(
            num_simulations=4, max_children=8, max_depth=8,
            leaves_per_wave=2, topk_recall=0.9,
        ),
        selfplay=SelfPlayConfig(
            batch_size=b, temp_threshold=4, max_game_len=24, policy_k=8,
            resign_threshold=0.9, resign_min_moves=4,
        ),
    )


def params_digest(net: torch.nn.Module) -> str:
    """SHA-1 of the net's tensors' bytes, in ``state_dict`` order."""
    h = hashlib.sha1()
    for v in net.state_dict().values():
        h.update(v.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def replay_digest(replay) -> str:
    n = replay.size
    return hashlib.sha1(replay.board[:n].tobytes() + replay.policy_p[:n].tobytes()).hexdigest()


def _rank(rank: int, n_ranks: int, store_dir: str, device: str, backend: Optional[str]) -> None:
    import torch.distributed as dist

    from ..core.env import make_env
    from ..train.loop import run_loop
    from ..train.replay import ReplayBuffer
    from ..utils.metrics import MetricsLogger
    from .launch import initialize_distributed, rank_log_path

    torch.set_num_threads(1)
    topo = initialize_distributed(
        f"file://{store_dir}/store", n_ranks, rank, backend=backend, device=device
    )
    try:
        env = make_env("brandubh", topo.device)
        config = dryrun_config(n_ranks)
        replay = ReplayBuffer(env, config.replay_capacity, config.selfplay.policy_k)
        path = rank_log_path(os.path.join(store_dir, "metrics.jsonl"), rank)
        with open(os.devnull, "w") as quiet:
            log = MetricsLogger(stream=quiet, jsonl_path=path)
            state = run_loop(env, config, log=log, replay=replay)
            log.close()
        with open(path) as f:
            line = json.loads(f.read().splitlines()[-1])
        out = {
            "rank": rank, "backend": topo.backend, "device": str(topo.device),
            "step": state.step, "params": params_digest(state.net),
            "replay": replay_digest(replay), "replay_size": replay.size,
            **{k: line[k] for k in line if k.startswith("arena/")},
        }
        with open(os.path.join(store_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_ranks: int, device: str = "cuda", backend: Optional[str] = None) -> dict:
    """Start ``n_ranks`` ranks, run ONE full iteration (self-play -> train
    -> arena gating) across them, check it and print one line.

    Asserts that every rank ends with bit-identical parameters, that the
    ranks' replays differ (each plays its own games) and that the arena
    played at least one decisive game. Returns rank 0's summary.
    """
    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dryrun_multichip(device='cuda'): CUDA is not available; pass device='cpu'"
        )
    with tempfile.TemporaryDirectory() as store_dir:
        mp.start_processes(
            _rank, args=(n_ranks, store_dir, device, backend), nprocs=n_ranks,
            join=True, start_method="spawn",
        )
        ranks = []
        for r in range(n_ranks):
            with open(os.path.join(store_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    first = ranks[0]
    if any(r["params"] != first["params"] for r in ranks):
        raise AssertionError(f"the ranks' parameters differ: {[r['params'] for r in ranks]}")
    if len({r["replay"] for r in ranks}) != n_ranks:
        raise AssertionError("two ranks played the same games")
    decisive = int(first["arena/candidate_wins"] + first["arena/incumbent_wins"])
    if decisive < 1:
        raise AssertionError(f"no arena game was decisive at {ARENA_MAX_GAME_LEN} plies: {first}")
    first["arena/decisive"] = decisive
    print(
        f"dryrun_multichip OK: {n_ranks} ranks on {first['device']} over {first['backend']}, "
        f"full iteration (selfplay+train+arena) step={first['step']}; replay sizes "
        f"{[r['replay_size'] for r in ranks]}; arena {decisive} decisive of "
        f"{int(first['arena/games'])} at {ARENA_MAX_GAME_LEN} plies, Wilson lower bound "
        f"{first['arena/gate_wilson_lb']:.4f}, promoted {int(first['arena/promoted'])}",
        flush=True,
    )
    return first


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dryrun")
    p.add_argument("ranks", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--cpu", action="store_true", help="same as --device cpu")
    p.add_argument("--backend", default=None, help="gloo or nccl (default: by the cards)")
    a = p.parse_args(argv)
    dryrun_multichip(a.ranks, "cpu" if a.cpu else a.device, a.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
