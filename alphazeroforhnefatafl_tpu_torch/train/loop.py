"""The AlphaZero training loop.

The counterpart of ``alphazeroforhnefatafl_tpu/train/loop.py``: self-play
actors, a replay buffer, the learner, arena gating, checkpointing and
metrics. Everything runs on the env's device (``env.device``: the CUDA card
unless the caller built the env for the CPU).

Across ranks (a ``torch.distributed`` process group, see
``parallel/launch.py``) a rank is what a host is to the JAX loop: it plays
its own games into its own replay, samples its slice of the global learner
batch, and the learner's all-reduce makes the update the global batch's;
it plays its slice of the arena's games, and every rank gates on the whole
match's result. In one process the loop makes no collective call.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.env import TaflEnv
from ..core.symmetry import NUM_TRANSFORMS, random_symmetry_batch
from ..models.network import make_network
from ..parallel import mesh
from ..parallel.launch import local_batch_slice, world
from ..search.mcts import MCTSConfig
from ..utils.metrics import MetricsLogger
from .arena import play_match
from .checkpoint import CheckpointManager
from .learner import TrainState, init_train_state, make_train_step
from .replay import ReplayBuffer, make_batch_builder
from .selfplay import SelfPlayActor, SelfPlayConfig


@dataclass(frozen=True)
class LoopConfig:
    preset: str = "brandubh"
    iterations: int = 10
    games_per_iteration: int = 64
    train_steps_per_iteration: int = 100
    train_batch_size: int = 256
    min_replay_size: int = 512
    replay_capacity: int = 200_000
    learning_rate: float = 2e-3
    channels: int = 64
    blocks: int = 6
    #: Trunk normalization: "group", "none" (norm-free NFResBlock) or
    #: "batch" (the squeeze-excitation residual net; see models/network.py).
    norm: str = "group"
    #: The SE unit's ratio of the "batch" trunk (channels / its hidden
    #: units); 0 with the other trunks.
    se_ratio: int = 0
    #: >0 enables arena gating: each iteration pits the freshly trained net
    #: against the incumbent best net over this many games, and self-play is
    #: generated by the INCUMBENT (AlphaGo-Zero-style best-net self-play) —
    #: the trained net only takes over data generation once it passes
    #: ``gate_threshold``. 0 disables gating; self-play then always uses the
    #: latest params (AlphaZero-style).
    arena_games: int = 0
    arena_sims: int = 64
    arena_max_game_len: int = 256
    #: Run the gating arena every N iterations (the incumbent generates
    #: self-play either way; a sparser cadence trades promotion latency for
    #: wall-clock). <= 0 disables the arena entirely, like ``arena_games=0``.
    arena_every: int = 4
    gate_threshold: float = 0.55
    #: What ``gate_threshold`` applies to: ``"score"`` (wins + half draws over
    #: all games), ``"decisive"`` (win rate over decisive games only — the
    #: draw-robust choice when most arena games are drawn), or ``"wilson"``
    #: (promote when the Wilson lower bound of the decisive win rate at
    #: ``gate_z`` clears ``gate_threshold`` — set the threshold to ~0.5 then;
    #: the statistically honest gate when decisive games are few).
    gate_on: str = "score"
    #: With ``gate_on="decisive"``: minimum decisive games required to
    #: promote (guards against promoting on one lucky decisive game).
    gate_min_decisive: int = 4
    #: One-sided normal quantile for ``gate_on="wilson"`` (1.0 ~ 84%
    #: confidence, 1.64 ~ 95%). The bound already shrinks with small decisive
    #: samples, so no separate min-decisive floor is needed.
    gate_z: float = 1.0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1
    #: Checkpoints retained on disk; raise it for learning-curve ladders
    #: over a long run's history.
    checkpoint_keep: int = 3
    seed: int = 0
    #: Apply a random D4 board/action symmetry to every training sample
    #: (core/symmetry.py) — 8x effective data from symmetric rulesets.
    augment_symmetry: bool = True
    mcts: MCTSConfig = field(default_factory=lambda: MCTSConfig(num_simulations=64))
    selfplay: SelfPlayConfig = field(default_factory=SelfPlayConfig)


def gate_passes(config: LoopConfig, result) -> bool:
    """Whether the arena ``result`` promotes the candidate under
    ``config.gate_on``."""
    if config.gate_on == "decisive":
        return (
            result.decisive_score >= config.gate_threshold
            and result.decisive_games >= config.gate_min_decisive
        )
    if config.gate_on == "wilson":
        return result.decisive_wilson_lb(config.gate_z) > config.gate_threshold
    if config.gate_on == "score":
        return result.score >= config.gate_threshold
    raise ValueError(f"unknown gate_on={config.gate_on!r}")


def augment_slice(generator, board, policy_idx, global_batch: int, rows: slice):
    """D4-transform this rank's ``rows`` of a global batch. The transforms
    are drawn for the whole global batch from the shared ``generator``, so
    every rank makes the same draw, and ranks that each hold their rows
    transform them as one process holding the whole batch would. In one
    process ``rows`` is the whole batch and the draw is
    :func:`random_symmetry_batch`'s own."""
    t = torch.randint(0, NUM_TRANSFORMS, (global_batch,), generator=generator, device=board.device)
    return random_symmetry_batch(None, board, policy_idx, transforms=t[rows])


def _rank_generator(generator: torch.Generator, rank: int, device) -> torch.Generator:
    """The rank's self-play generator, seeded from one draw of the shared
    generator and the rank (JAX's ``fold_in``): every rank makes the same
    draw, and each plays other games."""
    draw = int(torch.randint(0, 2**62, (1,), generator=generator, device=device))
    seed = int(np.random.SeedSequence([draw, rank]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def run_loop(
    env: TaflEnv,
    config: LoopConfig,
    log: Optional[MetricsLogger] = None,
    deadline: Optional[float] = None,
    replay: Optional[ReplayBuffer] = None,
) -> TrainState:
    """Run the full AlphaZero iteration cycle; returns the final TrainState.

    Inside a process group every rank calls it with the same ``config``.
    ``train_batch_size`` is the global batch and must divide across the
    ranks; each rank plays ``games_per_iteration // world`` games (at least
    one) at its actor's ``selfplay.batch_size``. The ranks stop together
    when any one of them is past its ``deadline``.
    """
    log = log or MetricsLogger()
    device = env.device
    rank, world_size = world()
    group = dist.group.WORLD if world_size > 1 else None
    rows = local_batch_slice(config.train_batch_size)  # raises on a remainder

    net = make_network(env.n, channels=config.channels, blocks=config.blocks, norm=config.norm,
                       se_ratio=config.se_ratio)
    train_state = init_train_state(
        net, torch.Generator().manual_seed(config.seed), device,
        learning_rate=config.learning_rate,
    )
    if group is not None:
        mesh.replicate(net, group)
    # One generator on the device, the same on every rank, draws
    # augmentation and arena randomness; its state is part of a checkpoint.
    # In one process it draws self-play's too. Across ranks each rank plays
    # its own games from a generator of its own (saved in its sidecar).
    generator = torch.Generator(device=device).manual_seed(config.seed)
    sp_generator = generator if group is None else _rank_generator(generator, rank, device)

    if replay is None:
        replay = ReplayBuffer(env, config.replay_capacity, config.selfplay.policy_k)
    build_batch = make_batch_builder(env)
    train_step = make_train_step(train_state, group)
    actor = SelfPlayActor(env, net, config.mcts, config.selfplay, device=device)
    games_local = max(1, config.games_per_iteration // world_size)
    np_rng = np.random.RandomState(config.seed + rank)

    ckpt = (
        CheckpointManager(config.checkpoint_dir, max_to_keep=config.checkpoint_keep, group=group)
        if config.checkpoint_dir
        else None
    )
    # arena_every <= 0 disables the arena, and with it gating: without an
    # arena there is no promotion path, so holding self-play on the frozen
    # incumbent would pin data generation to the init forever.
    gated = config.arena_games > 0 and config.arena_every > 0
    # A frozen copy, never an alias: the optimizer updates the net in place.
    # It only evaluates, in the inference mode it is copied in.
    incumbent = copy.deepcopy(net).requires_grad_(False)
    start_iter = 0
    if ckpt is not None and ckpt.latest_iteration() is not None:
        start_iter, train_state, rng_state, extra = ckpt.restore(
            train_state, replay, rank_generator=sp_generator
        )
        generator.set_state(rng_state)
        if group is not None:
            mesh.replicate(net, group)
        has_incumbent = "incumbent_params" in extra
        incumbent.load_state_dict(extra["incumbent_params"] if has_incumbent else net.state_dict())
        if gated and not has_incumbent:
            # Resuming a gated run from an ungated checkpoint: gating restarts
            # with the candidate as its own incumbent. Make that visible.
            log.scalar("resume/incumbent_missing", 1.0)
        start_iter += 1
        log.scalar("resume/iteration", start_iter)

    def save(it):
        extra = {"incumbent_params": incumbent.state_dict()} if gated else None
        ckpt.save(it, train_state, replay, generator, extra=extra, rank_generator=sp_generator)

    for it in range(start_iter, config.iterations):
        t0 = time.perf_counter()
        # With gating on, the incumbent best net generates the data; the
        # trained candidate must beat it in the arena to take over.
        actor.evaluate = incumbent if gated else net
        stats = actor.play(replay, sp_generator, games_local)
        sp_time = time.perf_counter() - t0
        for k, v in stats.as_dict().items():
            log.scalar(f"selfplay/{k}", v, step=it)
        log.scalar("selfplay/games_per_hour", stats.games / max(sp_time, 1e-9) * 3600, step=it)

        # Across ranks, gate on the SMALLEST replay: game lengths differ per
        # rank, and ranks that took different branches around the learner's
        # collective would deadlock. Every rank reaches this gather every
        # iteration.
        ready_size = replay.size
        if group is not None:
            ready_size = int(mesh.gather_ints([replay.size], group).min())
        ready = ready_size >= config.min_replay_size
        metrics = {}
        t1 = time.perf_counter()
        if ready:
            for _ in range(config.train_steps_per_iteration):
                s = replay.sample(np_rng, rows.stop - rows.start)
                board = torch.as_tensor(s.board, device=device)
                policy_idx = torch.as_tensor(s.policy_idx, device=device)
                if config.augment_symmetry:
                    board, policy_idx = augment_slice(
                        generator, board, policy_idx, config.train_batch_size, rows
                    )
                batch = build_batch(board, s.side, s.reps, policy_idx, s.policy_p, s.value)
                metrics = train_step(batch)
            for k, v in metrics.items():
                log.scalar(f"train/{k}", float(v), step=it)
        train_time = time.perf_counter() - t1

        if gated and ready and (it + 1) % config.arena_every == 0:
            # Same search regime as training (max_depth, cpuct, ...), only
            # noise-free and at the arena budget. Across ranks each rank
            # plays its slice of the games on identical nets with the shared
            # generator (the whole match when the ranks do not divide it),
            # and every rank gets the result of the whole match.
            arena_cfg = dataclasses.replace(
                config.mcts, num_simulations=config.arena_sims, dirichlet_eps=0.0
            )
            result = play_match(
                env, net, incumbent, arena_cfg,
                num_games=config.arena_games,
                max_game_len=config.arena_max_game_len,
                generator=generator,
                group=group,
            )
            for k, v in result.as_dict().items():
                log.scalar(f"arena/{k}", float(v), step=it)
            passed = gate_passes(config, result)
            if group is not None:
                # Every rank decided on the same gathered counts; ranks that
                # decided differently would split the incumbents without an
                # error: refuse to go on.
                votes = mesh.gather_ints([int(passed)], group)[:, 0]
                if (votes != votes[0]).any():
                    raise RuntimeError(f"iteration {it}: the ranks' gate decisions differ: {votes}")
            if config.gate_on == "wilson":
                log.scalar(
                    "arena/gate_wilson_lb", result.decisive_wilson_lb(config.gate_z), step=it
                )
            if passed:
                incumbent.load_state_dict(net.state_dict())
            log.scalar("arena/promoted", 1.0 if passed else 0.0, step=it)

        log.scalar("time/selfplay_s", sp_time, step=it)
        log.scalar("time/train_s", train_time, step=it)
        log.scalar("replay/size", replay.size, step=it)
        log.flush(step=it)

        saved = False
        if ckpt is not None and (it + 1) % config.checkpoint_every == 0:
            save(it)
            saved = True

        # Wall-clock budget: stop cleanly at an iteration boundary. Force a
        # checkpoint if the cadence didn't just write one — otherwise a
        # checkpoint_every > 1 run discards up to checkpoint_every - 1
        # iterations of work at every deadline stop. Across ranks the stop
        # is collective (any rank past its deadline stops all): a rank that
        # stopped alone would leave the others waiting in a collective.
        stop = deadline is not None and time.time() >= deadline
        if group is not None:
            stop = bool(mesh.gather_ints([int(stop)], group).any())
        if stop:
            if ckpt is not None and not saved:
                save(it)
            log.scalar("stop/deadline_reached", 1.0, step=it)
            log.flush(step=it)
            break

    return train_state
