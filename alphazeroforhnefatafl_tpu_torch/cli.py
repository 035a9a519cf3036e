"""Command-line interface of the PyTorch port.

``play`` is the successor of the reference's interactive demo loop: print
the board, prompt for a move like ``a8-a11``, apply it on the host oracle,
report the outcome; ``--ai`` adds an MCTS opponent. ``selfplay`` runs
self-play games with a randomly initialized net and prints the statistics as
JSON; ``train`` runs the AlphaZero loop and prints one JSON line of metrics
per iteration (``--gumbel`` selects Gumbel root selection); ``ladder`` plays
a round robin over the checkpoints of a run and prints their Elo ratings;
``bench`` runs the headline benchmark (:mod:`.bench`) and prints its JSON
line. Their flags are those of the JAX CLI plus ``--device``::

    python -m alphazeroforhnefatafl_tpu_torch.cli play --preset brandubh --ai defender
    python -m alphazeroforhnefatafl_tpu_torch.cli selfplay --preset copenhagen \\
        --channels 64 --blocks 6 --sims 128
    python -m alphazeroforhnefatafl_tpu_torch.cli train --preset copenhagen \\
        --channels 64 --blocks 6 --sims 64 --checkpoint-dir runs/cph/ckpt
    python -m alphazeroforhnefatafl_tpu_torch.cli ladder --preset copenhagen \\
        --ckpt runs/cph/ckpt
    python -m alphazeroforhnefatafl_tpu_torch.cli bench

``play``, ``selfplay``, ``train`` and ``ladder`` take the net's architecture
as ``--channels``, ``--blocks``, ``--norm`` (``group``, ``none`` or
``batch``) and ``--se-ratio`` (the SE unit of the ``batch`` trunk, 0 with
the others): Leela Chess Zero's SE net at AlphaZero's width is ``--channels
256 --blocks 20 --norm batch --se-ratio 8``.

All run on the CUDA card unless ``--cpu`` (or ``--device cpu``) is given,
and exit with an error when there is no card; ``play`` without ``--ai``
runs only the host oracle and needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _device(args):
    """The device the flags ask for; exits when it is a card and there is none."""
    import torch

    device = torch.device("cpu" if args.cpu else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available (use --device cpu)")
    return device


def _add_common(p):
    from .core.rules import PRESETS

    p.add_argument("--preset", default="brandubh", choices=sorted(PRESETS.keys()))
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--cpu", action="store_true", help="same as --device cpu")
    p.add_argument("--seed", type=int, default=0)


def _add_net(p, channels: int, blocks: int):
    from .models.network import NORMS

    p.add_argument("--channels", type=int, default=channels)
    p.add_argument("--blocks", type=int, default=blocks)
    p.add_argument("--norm", default="group", choices=NORMS)
    p.add_argument("--se-ratio", type=int, default=0,
                   help="SE unit ratio of --norm batch (channels / hidden units)")


def _net(args, env):
    """The flags' net, initialized from ``--seed`` on the CPU."""
    import torch

    from .models.network import init_params, make_network

    net = make_network(env.n, channels=args.channels, blocks=args.blocks, norm=args.norm,
                       se_ratio=args.se_ratio)
    return init_params(net, torch.Generator().manual_seed(args.seed))


def cmd_play(args):
    from .core import fen
    from .core.oracle import Game, InvalidPlayError, Play
    from .core.rules import PRESETS, Side

    rules, board = PRESETS[args.preset]
    game = Game(rules, board)
    mcts_side = None
    if args.ai is not None:
        mcts_side = Side.ATTACKER if args.ai == "attacker" else Side.DEFENDER
        ai = _make_ai(args)

    print(f"alphazeroforhnefatafl-tpu: {args.preset}")
    while True:
        print("Board:")
        print(fen.board_to_display_str(game.state.board))
        print(f"{game.state.side_to_play.name.title()} to play.")
        if mcts_side is not None and game.state.side_to_play == mcts_side:
            mv = ai(game)
            print(f"AI plays {mv}")
            outcome = game.do_play(mv)
        else:
            try:
                line = input("Please enter your move: ").strip()
            except EOFError:
                return
            if line in ("quit", "exit"):
                return
            if line == "undo":
                game.undo_last_play()
                continue
            try:
                play = Play.from_str(line)
            except Exception as e:
                print(f"Invalid move ({e}). Try again.")
                continue
            try:
                outcome = game.do_play(play)
            except InvalidPlayError as e:
                print(f"Invalid move ({e.reason.name}). Try again.")
                continue
        if outcome is not None:
            if outcome.winner is None:
                print(f"Game over. Draw ({outcome.draw_reason.name}).")
            else:
                print(
                    f"Game over. Winner is {outcome.winner.name.title()} "
                    f"({outcome.win_reason.name})."
                )
            print("Final board:")
            print(fen.board_to_display_str(game.state.board))
            return


def _make_ai(args):
    """An MCTS move chooser over the oracle game: the flags' net (32x3 by
    default) from ``--seed``, ``--sims`` simulations, no root noise, on the
    flags' device."""
    import torch

    from .core import actions as A
    from .core.env import TaflEnv
    from .core.oracle import Play
    from .core.rules import PRESETS
    from .search.mcts import MCTS, MCTSConfig

    device = _device(args)
    rules, board = PRESETS[args.preset]
    env = TaflEnv(rules, board, device)
    net = _net(args, env).to(device).eval()
    mcts = MCTS(env, net, MCTSConfig(num_simulations=args.sims, dirichlet_eps=0.0))

    def choose(game) -> Play:
        s = env.reset().replace(
            board=torch.as_tensor(game.state.board, dtype=torch.int8, device=device)[None],
            side_to_play=torch.full(
                (1,), int(game.state.side_to_play), dtype=torch.int32, device=device
            ),
        )
        legal = env.legal_mask_many(s)
        result = mcts.search(s, legal, add_noise=False)
        action = int(result.action_probs[0].argmax())
        src, dst = A.decode_to_tiles(env.n, action)
        return Play.from_tiles(src, dst)

    return choose


def cmd_selfplay(args):
    import torch

    from .core.env import make_env
    from .search.mcts import MCTSConfig
    from .train.replay import ReplayBuffer
    from .train.selfplay import SelfPlayActor, SelfPlayConfig

    device = _device(args)
    env = make_env(args.preset, device)
    net = _net(args, env).to(device).eval()
    sp_cfg = SelfPlayConfig(batch_size=args.batch)
    mcts_cfg = MCTSConfig(num_simulations=args.sims)
    actor = SelfPlayActor(env, net, mcts_cfg, sp_cfg, device=device)
    replay = ReplayBuffer(env, 100_000, sp_cfg.policy_k)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    stats = actor.play(replay, generator, args.games)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    d = stats.as_dict()
    d["wall_s"] = round(dt, 2)
    d["games_per_hour"] = round(stats.games / dt * 3600, 1)
    d["moves_per_s"] = round(actor.moves_played * args.batch / dt, 1)
    d["sims_per_s"] = round(actor.moves_played * args.batch * args.sims / dt, 1)
    d["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps(d, indent=2))


def cmd_train(args):
    from .core.env import make_env
    from .search.mcts import MCTSConfig
    from .train.loop import LoopConfig, run_loop
    from .train.selfplay import SelfPlayConfig

    env = make_env(args.preset, _device(args))
    cfg = LoopConfig(
        preset=args.preset,
        iterations=args.iterations,
        games_per_iteration=args.games,
        train_steps_per_iteration=args.train_steps,
        train_batch_size=args.batch,
        min_replay_size=args.min_replay,
        channels=args.channels,
        blocks=args.blocks,
        norm=args.norm,
        se_ratio=args.se_ratio,
        arena_games=args.arena_games,
        checkpoint_dir=args.checkpoint_dir,
        seed=args.seed,
        mcts=MCTSConfig(
            num_simulations=args.sims,
            root_selection="gumbel" if args.gumbel else "puct",
            dirichlet_alpha_scale=args.alpha_scale,
        ),
        selfplay=SelfPlayConfig(batch_size=args.selfplay_batch),
    )
    run_loop(env, cfg)


def cmd_ladder(args):
    """Round-robin the checkpoints in a run directory and fit Elo ratings."""
    import torch

    from .core.env import make_env
    from .models.network import make_network
    from .search.mcts import MCTSConfig
    from .train.arena import ladder
    from .train.checkpoint import CheckpointManager
    from .train.learner import init_train_state

    device = _device(args)
    env = make_env(args.preset, device)

    def fresh_state():
        net = make_network(env.n, channels=args.channels, blocks=args.blocks, norm=args.norm,
                           se_ratio=args.se_ratio)
        return init_train_state(net, torch.Generator().manual_seed(args.seed), device)

    mgr = CheckpointManager(args.ckpt)
    named = [("init", fresh_state().net.eval())]
    for it in mgr.all_iterations():
        state = fresh_state()
        mgr.restore(state, None, iteration=it)  # the replay ring is not read
        named.append((f"iter{it}", state.net.eval()))
    ratings, _, _ = ladder(
        env,
        named,
        MCTSConfig(num_simulations=args.sims, max_children=32, dirichlet_eps=0.0),
        games_per_pair=args.games,
        generator=torch.Generator(device=device).manual_seed(args.seed),
    )
    print(json.dumps({"ratings": ratings}, indent=2))


def cmd_bench(args):
    """The headline benchmark (:mod:`.bench`): 11x11 Copenhagen at fixed
    sizes whatever ``--preset`` says, as in the JAX CLI."""
    from .bench import run_bench

    print(json.dumps(run_bench(_device(args), args.seed)), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="alphazeroforhnefatafl_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("play", help="interactive game (reference demo successor)")
    _add_common(p)
    p.add_argument("--ai", choices=["attacker", "defender"], default=None)
    p.add_argument("--sims", type=int, default=64)
    _add_net(p, 32, 3)
    p.set_defaults(fn=cmd_play)

    p = sub.add_parser("selfplay", help="run self-play games")
    _add_common(p)
    p.add_argument("--games", type=int, default=8)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--sims", type=int, default=32)
    _add_net(p, 32, 3)
    p.set_defaults(fn=cmd_selfplay)

    p = sub.add_parser("train", help="run the AlphaZero loop")
    _add_common(p)
    p.add_argument("--iterations", type=int, default=3)
    p.add_argument("--games", type=int, default=16)
    p.add_argument("--train-steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--min-replay", type=int, default=256)
    p.add_argument("--sims", type=int, default=32)
    p.add_argument("--selfplay-batch", type=int, default=8)
    _add_net(p, 32, 3)
    p.add_argument("--arena-games", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--gumbel", action="store_true",
                   help="gumbel sequential-halving root selection")
    p.add_argument("--alpha-scale", type=float, default=None,
                   help="dirichlet alpha = scale / num_legal_moves")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("ladder", help="Elo ladder over a run's checkpoints")
    _add_common(p)
    p.add_argument("--ckpt", required=True, help="checkpoint directory of a run")
    p.add_argument("--games", type=int, default=16)
    p.add_argument("--sims", type=int, default=64)
    _add_net(p, 64, 6)
    p.set_defaults(fn=cmd_ladder)

    p = sub.add_parser("bench", help="run the headline benchmark")
    _add_common(p)
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
