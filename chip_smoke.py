#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``alphazeroforhnefatafl_tpu_torch``) on one
CUDA card.

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``alphazeroforhnefatafl_tpu_torch/csrc``;
3. kernel 1 (legal mask) against its plain PyTorch version on the card,
   bit for bit: Copenhagen playout states and dense random boards at
   B=4096 and at B=64 (the arena's batch), playout states at B=512 and
   B=1024 (the batches of a two- and a four-leaf wave of 256 games), at
   B=2048 (the bench's two-leaf wave of 1024 games; its serial wave is
   B=1024 and its four-leaf wave B=4096) and at B=32 (half an arena batch,
   what a config match searches), every preset
   at B=256 (the self-play and learner batch), and 15x15 and 21x21 board
   batches; then
   the cases that a kernel serving a group of games per CTA makes risky:
   batches that the group does not divide (B = 1, 3, 257, odd batches of
   the 7x7 and 9x9 presets), 19x19 boards (whose groups of three start off
   a 16-byte boundary), games with no legal move, boards full of one side's
   pieces, and constructed shieldwalls, enclosures, exit forts and king
   captures beside the throne (``tests/test_torch_cases.py``) on every
   preset and on 15x15, 19x19 and 21x21 boards;
4. kernel 2 (env step) against its plain version on the same inputs (the
   bench's B=2048 wave among them), field for field over every output, the
   24 scalar rows included, and both kernels again on every card the
   process sees, one card after the other (each kernel raises its
   shared-memory limit per device; one card shows nothing), and on each
   card k >= 1 once more on tensors of ``cuda:k`` with the current device
   left at 0, which it must still be after (the wrappers enter the
   tensor's device around the launch); then the time
   of each kernel beside its plain version at the self-play shapes, with
   the least time the card could take for the same bytes (each input read
   once, each output written once, at 3.35 TB/s) and the share of that
   bound the kernel reaches, at B=256, B=512 (a two-leaf wave) and B=4096;
   B=1 is timed too, as what a launch of either kernel costs with next to
   no work in it; then the GroupNorm epilogue kernel (``csrc/group_norm.cu``)
   alone at the flagship width (64 channels, 11x11) and 512, 1,024 and
   4,096 rows, with and without the skip: within 2 bf16 ulps of PyTorch's
   chain on the card and 1 ulp of exact math rounded once (as
   ``ops.group_norm.group_norm_ulps`` counts them), its time on the card
   beside its byte bound and beside the chain's (``library_ms``, which the
   port does not call on this path), its launch counter exact; and the
   flagship bf16 net at 1,024 rows, which must launch it 14 times a forward
   with no plain call under ``inference_mode`` and take the plain chain at
   all 14 sites with grad on, one line ``{"group_norm": {...}}``; then the
   SE net's two kernels (``csrc/se_block.cu``) alone at 256 channels on
   11x11 and 512, 1,024 and 4,096 rows, within 1 bf16 ulp of exact math
   rounded once (``ops.se_block.ulps_from_exact``), timed beside their byte
   bounds and PyTorch's chains; the 20x256 SE net (ratio 8, bf16 trunk)
   through ``make_network`` against its float32 reference
   (``models/se_reference.py``) at 1,024 rows, its logits within
   ``SE_LOGIT_TOL`` and its values within 5 times the gap of the reference
   with a bf16 trunk, which an fp8 trunk must fail; 20 SE and 22 norm
   launches a forward under ``inference_mode`` and no plain site, every
   site on the chain in training mode with grad on; self-play, the arena
   and ``cli play`` with it, counted a forward; one line
   ``{"se_block": {...}}``;
5. self-play at full width: 11x11 Copenhagen, a 64-channel 6-block
   GroupNorm net with a bf16 trunk and random weights from a seed,
   ``MCTSConfig()`` (128 simulations, 128 children), 256 games of at most 8
   moves in a batch of 256. Every search must give each game 128 root
   visits, and the launches must be exactly one of kernel 1 and 129 of
   kernel 2 a move;
6. the learner check: the same 64x6 float32 net and the same batch (built
   from phase 5's replay) take one train step on the card and on the CPU
   with TF32 off; loss and ``grad_norm`` agree within 1e-4. The batch
   builder's legal mask on the card (kernel 1) equals the plain version's
   bit for bit, and every policy-target row sums to 1;
7. training at full width: 30 learner steps of the 64x6 bf16 net at batch
   256 with D4 augmentation from phase 5's replay, through
   ``make_batch_builder`` and ``make_train_step``. Every loss is finite,
   the parameters move, the loss on a held batch falls, and kernel 1 is
   launched exactly once per step. Prints the milliseconds of a step, split
   into sample + copy, augment + build and forward + backward + optimizer,
   and from a ``torch.profiler`` window over five more steps the card's
   busy time, the window's wall time and the launches per step;
8. the loop through its entry point: ``run_loop`` for two gated iterations
   (256 self-play games, 20 learner steps, a 64-game arena of 8 plies at 64
   simulations a move, a checkpoint each), then a second call that must
   resume at iteration 2 from the checkpoint. The launches are counted
   where they are made: around every arena match (kernel 1 once and kernel
   2 65 times a ply) and around every batch the learner builds (kernel 1
   once); the rest is self-play's;
9. multi-leaf self-play at full width: phase 5 again with
   ``MCTSConfig(leaves_per_wave=2)`` and with ``leaves_per_wave=4``, then
   the serial search once more: 4 moves each, 128 root visits for every
   game, kernel 1 once a move and kernel 2 exactly ``128 / L + 1`` times a
   move, at a batch of ``256 * L``. One line sets the moves per second,
   the seconds a move and the host seconds inside the tree traversals of
   the serial, two-leaf and four-leaf searches side by side. Then the
   three move in turns, one batched move each for three rounds after a warm
   one, and their median seconds a move are set side by side: a host that
   slows down through a run slows all three alike there;
10. Gumbel self-play at full width: ``root_selection="gumbel"``, 128
   simulations, 4 moves: every ``best_action`` legal, every row of
   ``action_probs`` sums to 1 with no mass on an illegal action, 129
   launches of kernel 2 a move;
11. what judges a run: ``play_config_match`` of the two-leaf search against
   the serial one with one net (64 games, 64 simulations, 4 plies: a ply
   launches kernel 1 twice at B=32 and kernel 2 ``64 + 32 + 1`` times), and
   a ``ladder`` over the net and the ``uniform`` and ``random`` anchors (16
   games a pair, 32 simulations, 4 plies: three matches, a ply launches
   kernel 1 once and kernel 2 33 times; finite ratings, the first 0);
12. the bench through its entry point, in process: ``bench.run_bench`` on
   the card (4096 games, rollouts of 32 steps, 8 timed windows of 8
   rollouts after a warm one; then MCTS at B=1024: 128 simulations at two
   leaves a wave, 800 at four, 128 serial). The launches are exact: the
   rollouts launch kernel 1 twice (the first mask and the fresh games'
   mask) and kernel 2 ``32 x (1 + 8 x 8)`` times; the searches kernel 1
   once a configuration and kernel 2 ``(sims / L) x (1 + timed searches)``
   times each. The mask the last rollout carries equals kernel 1's (and
   the plain version's) mask of the state it carries, bit for bit; the
   bench line has every key, every rate above 0, and is printed on a line
   of its own;
13. ``cli play --ai attacker`` on the card (Brandubh, 64 simulations): the
   AI opens, one scripted human move, the AI's reply, ``quit``; both AI
   moves are legal under the port's oracle, and each launched kernel 1
   once and kernel 2 64 times;
14. seeded determinism at full width: 256 Copenhagen games with the
   flagship net, root noise and temperature sampling on, under the flagship
   run's search (128 simulations, 32 children, recall 0.9, alpha 10 / legal
   moves) at two leaves a wave for 8 moves, then serial for 4. Each runs
   with seed 0 twice and seed 1 once: the two runs of seed 0 must give
   bit-identical replay arrays and equal stats, seed 1 other boards;
15. ``scripts.profile_wave`` then ``scripts.analyze_trace`` through their
   ``main(argv)``: one serial search of 1024 games, 800 simulations, 128
   children, traced with ``torch.profiler``. The trace must hold exactly
   one step-kernel event a wave; one line ``{"profile_wave": {...}}`` gives
   the search's seconds, the card's time by op family, its busy share of
   the search's host window (the union of the device events), and the
   trace's size and export seconds;
16. the run drivers through their ``main(argv)`` in a temporary working
   directory: ``train_run`` with the flags of the flagship run's last
   record (64x6 net, 512 games a batch, L=2, recall 0.9, resignation, a
   Wilson gate, a 64-game arena, ``--search-chunk 32``, whose notice must
   print) cut in depth only (2 iterations, games and arena games of 12
   plies, 10 learner steps, a checkpoint each, a 16,384-position ring);
   ``summarize_run`` on its log; ``eval_run`` over its checkpoints with
   three anchors, whose ``iter`` entries must hold their own checkpoints'
   parameters; ``cross_ladder`` with ``latest`` and ``mid`` entries (both
   2 games a pair, 16 simulations, 6 plies); ``search_ab`` (L=2, recall 0.9
   against serial, 64 games, 128 simulations, 6 plies); ``bench_mcts`` at
   B=1024 (128 simulations, L=2, exactly one mask and 192 step launches);
17. two ranks of ``run_loop`` on the one card ``cuda:0``, joined by
   ``torch.distributed`` over gloo (NCCL refuses two ranks on one card):
   each rank is given ``device="cuda:0"``, which ``initialize_distributed``
   answers with gloo on a host of any number of cards, and the phase fails
   unless every rank reports ``cuda:0`` and gloo. The ranks are started
   with the ``spawn`` method under a deadline (a rank that hangs ends the
   phase, naming each rank's last stage) and meet in a ``FileStore``: the
   flagship net and
   the flagship record's search (128 simulations, 32 children, L=2, recall
   0.9), 256 games a rank of 8 plies in a batch of 256, 10 learner steps
   at a global batch of 256 (128 a rank), a 64-game Wilson-gated arena of 8
   plies at 64 simulations, a checkpoint each iteration, two iterations and
   a resumed third that restores each rank's own replay sidecar. Each rank
   first holds one float32 step on its half of a batch against one step on
   the whole batch (loss metrics within 1e-4 relative, the gradient within
   1e-4); the ranks' parameter digests are gathered and compared after every
   learner step; the replays must differ, the arenas agree, and each rank's
   launches split exactly into self-play moves (1 mask, 65 steps), arena
   plies (1 mask, 33 steps) and learner steps (1 mask). The arena is split:
   each rank plays 32 of the 64 games, so a ply launches kernel 1 at B=32
   and kernel 2 32 times at 64 rows (two leaves a wave) and once at 32;
   world 1 launches them at 64 and 128. Then the split equals the whole:
   each rank plays its 32 games of a 64-game Brandubh match (8 simulations,
   L=2, at most 80 plies) between two nets that are elementwise functions
   of each game's observation, and the same match is played whole in this
   process; every game's result, the counts and the tie-break generator's
   state must be equal, the fallback rate within 1e-6 relative, and the
   launches by batch exact. One iteration at
   world 1 of the same configuration runs before and after the ranks; one
   line ``{"multirank": {...}}`` sets world 1 beside world 2 (self-play
   positions/s summed over the ranks, seconds by part, a rank's arena
   seconds beside world 1's, the per-ply gathers' ms, the all-reduce's ms
   a step). Then ``dryrun_multichip(2, device="cuda:0")``, its ranks held
   to ``cuda:0`` and gloo too;
18. where the process sees W >= 2 cards: the loop across them, one rank a
   card, over NCCL. Each rank is bound to ``cuda:r`` by
   ``initialize_distributed(device="cuda")``, which must choose nccl by
   itself. ``dryrun_multichip(W)`` (every rank on ``cuda:r`` over nccl,
   equal parameter digests, other replays); phase 17's ``run_loop`` with
   every check generalised to W ranks (one step on 1/W of a batch against
   the whole, digests compared after every learner step, the arena split
   64/W games a rank with its launches by batch exact: at W=4 kernel 1 at
   16 and kernel 2 at 32 rows a wave and 16 a move), between a world-1
   iteration on ``cuda:0`` before and one after; the 64-game Brandubh match
   split W ways across the cards against the same match played whole on
   ``cuda:0`` (every game, the counts, the generator's state); then
   ``python -m torch.distributed.run --standalone --nproc-per-node W -m
   alphazeroforhnefatafl_tpu_torch.scripts.train_run`` with phase 16's
   flags in a subprocess under a deadline (exit code 0, ``metrics.jsonl``
   and each ``metrics.rank{r}.jsonl``, every rank on ``cuda:r`` over nccl).
   One line ``{"across_cards": {...}}`` holds every card's name and power
   limit, W and the backend, self-play positions/s summed over the ranks
   beside world 1's, a rank's arena seconds beside world 1's, the per-ply
   gather's ms and its share of each rank's arena, and the all-reduce's ms
   a step;
19. whole games: ``train_run`` through its ``main(argv)`` with the flags of
   the flagship record's last line (64x6 GroupNorm net with its bf16 trunk,
   games of 256 plies and arena games of 300, the temperature switch at
   move 12, resignation at 0.97 from move 30, 32 children, L=2, recall 0.9,
   alpha 10 / legal moves, a Wilson gate that needs 4 decisive games, a
   minimum replay of 4,096), cut in simulations and counts only
   (:data:`WHOLE_GAME_CUTS`: one iteration, 256 games at a batch of 256,
   self-play at 32 simulations and the arena at 16, 20 learner steps at
   batch 512, a ring of 40,960), every game played to its end. A
   :class:`GameRecorder` keeps on the host every move-level env step of
   self-play and the arena, one wave's leaf step a self-play move, the
   restarts, the replay's writes and samples and the learner's metrics.
   The phase fails unless (a) every game ends by a rule, by resignation or
   at its cap, rows restart mid-batch, and one self-play game is decided;
   (b) the port's oracle replays every self-play and arena game from the
   start FEN, every action legal, to the env's positions, result, reason
   and repetition counts; (c) both kernels equal their plain versions bit
   for bit on every recorded step from move 100 on, ended arena games
   among them (which must stay unchanged and set ``info.invalid``), and on
   every sampled wave; (d) the value targets are each game's outcome for
   its movers (a resigned game lost by the resigner, 0 for a truncated
   one), the ring wrapped, and every learner sample is the newest position
   of its slot; (e) every loss is finite, the value loss above 0, and the
   learner's batches hold decided (+1 or -1) value targets; (f)
   the arena reached 4 decisive games and the loop's promotion equals
   ``gate_passes``; (g) the launches by batch are exact. Where the record's
   threshold fired no resignation, 64 games more at the same width and
   length resign at a threshold taken from the run's root values. One line
   ``{"whole_games": {...}}`` holds the games, their average length and how
   they ended, self-play seconds and positions/s beside phase 5's, the
   arena's seconds, plies, decisive games and gate decision, the
   resignation run, and ``torch.profiler``'s busy share of one self-play
   move after move 100 with the two kernels' share of its card time.

The launch counters (the two tafl kernels', the GroupNorm kernel's, and
``norm_act.plain_calls``, the net's GroupNorm sites that took PyTorch's
chain on the card) are set to 0 before each of the phases 5 and 7 to 19
(each driver of phase 16, each rank and world-1 run of phases 17 and 18,
each split match, and phase 19's iteration and resignation run) and read
after it. Self-play (phases 5, 9 and 15, and 19's), the loop's and phase
19's arenas launch the GroupNorm kernel 14 times a forward of the net at
each forward's rows with no plain site, the learner never (every site of
its forward takes the chain, as grad is on); config match, ladder, the
bench's searches, play and profile_wave launch it and take no plain site.
The second-to-last line is
``{"kernels": [...]}``, whose ``launches`` sum those phases and whose
``launches_by_path`` split them into self-play, learner, arena, multi-leaf
self-play, Gumbel self-play, config match, ladder, the bench's rollouts and
searches, play, determinism, profile_wave, each run driver, the two ranks'
loop (``multirank``) and its world-1 runs, the split match over the
ranks and whole (``split_match``, ``split_match_world1``) and, where
phase 18 ran, the same four across the cards (``across_cards``,
``across_cards_world1``, ``across_cards_split_match``,
``across_cards_split_match_world1``; the ``torchrun`` ranks' launches are
their processes' own and are not counted), and phase 19's
(``whole_games``, ``whole_games_resign``); the GroupNorm kernel's entry
adds ``plain_calls_by_path`` and its phase 4 times at 1,024 rows; the SE
net's two kernels (``se_block``, ``bn_relu``) give the same for phase 4's
SE paths (the net's check, its learner's forward, self-play, the arena
and play). The last line is ``{"ok": true, "device": {...}}``. Run it from
the repository root::

    python3 chip_smoke.py

On a host with several cards, ``python3 chip_smoke.py --every-card`` builds
the kernels and runs only the every-card check of phase 4 over all of them,
and ``python3 chip_smoke.py --across-cards`` the build, that check and
phase 18; it fails on fewer than two cards.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 0
PRESETS = ("brandubh", "copenhagen", "koch", "magpie", "tablut")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    from alphazeroforhnefatafl_tpu_torch.bench import card_line as query

    try:
        return query()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi failed: {e}")


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


def phase_every_card(checker):
    """Both kernels on every card this process sees, one card after the
    other, each held against its plain version there: Copenhagen playouts
    at B=256, and dense 21x21 boards at B=64 with either side to move. Four
    21x21 games stage 141,152 bytes of mask, more than the 48 KB of shared
    memory a kernel gets unless its limit is raised (every preset stages
    less). The limit is raised per device, so a launch on a card where it
    was not raised would fail: only a process on two or more cards can show
    that. Each card k >= 1 is checked twice: once as the current device,
    and once on tensors of ``cuda:k`` with the current device left at 0 (the
    wrappers enter the tensor's device around the launch), which must still
    be 0 after. Returns the cards."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.core.env import TaflEnv, make_env

    rng = np.random.RandomState(SEED)
    cards = torch.cuda.device_count()

    def cases(device, what):
        gen = torch.Generator(device=device).manual_seed(SEED)
        cph = make_env("copenhagen", device)
        playout_states(cph, 256, 4, gen, checker, f"{what} copenhagen")
        env = TaflEnv(cph.rules, "/".join(["21"] * 21), device)
        boards = torch.as_tensor(dense_boards(rng, 21, 64), device=device)
        for side in (0, 1):
            states = env.reset_batch(64).replace(
                board=boards,
                side_to_play=torch.full((64,), side, dtype=torch.int32, device=device))
            actions = random_actions(env.legal_mask_many(states), gen)
            checker.check(env, states, actions, f"{what} 21x21 side {side}")

    for i in range(cards):
        device = torch.device("cuda", i)
        with torch.cuda.device(device):
            cases(device, f"card {i}")
    torch.cuda.set_device(0)
    for i in range(1, cards):
        cases(torch.device("cuda", i), f"card {i} from current device 0")
        torch.cuda.synchronize(i)
        if torch.cuda.current_device() != 0:
            fail(f"the wrappers on cuda:{i} left the current device at "
                 f"{torch.cuda.current_device()}, not 0")
    print(f"every card: both kernels bit-exact on each of {cards} card(s) in one process"
          + (f", cards 1-{cards - 1} also from current device 0" if cards > 1 else ""),
          flush=True)
    return cards


def phase_kernels(device, checker):
    import torch

    from alphazeroforhnefatafl_tpu_torch.core.env import TaflEnv, make_env

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cases import constructed_cases

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
    # The arena's batch: 64 games, 16 plies.
    playout_states(cph, 64, 16, gen, checker, "copenhagen B=64 playout")
    dense_case(cph, 64, "copenhagen B=64 dense")
    # A wave of two and of four leaves for each of 256 games, the bench's
    # two-leaf wave of 1024 games (B=2048; its serial wave is B=1024, its
    # four-leaf wave B=4096), and half an arena batch (a config match
    # searches each half on its own).
    for B, plies in ((512, 12), (1024, 12), (2048, 12), (32, 16)):
        playout_states(cph, B, plies, gen, checker, f"copenhagen B={B} playout")
        dense_case(cph, B, f"copenhagen B={B} dense")
    for preset in PRESETS:
        env = make_env(preset, device)
        playout_states(env, 256, 24, gen, checker, f"{preset} B=256 playout")
        dense_case(env, 256, f"{preset} B=256 dense")
    big = {}
    for n in (15, 21):
        # Copenhagen rules on an n x n board (the start board is empty; the
        # dense boards replace it).
        big[n] = env = TaflEnv(cph.rules, "/".join([str(n)] * n), device)
        dense_case(env, 256, f"copenhagen rules {n}x{n}")

    # Batches that the group of four games per CTA does not divide.
    for B in (1, 3, 257):
        playout_states(cph, B, 6, gen, checker, f"copenhagen B={B} playout")
        dense_case(cph, B, f"copenhagen B={B} dense")
    for preset, B in (("brandubh", 255), ("tablut", 129)):
        env = make_env(preset, device)
        playout_states(env, B, 6, gen, checker, f"{preset} B={B} playout")
        dense_case(env, B, f"{preset} B={B} dense")
    dense_case(big[15], 5, "copenhagen rules 15x15 B=5")
    dense_case(big[21], 3, "copenhagen rules 21x21 B=3")
    # At 19x19 three games fit a CTA's staging memory and their masks span a
    # number of bytes that 16 does not divide: every other CTA's span starts
    # 8 bytes off a 16-byte boundary and its head leaves byte by byte.
    big[19] = TaflEnv(cph.rules, "/".join(["19"] * 19), device)
    dense_case(big[19], 64, "copenhagen rules 19x19 B=64")
    dense_case(big[19], 7, "copenhagen rules 19x19 B=7")

    def board_case(env, boards, what):
        """The same boards with either side to move."""
        B = boards.shape[0]
        for side in (0, 1):
            states = env.reset_batch(B).replace(
                board=torch.as_tensor(boards, device=device),
                side_to_play=torch.full((B,), side, dtype=torch.int32, device=device),
            )
            actions = random_actions(env.legal_mask_many(states), gen)
            checker.check(env, states, actions, f"{what} side {side}")

    # No legal move for either side (a checkerboard of the two sides), and
    # boards full of one side's pieces.
    for env in (cph, make_env("brandubh", device), big[21]):
        n = env.n
        rr, cc = np.indices((n, n))
        checker_board = np.where((rr + cc) % 2 == 0, 1, 2).astype(np.int8)
        board_case(env, np.repeat(checker_board[None], 7, 0), f"{n}x{n} no legal move")
        for code in (1, 2):
            board_case(env, np.full((7, n, n), code, np.int8), f"{n}x{n} full of {code}")

    # Constructed shieldwalls, enclosures, exit forts and king captures.
    def constructed(env, B, what):
        boards, sides, actions = constructed_cases(rng, env.n, B)
        states = env.reset_batch(B).replace(
            board=torch.as_tensor(boards, device=device),
            side_to_play=torch.as_tensor(sides, device=device),
        )
        checker.check(env, states, torch.as_tensor(actions, device=device), what)

    for preset in PRESETS:
        constructed(make_env(preset, device), 1001, f"{preset} constructed B=1001")
    for n in (15, 19, 21):
        constructed(big[n], 251, f"copenhagen rules {n}x{n} constructed")
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


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def timing_case(env, B, gen, checker):
    """Copenhagen playout states at batch B: each kernel's and its plain
    version's call, and the bytes each must move (every input read once,
    every output written once; the rule table is not counted)."""
    from alphazeroforhnefatafl_tpu_torch.ops.legal_mask import batched_legal_mask, legal_mask_plain
    from alphazeroforhnefatafl_tpu_torch.ops.step_kernel import step_arrays, step_plain

    s = playout_states(env, B, 16, gen, checker, f"timing states B={B}")
    actions = random_actions(env.legal_mask_many(s), gen)
    mask_in = (s.board, s.side_to_play)
    step_in = (s.board, s.side_to_play, actions, s.recent_plays, s.rep_first_i,
               s.reps, s.mid_pair, s.plays_since_capture)
    kernel = {
        "legal_mask": lambda: batched_legal_mask(env, *mask_in),
        "step": lambda: step_arrays(env, *step_in),
    }
    plain = {
        "legal_mask": lambda: legal_mask_plain(env, *mask_in),
        "step": lambda: step_plain(env, *step_in),
    }
    nbytes = {
        "legal_mask": tensor_bytes(mask_in) + tensor_bytes([kernel["legal_mask"]()]),
        "step": tensor_bytes(step_in) + tensor_bytes(kernel["step"]()),
    }
    return kernel, plain, nbytes


def phase_timing(device, checker, card):
    """Kernel and plain times at the self-play shapes (Copenhagen playout
    states at B=256, the self-play batch, B=512, a two-leaf wave of it, and
    B=4096), each kernel beside
    the bound its bytes set; and at B=1, where the card's time is what a
    launch of the kernel costs with next to no work in it."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.core.env import make_env

    env = make_env("copenhagen", device)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    times = {}
    for B in (1, 256, 512, 4096):
        kernel, plain, nbytes = timing_case(env, B, gen, checker)
        times[B] = {}
        for k in kernel:
            ms, plain_ms = time_ms(kernel[k]), time_ms(plain[k])
            dev_ms = time_ms(kernel[k], device_only=True)
            bound_ms = nbytes[k] / HBM_BYTES_PER_S * 1e3
            times[B][k] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bytes=nbytes[k])
            print(f"time copenhagen B={B} {k} on {card}: kernel {ms:.4f} ms per call "
                  f"({dev_ms:.4f} ms of it on the card), plain {plain_ms:.4f} ms; "
                  f"bound {nbytes[k]} bytes / 3.35 TB/s = {bound_ms:.5f} ms, "
                  f"{100 * bound_ms / dev_ms:.1f}% of it reached", flush=True)
    return times


def phase_group_norm(device, card, rows=(512, 1024, 4096), net_rows=1024):
    """The GroupNorm epilogue kernel against PyTorch's chain and exact math
    on the card, its time beside its byte bound and the chain's, its
    launches exact; then the flagship bf16 net's sites."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.models.network import (
        GN_EPS, init_params, make_network, norm_act,
    )
    from alphazeroforhnefatafl_tpu_torch.ops.group_norm import (
        GROUPS, group_norm_act, group_norm_act_plain, group_norm_ulps,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    C, n = 64, 11

    def nhwc(R):
        x = torch.randn(R, n, n, C, generator=gen, device=device)
        return x.to(torch.bfloat16).permute(0, 3, 1, 2)

    weight = 1 + 0.5 * torch.randn(C, generator=gen, device=device)
    bias = 0.5 * torch.randn(C, generator=gen, device=device)
    calls = 0

    def kernel_call(x, skip):
        nonlocal calls
        calls += 1
        return group_norm_act(x, weight, bias, GN_EPS, skip)

    launches0 = group_norm_act.launches
    cases = []
    for R in rows:
        x, skip_t = nhwc(R), nhwc(R)
        for skip in (None, skip_t):
            what = f"group_norm R={R} {'skip' if skip is not None else 'no skip'}"
            got = kernel_call(x, skip)
            if not got.is_contiguous(memory_format=torch.channels_last):
                fail(f"{what}: the output is not channels-last")
            exact_ulps, chain_ulps = group_norm_ulps(got, x, weight, bias, GN_EPS, skip)
            if exact_ulps > 1 or chain_ulps > 2:
                fail(f"{what}: {exact_ulps} ulps from exact math, {chain_ulps} from the chain")
            ms = time_ms(lambda: kernel_call(x, skip))
            dev_ms = time_ms(lambda: kernel_call(x, skip), device_only=True)
            library_ms = time_ms(
                lambda: group_norm_act_plain(x, GROUPS, weight, bias, GN_EPS, skip),
                device_only=True)
            nbytes = R * n * n * C * 2 * (2 if skip is None else 3)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            cases.append(dict(rows=R, skip=skip is not None, ms=ms, device_ms=dev_ms,
                              library_ms=library_ms, bound_ms=bound_ms, bytes=nbytes,
                              chain_ulps=chain_ulps, exact_ulps=exact_ulps))
            print(f"time {what} on {card}: kernel {ms:.4f} ms per call ({dev_ms:.4f} ms of it "
                  f"on the card), PyTorch's chain {library_ms:.4f} ms on the card; bound "
                  f"{nbytes} bytes / 3.35 TB/s = {bound_ms:.5f} ms, "
                  f"{100 * bound_ms / dev_ms:.1f}% of it reached; {chain_ulps:.2f} ulps from "
                  f"the chain", flush=True)
    if group_norm_act.launches - launches0 != calls:
        fail(f"group_norm launches {group_norm_act.launches - launches0}, calls {calls}")

    # The flagship net's 14 sites: the kernel under inference_mode, the
    # plain chain with grad on.
    env = make_env("copenhagen", device)
    net = make_network(env.n, channels=C, blocks=6, dtype=torch.bfloat16)
    net = init_params(net, torch.Generator().manual_seed(SEED)).to(device)
    boards = dense_boards(np.random.RandomState(SEED), env.n, net_rows)
    obs = env.observe(env.reset_batch(net_rows).replace(board=torch.as_tensor(boards, device=device)))
    sites = {}
    for mode, ctx in (("kernel", torch.inference_mode()), ("plain", torch.enable_grad())):
        launches, plain = group_norm_act.launches, norm_act.plain_calls
        batches = dict(group_norm_act.batches)
        with ctx:
            out = net(obs)
        torch.cuda.synchronize()
        sites[mode] = dict(out=[t.detach().float() for t in out],
                           launches=group_norm_act.launches - launches,
                           plain_calls=norm_act.plain_calls - plain,
                           at_rows=group_norm_act.batches.get(net_rows, 0)
                           - batches.get(net_rows, 0))
    want = {"kernel": (SITES, 0, SITES), "plain": (0, SITES, 0)}
    for mode, (launches, plain, at_rows) in want.items():
        got = sites[mode]
        if (got["launches"], got["plain_calls"], got["at_rows"]) != (launches, plain, at_rows):
            fail(f"group_norm net {mode}: {got['launches']} launches ({got['at_rows']} at "
                 f"{net_rows} rows), {got['plain_calls']} plain calls; want {launches}, {plain}")
    gaps = [float((k - p).abs().max())
            for k, p in zip(sites["kernel"]["out"], sites["plain"]["out"])]
    if not gaps[0] < 0.20:  # the cell's logit_gap limit
        fail(f"group_norm net: logits {gaps[0]} from the plain chain's")
    line = {"card": card, "launches": group_norm_act.launches - launches0, "cases": cases,
            "net": {"launches_a_forward": sites["kernel"]["launches"],
                    "plain_calls_a_forward": sites["kernel"]["plain_calls"],
                    "plain_calls_with_grad": sites["plain"]["plain_calls"],
                    "launches_with_grad": sites["plain"]["launches"],
                    "logit_gap": gaps[0], "value_gap": gaps[1]}}
    print(json.dumps({"group_norm": line}), flush=True)
    return line


SE_WIDTHS = dict(channels=256, blocks=20, norm="batch", se_ratio=8)  # the cell's net
SE_SITES, BN_SITES = 20, 22  # SE kernel and norm kernel launches a forward of it
#: The SE net's largest logit gap from its float32 reference over 1,024 rows
#: of every action: 3.3x the bf16 program's 0.075 (measured on one H100),
#: below the 0.71 of the reference with an fp8 trunk.
SE_LOGIT_TOL = 0.25


def read_se():
    from alphazeroforhnefatafl_tpu_torch.ops.group_norm import group_norm_act
    from alphazeroforhnefatafl_tpu_torch.ops.se_block import bn_relu, se_block

    return {"se": se_block.launches, "bn": bn_relu.launches, "se_plain": se_block.plain_calls,
            "bn_plain": bn_relu.plain_calls, "group_norm": group_norm_act.launches}


def se_since(before):
    return {k: v - before[k] for k, v in read_se().items()}


def check_se(counts, what, forwards=None):
    """Every forward an SE net's at the cell's widths in inference mode: the
    SE kernel 20 times and the norm kernel 22 times a forward (``forwards``
    of them where the caller counts them), no site on PyTorch's chain and
    no GroupNorm launch."""
    se, bn = counts["se"], counts["bn"]
    n = se // SE_SITES if se and se % SE_SITES == 0 else None
    if (n is None or bn != BN_SITES * n or counts["se_plain"] or counts["bn_plain"]
            or counts["group_norm"] or (forwards is not None and n != forwards)):
        fail(f"{what}: {counts}; want {SE_SITES} SE and {BN_SITES} norm launches a forward"
             + ("" if forwards is None else f" over {forwards} forwards")
             + ", no plain site, no GroupNorm launch")
    return n


def se_random_weights(net, seed):
    """Random weights with the norms' affine and running statistics away
    from 1 and 0 (as ``benchmark/reference/se_net.py`` draws them)."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.models.network import init_params

    g = torch.Generator().manual_seed(seed)
    init_params(net, g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(torch.exp(0.3 * torch.randn(m.running_var.shape, generator=g)))
            elif isinstance(m, torch.nn.Linear):
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    return net


def phase_se_net(device, card, rows=(512, 1024, 4096), net_rows=1024):
    """The SE-ResNet's kernels (``csrc/se_block.cu``) at the cell's width (256
    channels, 11x11): within 1 bf16 ulp of exact math rounded once
    (``ops.se_block.ulps_from_exact``), their times beside their byte bounds
    and PyTorch's chains (``library_ms``, which the port does not call on
    this path), their counters exact. Then the net at its published widths
    (20 blocks of 256 channels, ratio 8, bf16 trunk) through
    ``make_network``, against the plain float32 reference
    (``models/se_reference.py``) at 1,024 rows, beside the reference with a
    bf16 and an fp8 trunk: 20 SE and 22 norm launches a forward under
    ``inference_mode`` and no plain site, every site on the chain with grad
    on in training mode. Then self-play, the arena and ``cli play`` with it,
    counted a forward. One line ``{"se_block": {...}}``."""
    import torch

    from alphazeroforhnefatafl_tpu_torch import cli
    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.models import se_reference
    from alphazeroforhnefatafl_tpu_torch.models.network import make_network
    from alphazeroforhnefatafl_tpu_torch.ops.se_block import (
        bn_relu, bn_relu_plain, bn_relu_ulps, se_block, se_block_plain, se_block_ulps,
    )
    from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTSConfig
    from alphazeroforhnefatafl_tpu_torch.train.arena import play_match
    from alphazeroforhnefatafl_tpu_torch.train.selfplay import SelfPlayActor, SelfPlayConfig

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    C, n, hidden, eps = 256, 11, 32, 1e-5

    def nhwc(R):
        return torch.randn(R, n, n, C, generator=gen, device=device).to(
            torch.bfloat16).permute(0, 3, 1, 2)

    def vec(scale, shift=0.0):
        return shift + scale * torch.randn(C, generator=gen, device=device)

    norm = [vec(0.3, 1.0), vec(0.3), vec(0.3),
            torch.exp(vec(0.5))]
    se = [torch.randn(hidden, C, generator=gen, device=device) / C ** 0.5,
          0.1 * torch.randn(hidden, generator=gen, device=device),
          torch.randn(2 * C, hidden, generator=gen, device=device) / hidden ** 0.5,
          0.1 * torch.randn(2 * C, generator=gen, device=device)]
    per_launch = 4 * (4 * C + hidden * C + hidden + 2 * C * hidden + 2 * C)
    before = read_se()
    calls = {"se": 0, "bn": 0}
    cases = []
    for R in rows:
        y, x = nhwc(R), nhwc(R)

        def se_call():
            calls["se"] += 1
            return se_block(y, x, *norm, eps, *se)

        def bn_call():
            calls["bn"] += 1
            return bn_relu(y, *norm, eps)

        for kernel, call, library, ulps, nbytes in (
                ("se_block", se_call, lambda: se_block_plain(y, x, *norm, eps, *se),
                 lambda got: se_block_ulps(got, y, x, *norm, eps, *se),
                 R * 3 * n * n * C * 2 + per_launch),
                ("bn_relu", bn_call, lambda: bn_relu_plain(y, *norm, eps),
                 lambda got: bn_relu_ulps(got, y, *norm, eps), R * 2 * n * n * C * 2 + 4 * 4 * C)):
            got = call()
            if not got.is_contiguous(memory_format=torch.channels_last):
                fail(f"{kernel} R={R}: the output is not channels-last")
            exact_ulps = ulps(got)
            if exact_ulps > 1:
                fail(f"{kernel} R={R}: {exact_ulps} ulps from exact math rounded once")
            ms = time_ms(call)
            dev_ms = time_ms(call, device_only=True)
            library_ms = time_ms(library, device_only=True)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            cases.append(dict(kernel=kernel, rows=R, ms=ms, device_ms=dev_ms,
                              library_ms=library_ms, bound_ms=bound_ms, bytes=nbytes,
                              exact_ulps=exact_ulps))
            print(f"time {kernel} R={R} C={C} {n}x{n} on {card}: kernel {ms:.4f} ms per call "
                  f"({dev_ms:.4f} ms of it on the card), PyTorch's chain {library_ms:.4f} ms on "
                  f"the card; bound {nbytes} bytes / 3.35 TB/s = {bound_ms:.5f} ms, "
                  f"{100 * bound_ms / dev_ms:.1f}% of it reached; {exact_ulps} ulps from exact "
                  "math", flush=True)
    counts = se_since(before)
    if (counts["se"], counts["bn"]) != (calls["se"], calls["bn"]):
        fail(f"se_block launches {counts}, calls {calls}")

    # The net at its published widths against the reference.
    env = make_env("copenhagen", device)
    net = se_random_weights(make_network(env.n, dtype=torch.bfloat16, **SE_WIDTHS), SEED + 12)
    net = net.to(device).eval()
    boards = dense_boards(np.random.RandomState(SEED + 13), env.n, net_rows)
    obs = env.observe(env.reset_batch(net_rows).replace(
        board=torch.as_tensor(boards, device=device)))
    w = {k: v.float() for k, v in net.state_dict().items()}
    before = read_se()
    with torch.inference_mode():
        got = [t.double() for t in net(obs)]
        torch.cuda.synchronize()
        forward = se_since(before)
        check_se(forward, "se net forward", forwards=1)
        rounding = {"bf16": lambda t: t.to(torch.bfloat16).float(), "fp8": fp8_round}
        want = [t.double() for t in se_reference.forward(w, obs, SE_WIDTHS["blocks"])]
        trunk = {k: [t.double() for t in se_reference.forward(w, obs, SE_WIDTHS["blocks"],
                                                               trunk=q)]
                 for k, q in rounding.items()}

    def z(v):
        return torch.atanh(v.clamp(-1 + 1e-12, 1 - 1e-12))

    def gaps(out):
        logit = float((out[0] - want[0]).abs().max())
        value = float(((z(out[1]) - z(want[1])) ** 2).mean().sqrt())
        return logit, value

    logit_gap, value_gap = gaps(got)
    scale = gaps(trunk["bf16"])[1]
    fp8_logit, fp8_value = gaps(trunk["fp8"])
    # Tolerances: the program's bf16 trunk rounds each convolution's output
    # and each block's output besides what the bf16 reference rounds, so
    # its value error (before the tanh) is held to 5 times the bf16
    # reference's, as the cell's value_gap_ratio is, and its logits to
    # SE_LOGIT_TOL over 1,024 rows of every action; an fp8 trunk must fail
    # at least one of the two.
    ratio, fp8_ratio = value_gap / max(scale, 1e-12), fp8_value / max(scale, 1e-12)
    if not (logit_gap <= SE_LOGIT_TOL and ratio <= 5.0):
        fail(f"se net: logits {logit_gap} from the reference's (tolerance {SE_LOGIT_TOL}), "
             f"value gap {ratio} of the bf16 reference's (tolerance 5)")
    if fp8_logit <= SE_LOGIT_TOL and fp8_ratio <= 5.0:
        fail(f"se net: an fp8 trunk passes the tolerances (logits {fp8_logit}, values "
             f"{fp8_ratio})")
    # Training mode with grad on: every site on PyTorch's chain.
    before = read_se()
    net.train()
    with torch.enable_grad():
        net(obs[:64])
    net.eval()
    train = se_since(before)
    if train != {"se": 0, "bn": 0, "se_plain": SE_SITES, "bn_plain": BN_SITES, "group_norm": 0}:
        fail(f"se net in training mode: {train}")
    with torch.inference_mode():
        forward_ms = time_ms(lambda: net(obs), reps=5, device_only=True)
    print(f"se net on {card}: a forward at {net_rows} rows {forward_ms:.3f} ms on the card; "
          f"logits {logit_gap:.4f} from the float32 reference (fp8 trunk {fp8_logit:.4f}), "
          f"values {ratio:.3f} of the bf16 reference's gap (fp8 trunk {fp8_ratio:.3f})",
          flush=True)

    # The search paths: self-play, the arena, cli play.
    forwards = {"n": 0}

    def counted(obs):
        forwards["n"] += 1
        return net(obs)

    paths, by_path = {}, {"net_check": forward, "learner": train}
    actor = SelfPlayActor(env, counted, MCTSConfig(num_simulations=16, leaves_per_wave=2,
                                                   max_children=32),
                          SelfPlayConfig(batch_size=64), device)
    states, temps = env.reset_batch(64), torch.ones(64, device=device)
    g = torch.Generator(device=device).manual_seed(SEED)
    before = read_se()
    for _ in range(2):
        states = actor.move(states, temps, g)[0]
    by_path["selfplay"] = se_since(before)
    paths["selfplay"] = check_se(by_path["selfplay"], "se self-play", forwards["n"])
    forwards["n"] = 0
    before = read_se()
    play_match(env, counted, counted, MCTSConfig(num_simulations=8, dirichlet_eps=0.0),
               num_games=8, max_game_len=2)
    by_path["arena"] = se_since(before)
    paths["arena"] = check_se(by_path["arena"], "se arena", forwards["n"])
    out, stdin = io.StringIO(), sys.stdin
    before = read_se()
    sys.stdin = io.StringIO("quit\n")
    try:
        with contextlib.redirect_stdout(out):
            cli.main(["play", "--preset", "copenhagen", "--ai", "attacker", "--sims", "8",
                      "--channels", "256", "--blocks", "20", "--norm", "batch",
                      "--se-ratio", "8"])
    finally:
        sys.stdin = stdin
    if "AI plays" not in out.getvalue():
        fail(f"se cli play: {out.getvalue()}")
    by_path["play"] = se_since(before)
    paths["play"] = check_se(by_path["play"], "se cli play")
    line = {"card": card, "cases": cases,
            "net": {"launches_a_forward": forward, "training_with_grad": train,
                    "forward_ms_at_1024_rows": forward_ms,
                    "logit_gap": logit_gap, "value_gap_ratio": ratio,
                    "fp8_logit_gap": fp8_logit, "fp8_value_gap_ratio": fp8_ratio,
                    "bf16_reference_value_gap": scale},
            "forwards_by_path": paths, "counts_by_path": by_path}
    print(json.dumps({"se_block": line}), flush=True)
    return line


def fp8_round(t):
    """float8 e4m3 by a per-tensor scale, as ``benchmark/reference/net.py``'s
    control rounds."""
    import torch

    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def phase_net_check(device):
    """The port's net on the card against the same weights on the CPU, in
    float32 with TF32 off (tolerance 1e-4: the two devices sum convolutions
    in different orders)."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.models.network import init_params, make_network

    env = make_env("copenhagen", "cpu")
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


def phase_selfplay(device, card, mcts_cfg, moves, label):
    """256 Copenhagen games of ``moves`` moves in a batch of 256 under
    ``mcts_cfg``. Returns the launches, the replay, the moves per second,
    the seconds of each batched move and the host seconds each spent inside
    the tree traversals."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.bench import flagship_net
    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.train.replay import ReplayBuffer
    from alphazeroforhnefatafl_tpu_torch.train.selfplay import SelfPlayActor, SelfPlayConfig

    env = make_env("copenhagen", device)
    net = flagship_net(env.n, device, SEED)
    sp_cfg = SelfPlayConfig(batch_size=256, max_game_len=moves)
    actor = SelfPlayActor(env, net, mcts_cfg, sp_cfg, device=device)
    replay = ReplayBuffer(env, sp_cfg.batch_size * sp_cfg.max_game_len * 2, sp_cfg.policy_k)
    gen = torch.Generator(device=device).manual_seed(SEED)
    sims, gumbel = mcts_cfg.num_simulations, mcts_cfg.root_selection == "gumbel"

    # Every search's result is checked where it is made.
    unchecked_search = actor.mcts.search

    def checked_search(states, legal, *args, **kw):
        result = unchecked_search(states, legal, *args, **kw)
        if not bool((result.root_visits == sims).all()):
            fail(f"{label}: root visits {result.root_visits.unique().tolist()}, not {sims}")
        probs = result.action_probs
        if not torch.allclose(probs.sum(1), torch.ones_like(probs[:, 0]), atol=1e-5):
            fail(f"{label}: action_probs rows do not sum to 1")
        if float(probs[~legal].abs().sum()) != 0.0:
            fail(f"{label}: action_probs put mass on an illegal action")
        if not bool(legal.gather(1, result.best_action.long()[:, None]).all()):
            fail(f"{label}: a best_action is illegal")
        if not bool(torch.isfinite(result.root_value).all()):
            fail(f"{label}: non-finite root value")
        return result

    actor.mcts.search = checked_search

    # Host seconds inside the traversals, and under Gumbel inside the choice
    # of the forced root slot: each tree level ends in a host sync, so the
    # host's clock sees what the walk costs; the root slot's choice ends in
    # none, so its figure is the host's time to queue its launches.
    inside = {"_traverse": [0.0], "_forced_root_slot": [0.0]}

    def host_timed(name):
        untimed = getattr(actor.mcts, name)

        def timed(*args, **kw):
            t = time.perf_counter()
            out = untimed(*args, **kw)
            inside[name][-1] += time.perf_counter() - t
            return out

        setattr(actor.mcts, name, timed)

    for name in inside:
        host_timed(name)

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
        for seconds in inside.values():
            seconds.append(0.0)
        return out

    actor.move = timed_move

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = actor.play(replay, gen, num_games=256)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()

    d = stats.as_dict()
    print(f"selfplay {label} stats: {json.dumps(d)}", flush=True)
    if stats.games < 256:
        fail(f"self-play {label} finished {stats.games} games, expected >= 256")
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
    if actor.moves_played != moves:
        fail(f"self-play {label} made {actor.moves_played} batched moves, not {moves}")
    # One root mask a move; one env step a wave and one for the move; one
    # forward of the net a wave and one at the root, as many as the steps.
    steps = moves * (sims // mcts_cfg.leaves_per_wave + 1)
    want = {"legal_mask": moves, "step": steps, "group_norm": SITES * steps, "norm_plain": 0}
    if launches != want:
        fail(f"self-play {label} launched {launches}, not {want}")
    rate = moves * sp_cfg.batch_size / wall
    print(f"selfplay {label} on {card}: {moves} batched moves of B={sp_cfg.batch_size} in "
          f"{wall:.3f} s; {rate:.1f} moves/s, {rate * sims:.1f} sims/s; launches {launches}"
          + ("; every best_action legal, no mass on illegal actions" if gumbel else ""), flush=True)
    q = np.percentile(move_s[1:], [25, 50, 75])
    tq = np.percentile(inside["_traverse"][1:moves], [25, 50, 75])
    fq = np.percentile(inside["_forced_root_slot"][1:moves], [25, 50, 75])
    print(f"selfplay {label} move seconds: first {move_s[0]:.4f}; moves 2-{len(move_s)} quartiles "
          f"{q[0]:.4f} / {q[1]:.4f} / {q[2]:.4f}; of them inside the tree traversals "
          f"{tq[0]:.4f} / {tq[1]:.4f} / {tq[2]:.4f}"
          + (f", choosing the forced root slot {fq[0]:.4f} / {fq[1]:.4f} / {fq[2]:.4f}"
             if gumbel else ""), flush=True)
    return dict(launches=launches, replay=replay, rate=rate, move_s=q[1], traverse_s=tq[1])


#: The two tafl kernels.
TAFL = ("legal_mask", "step")
#: What :func:`read_launches` reads: the tafl kernels' launches, the
#: GroupNorm kernel's, and the net's GroupNorm sites that took PyTorch's
#: chain on the card (``norm_act.plain_calls``).
LAUNCH_KEYS = TAFL + ("group_norm", "norm_plain")


def gn_sites(blocks: int) -> int:
    """The GroupNorm sites of a forward: the stem, two a block, the policy head."""
    return 2 * blocks + 2


SITES = gn_sites(6)  # the flagship net's, and every 6-block net's here


def tafl(launches):
    """The tafl kernels' part of a :func:`read_launches` or :func:`read_batches`."""
    return {k: launches[k] for k in TAFL}


def check_norm(launches, what, forwards=None, sites=SITES):
    """A path whose every forward is a bf16 GroupNorm net at a width the
    kernel serves, under ``inference_mode``: the kernel launched ``sites``
    times a forward (``forwards`` of them, where the caller knows it), and
    no site took PyTorch's chain."""
    gn, plain = launches["group_norm"], launches["norm_plain"]
    if plain or not gn or gn % sites or (forwards is not None and gn != sites * forwards):
        want = f"{sites} a forward" + ("" if forwards is None else f": {sites * forwards}")
        fail(f"{what}: {gn} GroupNorm kernel launches (want {want}) and {plain} sites on "
             "PyTorch's chain (want 0)")


def read_launches():
    from alphazeroforhnefatafl_tpu_torch.models.network import norm_act
    from alphazeroforhnefatafl_tpu_torch.ops.group_norm import group_norm_act
    from alphazeroforhnefatafl_tpu_torch.ops.legal_mask import batched_legal_mask
    from alphazeroforhnefatafl_tpu_torch.ops.step_kernel import step_arrays

    return {"legal_mask": batched_legal_mask.launches, "step": step_arrays.launches,
            "group_norm": group_norm_act.launches, "norm_plain": norm_act.plain_calls}


def read_batches():
    """Each kernel's launches by the batch they saw, as ``{str(B): count}``
    (the GroupNorm kernel's by the rows of the forward)."""
    from alphazeroforhnefatafl_tpu_torch.ops.group_norm import group_norm_act
    from alphazeroforhnefatafl_tpu_torch.ops.legal_mask import batched_legal_mask
    from alphazeroforhnefatafl_tpu_torch.ops.step_kernel import step_arrays

    return {name: {str(b): n for b, n in sorted(fn.batches.items())}
            for name, fn in (("legal_mask", batched_legal_mask), ("step", step_arrays),
                             ("group_norm", group_norm_act))}


def batches_since(before):
    """The launches by batch since ``before`` (a :func:`read_batches`)."""
    now = read_batches()
    out = {}
    for k, counts in now.items():
        diff = {b: n - before[k].get(b, 0) for b, n in counts.items()}
        out[k] = {b: n for b, n in diff.items() if n}
    return out


def zero_launches():
    from alphazeroforhnefatafl_tpu_torch.models.network import norm_act
    from alphazeroforhnefatafl_tpu_torch.ops.group_norm import group_norm_act
    from alphazeroforhnefatafl_tpu_torch.ops.legal_mask import batched_legal_mask
    from alphazeroforhnefatafl_tpu_torch.ops.step_kernel import step_arrays

    for fn in (batched_legal_mask, step_arrays, group_norm_act):
        fn.launches = 0
        fn.batches = {}
    norm_act.plain_calls = 0


def sample_arrays(s):
    return s.board, s.side, s.reps, s.policy_idx, s.policy_p, s.value


def phase_learner_check(device, replay):
    """One train step of the same float32 64x6 net on the same batch, on
    the card and on the CPU (TF32 off; tolerance 1e-4, as for the forward:
    the two devices sum in different orders). The batch is built on each
    device from the same replay sample: on the card the legal mask comes
    from kernel 1, on the CPU from its plain version."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.models.network import make_network
    from alphazeroforhnefatafl_tpu_torch.ops.legal_mask import legal_mask_plain
    from alphazeroforhnefatafl_tpu_torch.train.learner import init_train_state, make_train_step
    from alphazeroforhnefatafl_tpu_torch.train.replay import make_batch_builder

    sample = replay.sample(np.random.RandomState(SEED), 256)
    got = {}
    for dev in ("cpu", device):
        env = make_env("copenhagen", dev)
        before = read_launches()["legal_mask"]
        batch = make_batch_builder(env)(*sample_arrays(sample))
        if (read_launches()["legal_mask"] - before) != (0 if dev == "cpu" else 1):
            fail(f"the batch builder on {dev} launched kernel 1 an unexpected number of times")
        net = make_network(env.n, channels=64, blocks=6, dtype=torch.float32)
        state = init_train_state(net, torch.Generator().manual_seed(SEED), dev)
        metrics = make_train_step(state)(batch)
        got[str(dev)] = (batch, {k: float(v) for k, v in metrics.items()})
    (cpu_batch, cpu_m), (card_batch, card_m) = got["cpu"], got[str(device)]
    if not torch.equal(card_batch.legal_mask.cpu(), cpu_batch.legal_mask):
        fail("the batch builder's legal mask on the card differs from the plain version's")
    plain = legal_mask_plain(make_env("copenhagen", device),
                             torch.as_tensor(sample.board, device=device),
                             torch.as_tensor(sample.side, device=device).int())
    if not torch.equal(card_batch.legal_mask, plain):
        fail("the batch builder's legal mask differs from the plain version on the card")
    if not torch.equal(card_batch.obs.cpu(), cpu_batch.obs):
        fail("the batch builder's planes on the card differ from the CPU's")
    sums = card_batch.policy_target.sum(1)
    if not torch.allclose(sums, torch.ones_like(sums), atol=1e-5):
        fail(f"policy targets do not sum to 1 (worst {float((sums - 1).abs().max())})")
    if not bool((card_batch.policy_target[~card_batch.legal_mask] == 0).all()):
        fail("a policy target puts weight on an illegal action")
    for k in ("loss", "grad_norm", "policy_loss", "value_loss"):
        a, b = card_m[k], cpu_m[k]
        if not (np.isfinite(a) and abs(a - b) <= 1e-4 + 1e-4 * abs(b)):
            fail(f"learner {k} on the card is {a}, on the CPU {b}")
    print(f"learner: float32 train step on the card matches the CPU within 1e-4 "
          f"(loss {card_m['loss']:.6f} vs {cpu_m['loss']:.6f}, grad_norm "
          f"{card_m['grad_norm']:.6f} vs {cpu_m['grad_norm']:.6f}); the batch builder's mask "
          f"from kernel 1 equals the plain version's on 256 positions", flush=True)


def profile_steps(one_step, steps=5, what="learner steps"):
    """``torch.profiler`` over ``steps`` calls of ``one_step``: a line with the
    card's busy milliseconds and kernel launches per step, the window's own
    wall time per step (the profiler slows the host, so this is not the time
    of a step without it) and the kernels that hold most of the busy time;
    and the busy milliseconds per step (None when the profiler saw no event
    on the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # Kernels and copies only: the device track also carries the ranges of
    # user annotations (the optimizer's step), which hold kernels counted here.
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not on_card:
        return "profile: the profiler recorded no event on the card (not measured)", None
    by_name = {}
    for e in on_card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values()) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (f"profile of {steps} {what}: the card is busy {busy_ms:.3f} ms of the "
            f"{wall_ms:.3f} ms a step takes under the profiler "
            f"({100 * (1 - busy_ms / wall_ms):.1f}% idle in that window); "
            f"{len(on_card) / steps:.0f} kernels and copies a step; most time in "
            + "; ".join(f"{name[:60]} {ms / steps:.3f} ms" for name, ms in top)), busy_ms


def phase_training(device, card, replay, steps=30, batch_size=256):
    """Full-width learner steps from phase 5's replay, as ``run_loop`` makes
    them: sample, copy, D4 augmentation, device-side batch, train step."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.core.symmetry import random_symmetry_batch
    from alphazeroforhnefatafl_tpu_torch.models.network import make_network
    from alphazeroforhnefatafl_tpu_torch.train.learner import (
        init_train_state, loss_fn, make_train_step,
    )
    from alphazeroforhnefatafl_tpu_torch.train.replay import make_batch_builder

    env = make_env("copenhagen", device)
    net = make_network(env.n, channels=64, blocks=6, norm="group", dtype=torch.bfloat16)
    # Another seed than the net that played phase 5's games: that net's own
    # priors shaped the visit counts it is now to learn, so its loss on them
    # starts low and D4-augmented training first raises it.
    state = init_train_state(net, torch.Generator().manual_seed(SEED + 1), device)
    build = make_batch_builder(env)
    train_step = make_train_step(state)
    gen = torch.Generator(device=device).manual_seed(SEED)
    np_rng = np.random.RandomState(SEED)

    held = build(*sample_arrays(replay.sample(np.random.RandomState(SEED + 7), batch_size)))

    def held_loss():
        with torch.no_grad():
            return float(loss_fn(net, held)[0])

    loss_before = held_loss()
    params_before = [p.detach().clone() for p in net.parameters()]

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    def one_step(times=None):
        t0 = clock() if times is not None else 0.0
        s = replay.sample(np_rng, batch_size)
        board = torch.as_tensor(s.board, device=device)
        policy_idx = torch.as_tensor(s.policy_idx, device=device)
        t1 = clock() if times is not None else 0.0
        board, policy_idx = random_symmetry_batch(gen, board, policy_idx)
        batch = build(board, s.side, s.reps, policy_idx, s.policy_p, s.value)
        t2 = clock() if times is not None else 0.0
        metrics = train_step(batch)
        if times is not None:
            times[:] = (t1 - t0, t2 - t1, clock() - t2)
        return metrics

    zero_launches()
    split = np.zeros((steps, 3))
    losses, norms = [], []
    for i in range(steps):
        metrics = one_step(split[i])
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if read_launches()["legal_mask"] != i + 1:
            fail(f"after {i + 1} learner steps kernel 1 was launched "
                 f"{read_launches()['legal_mask']} times")
    launches = read_launches()
    if launches["step"] != 0:
        fail(f"the learner launched kernel 2 {launches['step']} times")
    # One forward a step, with grad on: every site takes PyTorch's chain.
    if launches["group_norm"] != 0 or launches["norm_plain"] != SITES * steps:
        fail(f"{steps} learner steps launched the GroupNorm kernel {launches['group_norm']} "
             f"times and took the plain chain at {launches['norm_plain']} sites, not 0 and "
             f"{SITES * steps}")
    if not np.isfinite(losses).all() or not np.isfinite(norms).all():
        fail(f"non-finite learner loss or grad_norm: {losses} {norms}")
    if not min(norms) > 0:
        fail(f"a learner step had grad_norm {min(norms)}")
    if state.step != steps:
        fail(f"the train state counts {state.step} steps after {steps}")
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(net.parameters(), params_before))
    if not moved > 0:
        fail("the learner steps moved no parameter")
    if any(p.dtype != torch.float32 for p in net.parameters()):
        fail("a parameter of the bf16 trunk is not float32")
    loss_after = held_loss()
    if not loss_after < loss_before:
        fail(f"the held batch's loss went from {loss_before} to {loss_after}")
    # The first step pays cuDNN's algorithm search and the allocator's growth.
    ms = split[1:].mean(0) * 1e3
    total = ms.sum()
    print(f"training on {card}: {steps} learner steps of batch {batch_size} (64x6 bf16, D4 on); "
          f"first step {split[0].sum() * 1e3:.2f} ms; steps 2-{steps} mean {total:.3f} ms = "
          f"sample+copy {ms[0]:.3f} + augment+build {ms[1]:.3f} + "
          f"forward+backward+optimizer {ms[2]:.3f}; {1e3 / total:.2f} steps/s, "
          f"{batch_size * 1e3 / total:.1f} positions/s; loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"held batch {loss_before:.4f} -> {loss_after:.4f}; grad_norm {min(norms):.3f}-"
          f"{max(norms):.3f}; largest parameter move {moved:.2e}; launches {launches}",
          flush=True)
    # After the counts are read: five more steps, unsynchronized inside, as
    # the loop takes them.
    print(f"training on {card}: {profile_steps(one_step)[0]}", flush=True)
    return launches


def phase_loop(device, card):
    """``run_loop`` at full width for two gated iterations, then a second
    call that resumes from the checkpoint and runs a third."""
    import dataclasses

    import torch

    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.models.network import make_network
    from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTSConfig
    from alphazeroforhnefatafl_tpu_torch.train import loop
    from alphazeroforhnefatafl_tpu_torch.train.checkpoint import CheckpointManager
    from alphazeroforhnefatafl_tpu_torch.train.learner import init_train_state
    from alphazeroforhnefatafl_tpu_torch.train.selfplay import SelfPlayConfig
    from alphazeroforhnefatafl_tpu_torch.utils.metrics import MetricsLogger

    env = make_env("copenhagen", device)
    arena = {**dict.fromkeys(LAUNCH_KEYS, 0), "seconds": 0.0, "results": []}
    learner = {**dict.fromkeys(LAUNCH_KEYS, 0), "builds": 0}
    untimed_match, uncounted_train_step = loop.play_match, loop.make_train_step
    uncounted_builder = loop.make_batch_builder

    def counted_builder(*args, **kw):
        """The loop's batch builder, with the launches of each build counted."""
        build = uncounted_builder(*args, **kw)

        def counted_build(*arrays):
            before = read_launches()
            batch = build(*arrays)
            after = read_launches()
            for k in after:
                learner[k] += after[k] - before[k]
            learner["builds"] += 1
            return batch

        return counted_build

    def counted_train_step(*args, **kw):
        """The loop's train step, with its net's GroupNorm sites counted."""
        step = uncounted_train_step(*args, **kw)

        def counted_step(batch):
            before = read_launches()
            metrics = step(batch)
            after = read_launches()
            for k in after:
                learner[k] += after[k] - before[k]
            return metrics

        return counted_step

    def counted_match(*args, **kw):
        before = read_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = untimed_match(*args, **kw)
        torch.cuda.synchronize()
        arena["seconds"] += time.perf_counter() - t
        got = {k: v - before[k] for k, v in read_launches().items()}
        plies, steps = got["legal_mask"], got["step"]
        if not 1 <= plies <= kw["max_game_len"]:
            fail(f"an arena match launched kernel 1 {plies} times")
        if steps != plies * (args[3].num_simulations + 1):
            fail(f"an arena match of {plies} plies launched kernel 2 {steps} times, not "
                 f"{plies} x {args[3].num_simulations + 1}")
        # A forward at the root and one a wave, each in two halves (the
        # candidate's games and the incumbent's).
        check_norm(got, f"an arena match of {plies} plies", 2 * steps)
        for k in LAUNCH_KEYS:
            arena[k] += got[k]
        arena["results"].append(result)
        return result

    with tempfile.TemporaryDirectory() as tmp:
        config = loop.LoopConfig(
            preset="copenhagen", channels=64, blocks=6, iterations=2, games_per_iteration=256,
            train_steps_per_iteration=20, train_batch_size=256, min_replay_size=512,
            arena_games=64, arena_every=1, arena_sims=64, arena_max_game_len=8,
            gate_on="wilson", gate_threshold=0.5, checkpoint_dir=f"{tmp}/ckpt",
            mcts=MCTSConfig(num_simulations=64),
            selfplay=SelfPlayConfig(batch_size=256, max_game_len=8),
        )
        loop.play_match = counted_match
        loop.make_batch_builder = counted_builder
        loop.make_train_step = counted_train_step
        zero_launches()
        try:
            t0 = time.perf_counter()
            log = MetricsLogger(jsonl_path=f"{tmp}/metrics.jsonl")
            state = loop.run_loop(env, config, log=log)
            log.close()
            first_s = time.perf_counter() - t0
            if state.step != 40:
                fail(f"two iterations of 20 steps left the step count at {state.step}")
            mgr = CheckpointManager(config.checkpoint_dir)
            if mgr.latest_iteration() != 1 or mgr.saved_extra_keys() != ("incumbent_params",):
                fail(f"checkpoints {mgr.all_iterations()} with extra {mgr.saved_extra_keys()}")
            probe = init_train_state(
                make_network(env.n, channels=64, blocks=6), torch.Generator().manual_seed(1), device
            )
            mgr.restore(probe, None)
            if probe.step != 40:
                fail(f"the checkpoint restores a step count of {probe.step}, not 40")
            for (k, a), b in zip(probe.net.state_dict().items(), state.net.state_dict().values()):
                if not torch.equal(a, b):
                    fail(f"the checkpoint's {k} differs from the trained net's")

            t0 = time.perf_counter()
            log = MetricsLogger(jsonl_path=f"{tmp}/metrics.jsonl")
            state = loop.run_loop(env, dataclasses.replace(config, iterations=3), log=log)
            log.close()
            second_s = time.perf_counter() - t0
        finally:
            loop.play_match = untimed_match
            loop.make_batch_builder = uncounted_builder
            loop.make_train_step = uncounted_train_step
        total = read_launches()
        lines = [json.loads(line) for line in open(f"{tmp}/metrics.jsonl")]
        latest = mgr.latest_iteration()

    if state.step != 60 or latest != 2:
        fail(f"after the resume: step count {state.step}, latest checkpoint {latest}")
    resumed = [l for l in lines if "resume/iteration" in l]
    if len(resumed) != 1 or resumed[0]["resume/iteration"] != 2.0:
        fail(f"the second call did not resume at iteration 2: {resumed}")
    iterations = [l for l in lines if "selfplay/games" in l]
    if [l["step"] for l in iterations] != [0, 1, 2]:
        fail(f"iterations logged: {[l['step'] for l in iterations]}")
    for l in iterations:
        for key in ("selfplay/games", "selfplay/positions", "train/loss", "train/grad_norm",
                    "arena/games", "arena/score", "arena/promoted", "arena/gate_wilson_lb",
                    "time/selfplay_s", "time/train_s", "replay/size"):
            if key not in l:
                fail(f"iteration {l['step']} logged no {key}")
            if not isinstance(l[key], (int, float)) or not np.isfinite(l[key]):
                fail(f"iteration {l['step']} logged {key} = {l[key]!r}")
    if len(arena["results"]) != 3:
        fail(f"{len(arena['results'])} arena matches in 3 iterations")
    for r in arena["results"]:
        if r.games != 64 or r.candidate_wins + r.incumbent_wins + r.draws + r.truncated != 64:
            fail(f"arena counts do not add up to 64: {r.as_dict()}")
    # Every learner step built one batch, and each build launched kernel 1
    # once and kernel 2 never; each step's forward (grad on) took the plain
    # chain at every site.
    builds = learner.pop("builds")
    if builds != state.step or learner != {"legal_mask": builds, "step": 0, "group_norm": 0,
                                           "norm_plain": SITES * builds}:
        fail(f"{state.step} learner steps built {builds} batches with launches {learner}")
    # What is left after the arena and the learner is self-play: one mask
    # and 65 steps a batched move, a forward a step.
    selfplay = {k: total[k] - arena[k] - learner[k] for k in total}
    if selfplay["legal_mask"] <= 0 or selfplay["step"] != 65 * selfplay["legal_mask"]:
        fail(f"launches {total} less arena {arena} and learner {learner} leave {selfplay}")
    check_norm(selfplay, "the loop's self-play", selfplay["step"])
    sp_s = sum(l["time/selfplay_s"] for l in iterations)
    train_s = sum(l["time/train_s"] for l in iterations)
    print(f"loop on {card}: iterations 0-1 in {first_s:.2f} s, resume and iteration 2 in "
          f"{second_s:.2f} s; per iteration self-play {sp_s / 3:.2f} s "
          f"({selfplay['legal_mask'] // 3} moves of B=256, 64 sims), 20 learner steps "
          f"{train_s / 3:.2f} s, arena {arena['seconds'] / 3:.2f} s "
          f"({arena['legal_mask'] // 3} plies of B=64, 64 sims); arena results "
          f"{[(r.candidate_wins, r.incumbent_wins, r.draws, r.truncated) for r in arena['results']]}; "
          f"launches self-play {selfplay}, learner {learner}, "
          f"arena {tafl(arena)}", flush=True)
    return {"selfplay": selfplay, "learner": learner,
            "arena": {k: arena[k] for k in LAUNCH_KEYS}}


def phase_interleaved(device, card, rounds=3):
    """The serial, two-leaf and four-leaf searches move in turns, one
    batched move of 256 games each, so that a host that speeds up or slows
    down through a run does so for all three alike. Returns the launches of
    each search."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.bench import flagship_net
    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTSConfig
    from alphazeroforhnefatafl_tpu_torch.train.selfplay import SelfPlayActor, SelfPlayConfig

    env = make_env("copenhagen", device)
    net = flagship_net(env.n, device, SEED)
    B = 256
    configs = {"serial": MCTSConfig(), "L=2": MCTSConfig(leaves_per_wave=2),
               "L=4": MCTSConfig(leaves_per_wave=4)}
    actors = {k: SelfPlayActor(env, net, c, SelfPlayConfig(batch_size=B), device=device)
              for k, c in configs.items()}
    states = {k: env.reset_batch(B) for k in configs}
    gens = {k: torch.Generator(device=device).manual_seed(SEED) for k in configs}
    temps = torch.ones((B,), device=device)
    seconds = {k: [] for k in configs}
    launches = {k: dict.fromkeys(LAUNCH_KEYS, 0) for k in configs}
    order = list(configs)
    zero_launches()
    for r in range(rounds + 1):  # the first round warms up and is not timed
        for k in order[r % 3:] + order[:r % 3]:
            before = read_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            states[k] = actors[k].move(states[k], temps, gens[k])[0]
            torch.cuda.synchronize()
            if r > 0:
                seconds[k].append(time.perf_counter() - t)
            for name, count in read_launches().items():
                launches[k][name] += count - before[name]
    for k, c in configs.items():
        steps = (rounds + 1) * (c.num_simulations // c.leaves_per_wave + 1)
        want = {"legal_mask": rounds + 1, "step": steps, "group_norm": SITES * steps,
                "norm_plain": 0}
        if launches[k] != want:
            fail(f"interleaved {k} launched {launches[k]}, not {want}")
        if bool(states[k].terminated.any()):
            fail(f"interleaved {k}: a game ended within {rounds + 1} moves")
    med = {k: float(np.median(v)) for k, v in seconds.items()}
    print(f"selfplay in turns on {card}: {rounds} rounds of one move of B={B} each "
          f"({configs['serial'].num_simulations} sims), "
          f"median seconds a move and moves/s: "
          + ", ".join(f"{k} {m:.4f} ({B / m:.1f}; {med['serial'] / m:.2f} times serial)"
                      for k, m in med.items())
          + "; all seconds " + json.dumps({k: [round(x, 4) for x in v] for k, v in seconds.items()}),
          flush=True)
    return launches


def phase_config_match(device, card):
    """``play_config_match`` at full width: the two-leaf search against the
    serial one with one net, 64 games of 4 plies at 64 simulations."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.bench import flagship_net
    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTSConfig
    from alphazeroforhnefatafl_tpu_torch.train.arena import play_config_match

    env = make_env("copenhagen", device)
    net = flagship_net(env.n, device, SEED)
    sims, games, plies = 64, 64, 4
    serial = MCTSConfig(num_simulations=sims, dirichlet_eps=0.0)
    two_leaf = MCTSConfig(num_simulations=sims, dirichlet_eps=0.0, leaves_per_wave=2)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = play_config_match(env, net, net, two_leaf, serial, num_games=games, max_game_len=plies,
                          generator=torch.Generator(device=device).manual_seed(SEED))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    if r.games != games or r.candidate_wins + r.incumbent_wins + r.draws + r.truncated != games:
        fail(f"config match counts do not add up to {games}: {r.as_dict()}")
    if not np.isfinite(list(r.as_dict().values())).all():
        fail(f"non-finite config match result: {r.as_dict()}")
    # A ply: one root mask for each half (B=32), 64 serial waves, 32 two-leaf
    # waves and the move's step.
    played = launches["legal_mask"] // 2
    want = {"legal_mask": 2 * played, "step": played * (sims + sims // 2 + 1)}
    if not 1 <= played <= plies or tafl(launches) != want:
        fail(f"a config match of {played} plies launched {launches}, not {want}")
    check_norm(launches, "a config match")
    print(f"config match on {card}: two-leaf against serial, {games} games, {sims} sims, "
          f"{played} plies in {seconds:.2f} s ({seconds / played:.3f} s a ply); result "
          f"{(r.candidate_wins, r.incumbent_wins, r.draws, r.truncated)}; launches {launches}",
          flush=True)
    return launches


def phase_ladder(device, card):
    """``ladder`` at full width over the random-weight net and two net-free
    anchors: three matches of 16 games, 32 simulations, 4 plies."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.bench import flagship_net
    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTSConfig
    from alphazeroforhnefatafl_tpu_torch.train import arena
    from alphazeroforhnefatafl_tpu_torch.train.anchors import ANCHOR_CODES, make_anchored_evaluate

    env = make_env("copenhagen", device)
    entries = [("net", flagship_net(env.n, device, SEED))] + [
        (name, make_anchored_evaluate(env, ANCHOR_CODES[name])) for name in ("uniform", "random")]
    sims, games, plies = 32, 16, 4
    matches = []
    uncounted_match = arena.play_match

    def counted_match(*args, **kw):
        before = read_launches()
        result = uncounted_match(*args, **kw)
        after = read_launches()
        played = after["legal_mask"] - before["legal_mask"]
        steps = after["step"] - before["step"]
        if not 1 <= played <= plies or steps != played * (sims + 1):
            fail(f"a ladder match of {played} plies launched kernel 2 {steps} times")
        if result.games != games:
            fail(f"a ladder match played {result.games} games, not {games}")
        matches.append(result)
        return result

    arena.play_match = counted_match
    zero_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ratings, wins, played_games = arena.ladder(
            env, entries, MCTSConfig(num_simulations=sims, dirichlet_eps=0.0),
            games_per_pair=games, max_game_len=plies,
            generator=torch.Generator(device=device).manual_seed(SEED))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        arena.play_match = uncounted_match
    launches = read_launches()
    if len(matches) != 3:
        fail(f"a ladder over three entries played {len(matches)} matches")
    check_norm(launches, "the ladder")
    if list(ratings) != ["net", "uniform", "random"] or ratings["net"] != 0.0:
        fail(f"ladder ratings {ratings}")
    if not np.isfinite(list(ratings.values())).all():
        fail(f"non-finite ladder ratings {ratings}")
    if not np.array_equal(played_games, games * (1 - np.eye(3))) or \
            not np.array_equal(wins + wins.T, played_games):
        fail(f"ladder tables do not add up: wins {wins.tolist()} games {played_games.tolist()}")
    print(f"ladder on {card}: net, uniform, random; 3 matches of {games} games, {sims} sims, "
          f"at most {plies} plies in {seconds:.2f} s; ratings "
          f"{ {k: round(v, 1) for k, v in ratings.items()} }; results "
          f"{[(r.candidate_wins, r.incumbent_wins, r.draws, r.truncated) for r in matches]}; "
          f"launches {launches}", flush=True)
    return launches


#: Keys of the bench line: the JAX bench's accelerator line and the port's.
BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "mean_value", "timing",
    "env_state_bytes_per_game", "mcts_sims_per_s", "mcts_sims_per_s_mean", "mcts_config",
    "mcts_sims_per_s_800", "mcts_sims_per_s_800_mean", "mcts_config_800",
    "net_flops_per_eval", "mfu_128", "mfu_800", "chip_peak_tflops_bf16",
    "card", "power_limit_w", "mcts_sims_per_s_serial", "mcts_sims_per_s_serial_mean",
    "mcts_config_serial", "device",
)
BENCH_RATES = (
    "value", "mean_value", "mcts_sims_per_s", "mcts_sims_per_s_mean", "mcts_sims_per_s_800",
    "mcts_sims_per_s_800_mean", "mcts_sims_per_s_serial", "mcts_sims_per_s_serial_mean",
    "mfu_128", "mfu_800",
)


def phase_bench(device, card):
    """``run_bench`` on the card, in process. The rollouts are recorded as
    they return (the state and mask each carries) and the searches' launches
    counted around ``bench_mcts_sims``; the rollouts' launches are the rest."""
    import torch

    from alphazeroforhnefatafl_tpu_torch import bench
    from alphazeroforhnefatafl_tpu_torch.ops.legal_mask import legal_mask_plain

    batch, chunk, windows, pipeline = 4096, 32, 8, 8
    # (sims, leaves, timed searches) of the three configurations.
    searches = ((128, 2, 3), (800, 4, 2), (128, 1, 3))
    carried = {"rollouts": 0}
    mcts = {}
    unrecorded_make_rollout, uncounted_mcts = bench.make_rollout, bench.bench_mcts_sims

    def recorded_make_rollout(env, b, c):
        rollout = unrecorded_make_rollout(env, b, c)

        def recorded(*args, **kw):
            state, mask, checksum = rollout(*args, **kw)
            carried.update(env=env, state=state, mask=mask, rollouts=carried["rollouts"] + 1)
            return state, mask, checksum

        return recorded

    def counted_mcts(*args, **kw):
        before = read_launches()
        out = uncounted_mcts(*args, **kw)
        mcts.update({k: v - before[k] for k, v in read_launches().items()})
        return out

    bench.make_rollout, bench.bench_mcts_sims = recorded_make_rollout, counted_mcts
    zero_launches()
    try:
        t0 = time.perf_counter()
        rec = bench.run_bench(device, SEED)
        seconds = time.perf_counter() - t0
    finally:
        bench.make_rollout, bench.bench_mcts_sims = unrecorded_make_rollout, uncounted_mcts
    total = read_launches()
    rollout_launches = {k: total[k] - mcts[k] for k in total}

    want_rollout = {"legal_mask": 2, "step": chunk * (1 + windows * pipeline),
                    "group_norm": 0, "norm_plain": 0}
    want_mcts = {"legal_mask": len(searches),
                 "step": sum(sims // L * (1 + timed) for sims, L, timed in searches)}
    if carried["rollouts"] != 1 + windows * pipeline or rollout_launches != want_rollout:
        fail(f"the bench made {carried['rollouts']} rollouts launching {rollout_launches}, not "
             f"{1 + windows * pipeline} launching {want_rollout}")
    if tafl(mcts) != want_mcts:
        fail(f"the bench's searches launched {mcts}, not {want_mcts}")
    check_norm(mcts, "the bench's searches")
    # After the counts are read: the carried mask against kernel 1 and its
    # plain version on the carried state.
    env, state, mask = carried["env"], carried["state"], carried["mask"]
    if state.batch_size != batch or bool(state.terminated.any()):
        fail("the last rollout carries a terminated game or a batch of another size")
    if not torch.equal(mask, env.legal_mask_many(state)):
        fail("the mask the rollout carries differs from kernel 1's mask of its state")
    if not torch.equal(mask, legal_mask_plain(env, state.board, state.side_to_play)):
        fail("the mask the rollout carries differs from the plain version's mask of its state")

    # What a rollout costs: per call, as the host pays it, and the card's
    # busy time in it (a profiler window: a rollout's launches outnumber
    # what a held stream can queue, so the events cannot time the card alone).
    gen = torch.Generator(device=device).manual_seed(SEED)
    rollout = unrecorded_make_rollout(env, batch, chunk)
    call_ms = time_ms(lambda: rollout(state, mask, gen), reps=4)
    profile, card_ms = profile_steps(lambda: rollout(state, mask, gen), steps=2,
                                     what=f"rollouts of {chunk} steps of B={batch}")
    busy = ("not measured" if card_ms is None
            else f"{card_ms:.3f} ms of it ({100 * (1 - card_ms / call_ms):.1f}% idle)")
    # utils/profiling's trace of one rollout: the card's kernels and the
    # rollout's own annotation are in it.
    from alphazeroforhnefatafl_tpu_torch.utils.profiling import device_trace

    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp):
            rollout(state, mask, gen)
            torch.cuda.synchronize()
        traces = list(Path(tmp).glob("*.pt.trace.json"))
        events = json.loads(traces[0].read_text())["traceEvents"] if len(traces) == 1 else []
    traced_kernels = sum(e.get("cat") == "kernel" for e in events)
    if not traced_kernels or not any(e.get("name") == "bench/rollout" for e in events):
        fail(f"device_trace wrote {len(traces)} traces with {traced_kernels} kernels on the card "
             "and no bench/rollout region")

    missing = [k for k in BENCH_KEYS if k not in rec]
    if missing:
        fail(f"the bench line lacks {missing}")
    bad = [k for k in BENCH_RATES if not (isinstance(rec[k], float) and rec[k] > 0)]
    if bad:
        fail(f"the bench line's {bad} are not positive: {[rec[k] for k in bad]}")
    if f"{rec['card']}, {rec['power_limit_w']:.2f} W" != card or rec["device"] != torch.cuda.get_device_name(device):
        fail(f"the bench line names {rec['card']!r}, {rec['power_limit_w']!r}, {rec['device']!r}; "
             f"nvidia-smi says {card!r}")
    print(json.dumps(rec), flush=True)
    print(f"bench on {card}: {seconds:.1f} s; {rec['value']} env steps/s (mean {rec['mean_value']}); "
          f"sims/s L=2 {rec['mcts_sims_per_s']}, 800 at L=4 {rec['mcts_sims_per_s_800']}, serial "
          f"{rec['mcts_sims_per_s_serial']}; the carried mask equals kernel 1's and the plain "
          f"version's on {batch} games; launches rollout {rollout_launches}, mcts {mcts}; a rollout "
          f"takes {call_ms:.3f} ms a call unprofiled, the card busy {busy}; device_trace of a "
          f"rollout holds {traced_kernels} kernels on the card and its region", flush=True)
    print(f"bench on {card}: {profile}", flush=True)
    return {"rollout": rollout_launches, "mcts": mcts}


def phase_play(device, card, sims=64):
    """``cli play --ai attacker`` through the CLI's entry point on the card:
    the AI opens, the scripted human plays ``c4-c5`` (no attacker move can
    block or capture it), the AI replies, then ``quit``."""
    from alphazeroforhnefatafl_tpu_torch import cli
    from alphazeroforhnefatafl_tpu_torch.core.oracle import Game, Play
    from alphazeroforhnefatafl_tpu_torch.core.rules import PRESETS

    out, stdin = io.StringIO(), sys.stdin
    zero_launches()
    sys.stdin = io.StringIO("c4-c5\nquit\n")
    try:
        with contextlib.redirect_stdout(out):
            cli.main(["play", "--preset", "brandubh", "--ai", "attacker", "--sims", str(sims)])
    finally:
        sys.stdin = stdin
    launches = read_launches()
    text = out.getvalue()
    ai = re.findall(r"^AI plays (\S+)$", text, flags=re.M)
    if len(ai) != 2 or "Invalid move" in text:
        fail(f"cli play --ai: AI moves {ai}; transcript:\n{text}")
    game = Game(*PRESETS["brandubh"])
    for play in (ai[0], "c4-c5", ai[1]):
        reason = game.logic.validate_play(Play.from_str(play), game.state)
        if reason is not None:
            fail(f"cli play --ai: {play} is illegal ({reason.name})")
        game.do_play(Play.from_str(play))
    want = {"legal_mask": 2, "step": 2 * sims}
    if tafl(launches) != want:
        fail(f"cli play --ai launched {launches}, not {want}")
    check_norm(launches, "cli play --ai", sites=gn_sites(3))  # its net has 3 blocks
    print(f"play on {card}: cli play --ai attacker, AI plays {ai[0]}, human c4-c5, AI plays "
          f"{ai[1]}, both legal under the oracle; launches {launches}", flush=True)
    return launches


def flagship_search(leaves):
    """The search of the flagship run's last records
    (``runs/copenhagen_r4ab_puct/config.jsonl``) at ``leaves`` a wave: 128
    simulations, 32 children, top-k recall 0.9, Dirichlet alpha 10 / legal
    moves, root noise on."""
    from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTSConfig

    return MCTSConfig(num_simulations=128, max_children=32, leaves_per_wave=leaves,
                      topk_recall=0.9, dirichlet_alpha_scale=10.0)


REPLAY_FIELDS = ("board", "side", "reps", "policy_idx", "policy_p", "value")


def phase_determinism(device, card, runs=((2, 8), (1, 4))):
    """Seeded determinism on the card at full width: 256 Copenhagen games
    with the flagship net, root noise and temperature sampling on, under the
    flagship search at two leaves a wave for 8 moves and serial for 4. Seed
    0 twice and seed 1 once each: equal seeds give bit-identical replay
    arrays and equal stats, seeds 0 and 1 different boards."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.bench import flagship_net
    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.train.replay import ReplayBuffer
    from alphazeroforhnefatafl_tpu_torch.train.selfplay import SelfPlayActor, SelfPlayConfig

    env = make_env("copenhagen", device)
    net = flagship_net(env.n, device, SEED)

    def play(cfg, moves, seed):
        sp_cfg = SelfPlayConfig(batch_size=256, max_game_len=moves)
        actor = SelfPlayActor(env, net, cfg, sp_cfg, device=device)
        replay = ReplayBuffer(env, sp_cfg.batch_size * moves, sp_cfg.policy_k)
        stats = actor.play(replay, torch.Generator(device=device).manual_seed(seed), 256)
        return replay, stats.as_dict()

    zero_launches()
    total = dict.fromkeys(LAUNCH_KEYS, 0)
    t0 = time.perf_counter()
    for leaves, moves in runs:
        cfg = flagship_search(leaves)
        (a, sa), (b, sb), (c, _) = play(cfg, moves, 0), play(cfg, moves, 0), play(cfg, moves, 1)
        label = f"determinism L={leaves}"
        if sa != sb:
            fail(f"{label}: seed 0 gave the stats {sa} and then {sb}")
        if not (a.size == b.size == 256 * moves):
            fail(f"{label}: replays of {a.size} and {b.size} positions, not {256 * moves}")
        for field in REPLAY_FIELDS:
            x, y = getattr(a, field), getattr(b, field)
            if not np.array_equal(x, y):
                rows = int((x != y).reshape(len(x), -1).any(1).sum())
                fail(f"{label}: replay.{field} differs between two runs of seed 0 "
                     f"({rows} positions of {a.size})")
        if c.size == a.size and np.array_equal(a.board, c.board):
            fail(f"{label}: seeds 0 and 1 played the same boards")
        total["legal_mask"] += 3 * moves
        total["step"] += 3 * moves * (cfg.num_simulations // leaves + 1)
        total["group_norm"] += SITES * 3 * moves * (cfg.num_simulations // leaves + 1)
        print(f"determinism on {card}: {label}, 256 games, {moves} moves, root noise and "
              f"temperature on: two runs of seed 0 equal in every replay field "
              f"({', '.join(REPLAY_FIELDS)}) and stats; seed 1 plays other boards "
              f"({int((a.board != c.board).reshape(a.size, -1).any(1).sum())} of {a.size} "
              "positions differ)", flush=True)
    launches = read_launches()
    if launches != total:
        fail(f"determinism runs launched {launches}, not {total}")
    print(f"determinism on {card}: {time.perf_counter() - t0:.1f} s; launches {launches}",
          flush=True)
    return launches


def captured(fn, *args):
    """``(return value, stdout, stderr)`` of ``fn(*args)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        value = fn(*args)
    return value, out.getvalue(), err.getvalue()


def phase_profile_wave(device, card, sims=800):
    """``scripts.profile_wave`` then ``scripts.analyze_trace`` through their
    ``main(argv)``: one search of 1024 games, ``sims`` simulations, 128
    children, one leaf a wave, traced into a temporary directory. The trace
    must hold exactly one step-kernel event a wave."""
    from alphazeroforhnefatafl_tpu_torch.scripts import analyze_trace, profile_wave

    analyses = []
    unrecorded_analyze = analyze_trace.analyze

    def recorded_analyze(*args, **kw):
        analyses.append(unrecorded_analyze(*args, **kw))
        return analyses[-1]

    with tempfile.TemporaryDirectory() as tmp:
        zero_launches()
        t0 = time.perf_counter()
        rc, out, err = captured(profile_wave.main, ["--batch", "1024", "--sims", str(sims),
                                                    "--children", "128", "--leaves", "1",
                                                    "--trace-dir", tmp])
        profile_s = time.perf_counter() - t0
        launches = read_launches()
        print(out + err, end="", flush=True)
        rec = json.loads(out.splitlines()[-1])
        analyze_trace.analyze = recorded_analyze
        try:
            t0 = time.perf_counter()
            rc2, report, _ = captured(analyze_trace.main, [tmp, "--top", "25"])
            analyze_s = time.perf_counter() - t0
        finally:
            analyze_trace.analyze = unrecorded_analyze
    print(report, end="", flush=True)
    if rc != 0 or rc2 != 0 or len(analyses) != 1:
        fail(f"profile_wave returned {rc}, analyze_trace {rc2} after {len(analyses)} analyses")
    s = analyses[0]
    steps_traced = sum(n for name, n in s["op_counts"].items() if "tafl_step_kernel" in name)
    want = {"legal_mask": 1, "step": 2 * sims}  # the root mask; a warm and a traced search
    if tafl(launches) != want:
        fail(f"profile_wave launched {launches}, not {want}")
    check_norm(launches, "profile_wave")
    if steps_traced != sims:
        fail(f"the trace holds {steps_traced} step-kernel events, not one a wave ({sims})")
    if not s["device_events"] or s["busy_share"] is None or not 0 < s["busy_share"] <= 1:
        fail(f"the trace holds {s['device_events']} device events, busy share {s['busy_share']}")
    line = {
        "sims": sims, "batch": 1024, "children": 128, "leaves": 1,
        "search_s": rec["search_s"], "export_s": rec["export_s"], "trace_mb": rec["trace_mb"],
        "profile_wave_s": round(profile_s, 3), "analyze_s": round(analyze_s, 3),
        "device_events": s["device_events"], "device_total_ms": round(s["total_ms"], 3),
        "window_ms": round(s["window_ms"], 3), "busy_ms": round(s["busy_ms"], 3),
        "busy_share": round(s["busy_share"], 4),
        "families_ms": {k: round(v, 3) for k, v in s["families"].items()},
        "tafl_step_kernel_events": steps_traced,
        "tracks": list(s["tracks"]),
        "card": card,
    }
    print(json.dumps({"profile_wave": line}), flush=True)
    return launches


#: Depth cuts of the flagship record for phase 16 (its widths stay).
RUN_CUTS = {"iterations": 2, "max_game_len": 12, "arena_max_len": 12, "arena_every": 1,
            "train_steps": 10, "checkpoint_every": 1, "replay_capacity": 16384}


def phase_run_drivers(device, card):
    """The run drivers through their ``main(argv)`` in a temporary working
    directory: ``train_run`` with the flagship record's flags cut in depth,
    ``summarize_run``, ``eval_run`` (each checkpoint in a net of its own),
    ``cross_ladder``, ``search_ab`` and ``bench_mcts``, with the launches of
    each driver counted."""
    import os

    import torch

    from alphazeroforhnefatafl_tpu_torch.scripts import (
        bench_mcts, cross_ladder, eval_run, search_ab, summarize_run, train_run)

    root = Path(__file__).resolve().parent
    rec = json.loads((root / "runs" / "copenhagen_r4ab_puct" / "config.jsonl")
                     .read_text().splitlines()[-1])
    rec.update(RUN_CUTS, name="smoke_r4ab", cpu=False)
    launches, seconds, cwd = {}, {}, os.getcwd()

    def drive(name, module, argv):
        zero_launches()
        t0 = time.perf_counter()
        rc, out, err = captured(module.main, argv)
        torch.cuda.synchronize()
        seconds[name] = round(time.perf_counter() - t0, 2)
        launches[name] = read_launches()
        if rc != 0:
            fail(f"{name} returned {rc}; stderr:\n{err}")
        return out, err

    def captured_ladder(module):
        seen = {}
        real = module.ladder

        def ladder(env, named, *args, **kw):
            seen["named"] = list(named)
            return real(env, named, *args, **kw)

        module.ladder = ladder
        return seen, real

    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            out, err = drive("train_run", train_run, train_run.record_argv(rec))
            if "--search-chunk 32 is ignored" not in err:
                fail(f"train_run printed no notice for --search-chunk 32; stderr:\n{err}")
            print(err + out, end="", flush=True)
            run_dir = Path(tmp) / "runs" / "smoke_r4ab"
            ckpt = run_dir / "ckpt"
            steps = RUN_CUTS["iterations"] * RUN_CUTS["train_steps"]
            rows = (run_dir / "metrics.jsonl").read_text().splitlines()
            its = sorted(int(p.name[5:13]) for p in ckpt.glob("ckpt_*.pt"))
            if out.splitlines()[-1] != f"done: step={steps}" or len(rows) != 2 or its != [0, 1]:
                fail(f"train_run: {out.splitlines()[-1]!r}, {len(rows)} metrics rows, "
                     f"checkpoints {its}")

            out, _ = drive("summarize_run", summarize_run, [str(run_dir), "--every", "1"])
            print(out, end="", flush=True)
            if not out.startswith("2 iterations | "):
                fail(f"summarize_run printed {out!r}")

            match = ["--preset", "copenhagen", "--games", "2", "--sims", "16",
                     "--max-game-len", "6"]
            seen, real = captured_ladder(eval_run)
            try:
                out, err = drive("eval_run", eval_run, ["--ckpt", str(ckpt), *match,
                                                        "--anchors", "uniform,material,random"])
            finally:
                eval_run.ladder = real
            ratings = json.loads(out)["ratings"]
            names = ["init", "iter000", "iter001", "anchor_uniform", "anchor_material",
                     "anchor_random"]
            if list(ratings) != names or ratings["anchor_uniform"] != 0.0 or \
                    not np.isfinite(list(ratings.values())).all():
                fail(f"eval_run rated {ratings}; stderr:\n{err}")
            nets = dict(seen["named"])
            params = {}
            for it in (0, 1):
                saved = torch.load(ckpt / f"ckpt_{it:08d}.pt", map_location="cpu",
                                   weights_only=True)["train_state"]["net"]
                params[it] = {k: v.cpu() for k, v in nets[f"iter{it:03d}"].state_dict().items()}
                if params[it].keys() != saved.keys() or \
                        not all(torch.equal(params[it][k], saved[k]) for k in saved):
                    fail(f"eval_run's iter{it:03d} does not hold its checkpoint's parameters")
            if all(torch.equal(params[0][k], params[1][k]) for k in params[0]):
                fail("eval_run's iter000 and iter001 hold the same parameters")
            print(f"eval_run: {json.dumps({k: round(v, 1) for k, v in ratings.items()})}; "
                  "each iter entry holds its own checkpoint's parameters", flush=True)

            seen, real = captured_ladder(cross_ladder)
            try:
                out, err = drive("cross_ladder", cross_ladder, [
                    "--entry", f"latest={ckpt}:latest", "--entry", f"mid={ckpt}:mid", *match])
            finally:
                cross_ladder.ladder = real
            res = json.loads(out)
            if list(res["ratings"]) != ["init", "latest", "mid", "anchor_uniform",
                                        "anchor_random"] or len(res["score_matrix"]) != 5:
                fail(f"cross_ladder printed {out!r}")
            print(f"cross_ladder: {out.strip()}", flush=True)

            out, _ = drive("search_ab", search_ab, [
                "--ckpt", str(ckpt), "--games", "64", "--sims", "128", "--max-game-len", "6",
                "--a", "leaves=2,recall=0.9", "--b", "leaves=1,recall=0.99"])
            res = json.loads(out)
            if res["games"] != 64 or res["ckpt_step"] != 1:
                fail(f"search_ab printed {out!r}")
            print(f"search_ab: {out.strip()}", flush=True)

            out, _ = drive("bench_mcts_script", bench_mcts, [
                "--batch", "1024", "--sims", "128", "--children", "32", "--leaves", "2",
                "--iters", "2"])
            res = json.loads(out)
            if res["metric"] != "mcts_sims_per_s_11x11_b1024_s128_k32_auto_u4_L2" or \
                    not res["value"] > 0 or len(res["iter_ms"]) != 2:
                fail(f"bench_mcts printed {out!r}")
            print(f"bench_mcts: {out.strip()}", flush=True)
        finally:
            os.chdir(cwd)
    if tafl(launches["bench_mcts_script"]) != {"legal_mask": 1, "step": 3 * 64}:
        fail(f"bench_mcts launched {launches['bench_mcts_script']}, not one mask and 192 steps")
    del launches["summarize_run"]  # reads a log; launches nothing
    print(f"run drivers on {card}: seconds {seconds}; launches {launches}; cuts of the "
          f"flagship record {RUN_CUTS}", flush=True)
    return launches


MULTIRANK_RANKS = 2
MULTIRANK_STEPS = 10  # learner steps an iteration, at a global batch of 256
#: Deadlines of the spawned ranks (phase 17's took 60-120 s), of a
#: ``dryrun_multichip`` and of phase 18's ``torchrun``: a rank that hangs in
#: a collective ends its phase well before NCCL's ten-minute watchdog would.
RANKS_TIMEOUT_S, DRYRUN_TIMEOUT_S, TORCHRUN_TIMEOUT_S = 420, 240, 420


def multirank_config(world, ckpt_dir, iterations):
    """Phase 17's loop: the flagship record's search (128 simulations, 32
    children, L=2, recall 0.9), 256 games a rank of 8 plies in a batch of
    256, 10 learner steps at a global batch of 256, a 64-game Wilson-gated
    arena of 8 plies at 64 simulations and a checkpoint each iteration."""
    from alphazeroforhnefatafl_tpu_torch.train.loop import LoopConfig
    from alphazeroforhnefatafl_tpu_torch.train.selfplay import SelfPlayConfig

    return LoopConfig(
        preset="copenhagen", channels=64, blocks=6, iterations=iterations,
        games_per_iteration=256 * world, train_steps_per_iteration=MULTIRANK_STEPS,
        train_batch_size=256, min_replay_size=512, arena_games=64, arena_every=1,
        arena_sims=64, arena_max_game_len=8, gate_on="wilson", gate_threshold=0.5,
        checkpoint_dir=ckpt_dir, seed=SEED, mcts=flagship_search(2),
        selfplay=SelfPlayConfig(batch_size=256, max_game_len=8),
    )


@contextlib.contextmanager
def timed_gathers(seconds, starts=None):
    """Append the seconds of every ``mesh.gather_ints`` made inside the
    block to ``seconds``, and its ``time.perf_counter()`` at the call to
    ``starts`` (the arena's per-ply "any game still running" gather and its
    results; a rank's time there includes its wait for the other ranks)."""
    from alphazeroforhnefatafl_tpu_torch.parallel import mesh

    untimed = mesh.gather_ints

    def timed(values, group):
        t = time.perf_counter()
        out = untimed(values, group)
        seconds.append(time.perf_counter() - t)
        if starts is not None:
            starts.append(t)
        return out

    mesh.gather_ints = timed
    try:
        yield
    finally:
        mesh.gather_ints = untimed


#: Phase 17's split-equals-whole match: 64 Brandubh games, 8 simulations
#: at two leaves a wave, at most 80 plies, between the two nets of
#: :func:`elementwise_nets`. On the CPU most of its games end, at different
#: plies (tests/test_torch_arena.py SPLIT_MATCHES, at 8 games).
SPLIT_GAMES, SPLIT_PLIES = 64, 80


def elementwise_nets(env):
    """Two evaluates whose output for a game is a function of that game's
    observation alone, computed without a convolution or a product: sums of
    0/1 planes (exact in any order) and integer arithmetic. A game's result
    cannot depend on the batch it is evaluated in. The candidate is the fake
    net of tests/test_mcts.py; every legal logit of the incumbent
    underflows, so the uniform fallback fires."""
    import torch

    a = torch.arange(env.num_actions, dtype=torch.int64, device=env.device)

    def candidate(obs):
        B = obs.shape[0]
        att = obs[..., 0].sum((1, 2)).long()
        deff = obs[..., 1].sum((1, 2)).long()
        king = obs[..., 2].reshape(B, -1).argmax(-1)
        side = obs[:, 0, 0, 4].long()
        key = att + 3 * deff + 11 * king + 7 * side
        logits = ((a[None, :] * 12345 + key[:, None] * 7919) % 9973).float() / 9973.0
        return logits, ((key * 131 + 29) % 201 - 100).float() / 100.0

    def incumbent(obs):
        B = obs.shape[0]
        return (torch.full((B, env.num_actions), -2e30, device=obs.device),
                torch.zeros((B,), device=obs.device))

    return candidate, incumbent


def split_match(device, group):
    """Play phase 17's split-equals-whole match on ``device``: the whole
    match without ``group``, this rank's slice with it. Sets the launch
    counters to 0 first. Returns the per-game outcomes, the counts, the
    fallback rate, the tie-break generator's state after the match, its
    seconds, the launches (by batch too) and the gathers' seconds."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTSConfig
    from alphazeroforhnefatafl_tpu_torch.train.arena import play_match

    env = make_env("brandubh", device)
    candidate, incumbent = elementwise_nets(env)
    cfg = MCTSConfig(num_simulations=8, max_children=8, max_depth=8, dirichlet_eps=0.0,
                     leaves_per_wave=2)
    gen = torch.Generator(device=device).manual_seed(SEED)
    gathers = []
    zero_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with timed_gathers(gathers):
        r = play_match(env, candidate, incumbent, cfg, num_games=SPLIT_GAMES,
                       max_game_len=SPLIT_PLIES, generator=gen, group=group)
    torch.cuda.synchronize()
    return {"outcomes": list(r.outcomes), "seconds": time.perf_counter() - t,
            "counts": [r.candidate_wins, r.incumbent_wins, r.draws, r.truncated],
            "fallback": r.prior_fallback_rate, "generator": gen.get_state().tolist(),
            "launches": read_launches(), "batches": read_batches(), "gather_s": gathers}


def digest_int(net) -> int:
    """56 bits of the SHA-1 of the net's tensors (fits an int64 gather)."""
    from alphazeroforhnefatafl_tpu_torch.parallel.dryrun import params_digest

    return int(params_digest(net)[:14], 16)


def timed_loop(env, config, log_path, replay, group):
    """``run_loop`` with its arena matches and its learner all-reduces timed
    (each between two ``torch.cuda.synchronize()``) and, across ranks, the
    ranks' parameter digests gathered and compared after every learner
    step. Returns (state, logged lines, parts)."""
    import os

    import torch

    from alphazeroforhnefatafl_tpu_torch.parallel import mesh
    from alphazeroforhnefatafl_tpu_torch.train import learner, loop
    from alphazeroforhnefatafl_tpu_torch.utils.metrics import MetricsLogger

    parts = {"arena_s": [], "allreduce_ms": [], "allreduce_start": [], "digests_checked": 0,
             "arena_launches": dict.fromkeys(LAUNCH_KEYS, 0),
             "arena_batches": {k: {} for k in read_batches()}, "arena_gather_s": [],
             "arena_gather_start": []}
    untimed_match, untimed_mean, unchecked_make = loop.play_match, learner.mean_, loop.make_train_step

    def timed_match(*args, **kw):
        before, before_b = read_launches(), read_batches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with timed_gathers(parts["arena_gather_s"], parts["arena_gather_start"]):
            result = untimed_match(*args, **kw)
        torch.cuda.synchronize()
        parts["arena_s"].append(time.perf_counter() - t)
        for k, v in read_launches().items():
            parts["arena_launches"][k] += v - before[k]
        for k, counts in batches_since(before_b).items():
            for b, n in counts.items():
                parts["arena_batches"][k][b] = parts["arena_batches"][k].get(b, 0) + n
        return result

    def timed_mean(tensors, grp):
        torch.cuda.synchronize()
        t = time.perf_counter()
        untimed_mean(tensors, grp)
        torch.cuda.synchronize()
        parts["allreduce_ms"].append((time.perf_counter() - t) * 1e3)
        parts["allreduce_start"].append(t)

    def checked_make(state, grp=None):
        step = unchecked_make(state, grp)

        def checked_step(batch):
            metrics = step(batch)
            if grp is not None:
                digests = mesh.gather_ints([digest_int(state.net)], grp)[:, 0]
                if (digests != digests[0]).any():
                    raise RuntimeError(f"after learner step {state.step} the ranks' parameters "
                                       f"differ: digests {digests}")
                parts["digests_checked"] += 1
            return metrics

        return checked_step

    loop.play_match, learner.mean_, loop.make_train_step = timed_match, timed_mean, checked_make
    try:
        with open(os.devnull, "w") as quiet:
            log = MetricsLogger(stream=quiet, jsonl_path=log_path)
            state = loop.run_loop(env, config, log=log, replay=replay)
            log.close()
    finally:
        loop.play_match, learner.mean_, loop.make_train_step = untimed_match, untimed_mean, unchecked_make
    lines = [json.loads(line) for line in Path(log_path).read_text().splitlines()]
    return state, lines, parts


def slice_check(device, group, rank, world):
    """One float32 step of the 64x6 net on this rank's 1/``world`` of a
    batch of 256 (TF32 off) against one step of a copy on the whole batch in
    this process: the loss metrics within 1e-4 relative and the gradient
    the optimizer is given within 1e-4. Returns the largest gradient error."""
    import copy

    import torch

    from alphazeroforhnefatafl_tpu_torch.models.network import make_network
    from alphazeroforhnefatafl_tpu_torch.train.learner import Batch, init_train_state, make_train_step

    rng = np.random.RandomState(SEED)
    B, n, A = 256, 11, 11 * 11 * 4 * 10
    legal = rng.rand(B, A) < 0.05
    legal[:, 0] = True
    target = np.where(legal, rng.gamma(0.5, size=(B, A)), 0.0)
    target = (target / target.sum(1, keepdims=True)).astype(np.float32)
    arrays = dict(obs=rng.rand(B, n, n, 6).astype(np.float32), policy_target=target,
                  value_target=rng.uniform(-1, 1, B).astype(np.float32), legal_mask=legal)
    rows = slice(rank * B // world, (rank + 1) * B // world)
    net = make_network(n, channels=64, blocks=6, dtype=torch.float32)
    twin = copy.deepcopy(net)  # initialised on the CPU, as init_train_state wants
    whole = init_train_state(net, torch.Generator().manual_seed(SEED), device)
    sliced = init_train_state(twin, torch.Generator().manual_seed(SEED), device)
    want = make_train_step(whole)(Batch(**{k: torch.as_tensor(v, device=device)
                                           for k, v in arrays.items()}))
    got = make_train_step(sliced, group)(Batch(**{k: torch.as_tensor(v[rows], device=device)
                                                  for k, v in arrays.items()}))
    for k in ("loss", "grad_norm", "policy_loss", "value_loss"):
        a, b = float(got[k]), float(want[k])
        if not abs(a - b) <= 1e-4 * abs(b):
            raise RuntimeError(f"{world}-rank step on slices: {k} {a}, 1-rank step on the "
                               f"whole {b}")
    err = max(float((p.grad - q.grad).abs().max())
              for p, q in zip(sliced.net.parameters(), whole.net.parameters()))
    if err > 1e-4:
        raise RuntimeError(f"{world}-rank step on slices: gradient off the whole batch's by {err}")
    return err


def mark_stage(work, rank, stage):
    """Record what this rank is doing (read when the ranks miss their
    deadline)."""
    Path(f"{work}/stage{rank}").write_text(stage)


def multirank_rank(rank, work, world, device):
    """One rank of phases 17 and 18 (started with the ``spawn`` method),
    bound by ``initialize_distributed(device=device)``: the slice check, two
    gated iterations with a checkpoint each, the rank's sidecar read back, a
    resumed third iteration and the split match; writes ``rank{r}.json``."""
    import torch
    import torch.distributed as dist

    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.models.network import make_network
    from alphazeroforhnefatafl_tpu_torch.parallel import mesh
    from alphazeroforhnefatafl_tpu_torch.parallel.dryrun import replay_digest
    from alphazeroforhnefatafl_tpu_torch.parallel.launch import (
        initialize_distributed, rank_log_path)
    from alphazeroforhnefatafl_tpu_torch.train.checkpoint import CheckpointManager
    from alphazeroforhnefatafl_tpu_torch.train.learner import init_train_state
    from alphazeroforhnefatafl_tpu_torch.train.replay import ReplayBuffer

    import os

    # The host's cores split between the ranks (torchrun gives each rank one).
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mark_stage(work, rank, "initialize_distributed")
    topo = initialize_distributed(f"file://{work}/store", world, rank, device=device)
    group = dist.group.WORLD
    try:
        mark_stage(work, rank, f"one step on 1/{world} of a batch")
        out = {"backend": topo.backend, "device": str(topo.device),
               "slice_err": slice_check(topo.device, group, rank, world)}
        env = make_env("copenhagen", topo.device)
        ckpt = f"{work}/ckpt"
        config = multirank_config(world, ckpt, 2)
        log_path = rank_log_path(f"{work}/metrics.jsonl", rank)
        replay = ReplayBuffer(env, config.replay_capacity, config.selfplay.policy_k)
        zero_launches()
        mark_stage(work, rank, "run_loop, iterations 0 and 1")
        t0 = time.perf_counter()
        state, _, first = timed_loop(env, config, log_path, replay, group)
        out["first_s"] = time.perf_counter() - t0
        out["first_step"], out["replay"] = state.step, replay_digest(replay)
        # The rank's own sidecar, read back into a fresh replay.
        mark_stage(work, rank, "its sidecar read back")
        fresh = ReplayBuffer(env, config.replay_capacity, config.selfplay.policy_k)
        probe = init_train_state(make_network(env.n, channels=config.channels,
                                              blocks=config.blocks),
                                 torch.Generator().manual_seed(1), topo.device)
        CheckpointManager(ckpt, group=group).restore(probe, fresh)
        out["restored"] = replay_digest(fresh)
        mark_stage(work, rank, "run_loop resumed, iteration 2")
        t0 = time.perf_counter()
        state, lines, second = timed_loop(
            env, multirank_config(world, ckpt, 3), log_path,
            ReplayBuffer(env, config.replay_capacity, config.selfplay.policy_k), group)
        out["second_s"] = time.perf_counter() - t0
        out["launches"] = read_launches()
        out.update(step=state.step, params=digest_int(state.net), lines=lines,
                   arena_s=first["arena_s"] + second["arena_s"],
                   arena_launches={k: first["arena_launches"][k] + second["arena_launches"][k]
                                   for k in first["arena_launches"]},
                   arena_batches=[first["arena_batches"], second["arena_batches"]],
                   arena_gather_s=first["arena_gather_s"] + second["arena_gather_s"],
                   arena_gather_start=first["arena_gather_start"] + second["arena_gather_start"],
                   allreduce_ms=first["allreduce_ms"] + second["allreduce_ms"],
                   allreduce_s=[ms / 1e3 for ms in first["allreduce_ms"] + second["allreduce_ms"]],
                   allreduce_start=first["allreduce_start"] + second["allreduce_start"],
                   digests_checked=first["digests_checked"] + second["digests_checked"])
        out["replays_differ"] = bool(
            len(set(mesh.gather_ints([int(out["replay"][:14], 16)], group)[:, 0])) == world)
        # After the loop's launches are read: the match split over the ranks,
        # counted apart.
        mark_stage(work, rank, "the split match")
        out["split"] = split_match(topo.device, group)
        with open(f"{work}/rank{rank}.json", "w") as f:
            json.dump(out, f)
        mark_stage(work, rank, "done")
    finally:
        dist.destroy_process_group()


def iteration_rates(lines_by_rank, arena_s_by_rank):
    """Per iteration: self-play positions/s summed over the ranks, and the
    ranks' largest self-play, learner and arena seconds."""
    out = []
    for i, rows in enumerate(zip(*[[l for l in lines if "selfplay/games" in l]
                                   for lines in lines_by_rank])):
        out.append({
            "positions_per_s": sum(r["selfplay/positions"] / r["time/selfplay_s"] for r in rows),
            "selfplay_s": max(r["time/selfplay_s"] for r in rows),
            "train_s": max(r["time/train_s"] for r in rows),
            "arena_s": max(a[i] for a in arena_s_by_rank),
        })
    return out


def spawn_or_fail(fn, args, world, timeout, work, what):
    """Spawn ``world`` ranks of ``fn`` (each marks its stage in ``work``);
    fail naming every rank's last stage when one raises or they are not all
    done within ``timeout`` seconds (then they are killed)."""
    from torch.multiprocessing.spawn import ProcessException

    from alphazeroforhnefatafl_tpu_torch.parallel.launch import spawn_ranks

    try:
        spawn_ranks(fn, args, world, timeout)
    except (ProcessException, TimeoutError) as e:
        stages = {r: (Path(work) / f"stage{r}").read_text()
                  if (Path(work) / f"stage{r}").exists() else "not started" for r in range(world)}
        fail(f"{what}: {e}; each rank's last stage: {stages}")


def phase_ranks(device, card, world, rank_device, backend, what):
    """``world`` ranks of ``run_loop`` (:func:`multirank_rank`, each bound by
    ``initialize_distributed(device=rank_device)``) between two world-1
    iterations of the same configuration on ``device``, and the split match
    played whole on ``device``. Holds every rank to ``backend`` and to its
    card (``rank_device="cuda"``: rank r on ``cuda:r``), and to phase 17's
    checks at ``world`` ranks. Returns the measures both phases report."""
    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.train.replay import ReplayBuffer

    env = make_env("copenhagen", device)
    t_phase = time.perf_counter()
    world1, world1_launches, world1_arenas = [], dict.fromkeys(LAUNCH_KEYS, 0), []

    def one_rank_iteration():
        with tempfile.TemporaryDirectory() as tmp:
            config = multirank_config(1, None, 1)
            replay = ReplayBuffer(env, config.replay_capacity, config.selfplay.policy_k)
            zero_launches()
            _, lines, parts = timed_loop(env, config, f"{tmp}/m.jsonl", replay, None)
            for k, v in read_launches().items():
                world1_launches[k] += v
        world1.extend(iteration_rates([lines], [parts["arena_s"]]))
        world1_arenas.append(parts)

    one_rank_iteration()
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        spawn_or_fail(multirank_rank, (work, world, rank_device), world, RANKS_TIMEOUT_S, work,
                      f"{what}: a rank of run_loop")
        ranks_s = time.perf_counter() - t0
        ranks = [json.loads(Path(f"{work}/rank{r}.json").read_text()) for r in range(world)]
    one_rank_iteration()
    whole = split_match(device, None)

    for r, got in enumerate(ranks):
        want_device = f"cuda:{r}" if rank_device == "cuda" else str(rank_device)
        if got["backend"] != backend or got["device"] != want_device:
            fail(f"{what}: rank {r} ran on {got['device']} over {got['backend']}, not on "
                 f"{want_device} over {backend}")
    steps = 3 * MULTIRANK_STEPS
    games = 64 // world  # the arena's games a rank
    for r, got in enumerate(ranks):
        if got["first_step"] != 2 * MULTIRANK_STEPS or got["step"] != steps:
            fail(f"rank {r}: step counts {got['first_step']} and {got['step']}")
        if got["digests_checked"] != steps:
            fail(f"rank {r}: {got['digests_checked']} parameter digests compared in {steps} steps")
        if got["restored"] != got["replay"]:
            fail(f"rank {r}: its sidecar restores another replay than its own")
        resumed = [l["resume/iteration"] for l in got["lines"] if "resume/iteration" in l]
        if resumed != [2.0]:
            fail(f"rank {r}: the second call resumed at {resumed}, not 2")
        if len(got["allreduce_ms"]) != steps:
            fail(f"rank {r}: {len(got['allreduce_ms'])} all-reduces in {steps} steps")
        # An arena ply (64 simulations, L=2) launches one mask and 33 steps,
        # a self-play move (128 simulations) one mask and 65 steps, a
        # learner step one mask.
        n, arena = got["launches"], got["arena_launches"]
        moves = n["legal_mask"] - arena["legal_mask"] - steps
        if not (arena["legal_mask"] > 0 and arena["step"] == 33 * arena["legal_mask"]
                and moves > 0 and n["step"] - arena["step"] == 65 * moves):
            fail(f"rank {r}: launches {n} (arena {arena}) do not split into self-play "
                 f"moves, arena plies and {steps} learner steps")
        # Each rank plays 64 / world of the arena's games: a ply masks them
        # and steps them 32 times at twice as many rows (two leaves a wave)
        # and once at as many.
        for got_b in got["arena_batches"]:
            plies = sum(got_b["legal_mask"].values())
            if tafl(got_b) != {"legal_mask": {str(games): plies},
                               "step": {str(games): plies, str(2 * games): 32 * plies}}:
                fail(f"rank {r}: the arena's launches by batch {got_b} are not those of "
                     f"{games} games a rank")
    for parts in world1_arenas:
        plies = parts["arena_launches"]["legal_mask"]
        if tafl(parts["arena_batches"]) != {"legal_mask": {"64": plies},
                                            "step": {"64": plies, "128": 32 * plies}}:
            fail(f"world 1's arena launched by batch {parts['arena_batches']}, not at 64 games")
    check_split_match(ranks, whole, world)
    if any(got["params"] != ranks[0]["params"] for got in ranks):
        fail("the ranks end with different parameters")
    if not ranks[0]["replays_differ"] or len({got["replay"] for got in ranks}) != world:
        fail("two ranks played the same games")
    arenas = [[{k: v for k, v in l.items() if k.startswith("arena/")} for l in got["lines"]]
              for got in ranks]
    if any(a != arenas[0] for a in arenas):
        fail(f"the ranks' arenas differ: {arenas}")
    worldn = iteration_rates([got["lines"] for got in ranks], [got["arena_s"] for got in ranks])
    # The resumed call's log holds iterations 0-2; its own iteration is the last.
    if len(worldn) != 3:
        fail(f"{len(worldn)} iterations logged across the ranks, not 3")

    w1_rate = float(np.median([w["positions_per_s"] for w in world1]))
    wn_rate = float(np.median([w["positions_per_s"] for w in worldn]))
    allreduce = sorted(ms for got in ranks for ms in got["allreduce_ms"])
    arena_w1 = [a for parts in world1_arenas for a in parts["arena_s"]]
    arena_wn = [got["arena_s"] for got in ranks]
    gathers = sorted(1e3 * g for got in ranks for g in got["arena_gather_s"])
    # perf_counter is one clock for every process of the host: a rank's
    # wait at a collective is the last rank's arrival less its own, and the
    # rest of the collective's time comes after everyone arrived.
    wait = {}
    for name in ("arena_gather", "allreduce"):
        starts = np.array([got[f"{name}_start"] for got in ranks])
        took = np.array([got[f"{name}_s"] for got in ranks])
        waits = starts.max(0) - starts
        wait[name] = {"wait_ms_median": 1e3 * float(np.median(waits)),
                      "after_last_arrival_ms_median": 1e3 * float(np.median(took - waits))}
    split = ranks[0]["split"]
    launches = {k: sum(got["launches"][k] for got in ranks) for k in LAUNCH_KEYS}
    return {
        "steps": steps,
        "summary": {
            "card": card, "backend": backend, "ranks": world,
            "world1": world1, f"world{world}": worldn,
            "selfplay_positions_per_s": {"world1": w1_rate, f"world{world}": wn_rate,
                                         "ratio": wn_rate / w1_rate},
            "allreduce_ms": {"median": float(np.median(allreduce)), "min": allreduce[0],
                             "max": allreduce[-1], "count": len(allreduce)},
            "collective_wait": wait,
            "slice_max_abs_grad_err": max(got["slice_err"] for got in ranks),
            "ranks_seconds": ranks_s, "phase_seconds": time.perf_counter() - t_phase,
            "launches": launches, "world1_launches": world1_launches,
            "arena_seconds": {"world1": arena_w1, f"world{world}_by_rank": arena_wn,
                              "ratio_of_medians": float(np.median(sum(arena_wn, []))
                                                        / np.median(arena_w1))},
            "arena_batches_rank0": ranks[0]["arena_batches"],
            "arena_gather_ms": {
                "count": len(gathers), "median": float(np.median(gathers)),
                "max": gathers[-1], "sum_per_rank": sum(gathers) / world,
                # Each rank's gathers over its arena seconds.
                "share_of_rank_arena_by_rank": [sum(got["arena_gather_s"]) / sum(got["arena_s"])
                                                for got in ranks]},
            "split_match": {
                "games": SPLIT_GAMES, "plies": whole["launches"]["legal_mask"],
                "counts": split["counts"], "fallback": split["fallback"],
                "seconds": {"world1": whole["seconds"],
                            f"world{world}_by_rank": [got["split"]["seconds"] for got in ranks]},
                "batches": {"world1": whole["batches"], f"world{world}_rank0": split["batches"]},
                "gather_ms_median": float(np.median([1e3 * g for got in ranks
                                                     for g in got["split"]["gather_s"]])),
            },
        },
        "launches": {
            "loop": launches, "loop_world1": world1_launches,
            "split_match": {k: sum(got["split"]["launches"][k] for got in ranks)
                            for k in LAUNCH_KEYS},
            "split_match_world1": whole["launches"],
        },
    }


def checked_dryrun(world, device, backend, what):
    """``dryrun_multichip(world, device)`` with every rank held to
    ``backend`` and its card (``device="cuda"``: rank r on ``cuda:r``)."""
    from alphazeroforhnefatafl_tpu_torch.parallel.dryrun import dryrun_multichip

    try:
        dryrun = dryrun_multichip(world, device=device, timeout=DRYRUN_TIMEOUT_S)
    except TimeoutError as e:
        fail(f"{what}: dryrun_multichip({world}) hung in its one iteration: {e}")
    want = [f"cuda:{r}" if device == "cuda" else device for r in range(world)]
    if dryrun["devices"] != want or dryrun["backends"] != [backend] * world:
        fail(f"{what}: dryrun_multichip's ranks ran on {dryrun['devices']} over "
             f"{dryrun['backends']}, not on {want} over {backend}")
    return dryrun


def phase_multirank(device, card):
    """Phase 17: two ranks of ``run_loop`` on the one card ``cuda:0`` over
    gloo, between two world-1 iterations of the same configuration, then
    ``dryrun_multichip(2)`` on that card."""
    got = phase_ranks(device, card, MULTIRANK_RANKS, "cuda:0", "gloo", "phase 17")
    dryrun = checked_dryrun(MULTIRANK_RANKS, "cuda:0", "gloo", "phase 17")
    s = got["summary"]
    s["dryrun_decisive"] = dryrun["arena/decisive"]
    print(json.dumps({"multirank": s}), flush=True)
    rates = s["selfplay_positions_per_s"]
    arena = s["arena_seconds"]
    print(f"multirank on {card}: {MULTIRANK_RANKS} ranks on cuda:0 over {s['backend']}: "
          f"parameters bit-identical after each of {got['steps']} learner steps, replays differ, "
          f"each rank resumed from its own sidecar; self-play positions/s world 1 "
          f"{rates['world1']:.1f}, world 2 {rates['world2']:.1f} (x{rates['ratio']:.3f}); "
          f"all-reduce {s['allreduce_ms']['median']:.3f} ms a step (median); launches "
          f"{s['launches']}; a rank's arena {np.median(sum(arena['world2_by_rank'], [])):.3f} s "
          f"at world 2 against {np.median(arena['world1']):.3f} s at world 1 (median, "
          f"x{arena['ratio_of_medians']:.3f}); the split match equals the whole one in all "
          f"{SPLIT_GAMES} games", flush=True)
    launches = got["launches"]
    return {"multirank": launches["loop"], "multirank_world1": launches["loop_world1"],
            "split_match": launches["split_match"],
            "split_match_world1": launches["split_match_world1"]}


def all_cards() -> list:
    """Every card's ``name, power.limit`` line from ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi failed: {e}")
    return out.stdout.strip().splitlines()


def torchrun_train_run(world):
    """``python -m torch.distributed.run --standalone --nproc-per-node world
    -m alphazeroforhnefatafl_tpu_torch.scripts.train_run`` with phase 16's
    flags (the flagship record cut in depth) in a temporary working directory, under a deadline; the host's cores split
    ``world`` ways. Holds it to exit code 0, rank 0's ``metrics.jsonl`` and
    each ``metrics.rank{r}.jsonl`` with a line an iteration, and every rank
    to ``cuda:r`` over nccl as ``initialize_distributed`` printed it.
    Returns its seconds."""
    import os
    import signal

    from alphazeroforhnefatafl_tpu_torch.scripts.train_run import record_argv

    root = Path(__file__).resolve().parent
    rec = json.loads((root / "runs" / "copenhagen_r4ab_puct" / "config.jsonl")
                     .read_text().splitlines()[-1])
    rec.update(RUN_CUTS, name="across_r4ab", cpu=False)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(world), "-m", "alphazeroforhnefatafl_tpu_torch.scripts.train_run",
           *record_argv(rec)]
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // world)),
               PYTHONPATH=os.pathsep.join(filter(None, [str(root), os.environ.get("PYTHONPATH")])))
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = Path(tmp) / "runs" / rec["name"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=tmp, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, start_new_session=True)
        try:
            out, err = proc.communicate(timeout=TORCHRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)  # torchrun and every rank it started
            out, err = proc.communicate()
            logged = {f.name: len(f.read_text().splitlines())
                      for f in sorted(run_dir.glob("metrics*.jsonl"))}
            fail(f"torchrun train_run not done in {TORCHRUN_TIMEOUT_S} s: iterations logged "
                 f"by file {logged}; the end of its stderr:\n{err[-3000:]}")
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"torchrun train_run exited {proc.returncode}; the end of its stderr:\n"
                 f"{err[-6000:]}")
        files = ["metrics.jsonl"] + [f"metrics.rank{r}.jsonl" for r in range(1, world)]
        rows = {f: len((run_dir / f).read_text().splitlines()) if (run_dir / f).exists() else 0
                for f in files}
        if any(n != rec["iterations"] for n in rows.values()):
            fail(f"torchrun train_run logged {rows} lines, not {rec['iterations']} a rank")
        steps = rec["iterations"] * rec["train_steps"]
        if out.count(f"done: step={steps}") != world:
            fail(f"torchrun train_run: {out.count(f'done: step={steps}')} ranks ended at step "
                 f"{steps}, not {world}:\n{out}")
        for r in range(world):
            bound = f"initialize_distributed: rank {r} of {world} on cuda:{r},"
            if not any(line.startswith(bound) and line.endswith("backend nccl")
                       for line in err.splitlines()):
                fail(f"torchrun train_run: rank {r} did not report {bound!r} ... backend nccl; "
                     f"stderr:\n{err[-3000:]}")
    print(f"torchrun train_run: {world} ranks, {rows} lines logged, {seconds:.2f} s", flush=True)
    return seconds


def phase_across_cards(device, card, world):
    """Phase 18: the loop across ``world`` cards, one rank a card, over
    NCCL: ``dryrun_multichip(world)``, ``world`` ranks of phase 17's
    ``run_loop`` with the split match, and ``torchrun ... train_run``; one
    line ``{"across_cards": {...}}``."""
    t_phase = time.perf_counter()
    cards = all_cards()
    dryrun = checked_dryrun(world, "cuda", "nccl", "phase 18")
    got = phase_ranks(device, card, world, "cuda", "nccl", "phase 18")
    torchrun_s = torchrun_train_run(world)
    s = got["summary"]
    s.update(cards=cards, dryrun_decisive=dryrun["arena/decisive"],
             torchrun_train_run_seconds=torchrun_s,
             phase_seconds=time.perf_counter() - t_phase)
    print(json.dumps({"across_cards": s}), flush=True)
    rates, arena, gather = s["selfplay_positions_per_s"], s["arena_seconds"], s["arena_gather_ms"]
    wait = s["collective_wait"]
    print(f"across cards on {world} x {card}: one rank a card over {s['backend']}: parameters "
          f"bit-identical after each of {got['steps']} learner steps; self-play positions/s "
          f"world 1 {rates['world1']:.1f}, world {world} {rates[f'world{world}']:.1f} "
          f"(x{rates['ratio']:.3f}); all-reduce {s['allreduce_ms']['median']:.3f} ms a step "
          f"(median; {wait['allreduce']['wait_ms_median']:.3f} ms of it waiting for the last "
          f"rank); a rank's arena {np.median(sum(arena[f'world{world}_by_rank'], [])):.3f} s "
          f"against {np.median(arena['world1']):.3f} s at world 1; the per-ply gather "
          f"{gather['median']:.3f} ms (median; {wait['arena_gather']['wait_ms_median']:.3f} ms "
          f"of it waiting), {max(gather['share_of_rank_arena_by_rank']):.4f} of a rank's arena "
          f"at most; the split match equals the whole one in all {SPLIT_GAMES} games; torchrun "
          f"train_run {torchrun_s:.2f} s", flush=True)
    return {"across_cards": got["launches"]["loop"],
            "across_cards_world1": got["launches"]["loop_world1"],
            "across_cards_split_match": got["launches"]["split_match"],
            "across_cards_split_match_world1": got["launches"]["split_match_world1"]}


def check_split_match(ranks, whole, world):
    """The split match against the whole one: every game's result, the
    counts and the tie-break generator's state equal, the fallback rate
    within 1e-6 relative (the order of a float32 sum differs); every rank
    masks and steps 64 / ``world`` games (twice the rows in a two-leaf wave)
    where the whole match masks and steps 64."""
    games = SPLIT_GAMES // world
    for r, got in enumerate(ranks):
        split = got["split"]
        for key in ("outcomes", "counts", "generator"):
            if split[key] != whole[key]:
                fail(f"rank {r}: the split match's {key} {split[key]} differ from the whole "
                     f"match's {whole[key]}")
        if not abs(split["fallback"] - whole["fallback"]) <= 1e-6 * whole["fallback"]:
            fail(f"rank {r}: fallback rate {split['fallback']}, whole match {whole['fallback']}")
        plies = whole["launches"]["legal_mask"]
        want = {"legal_mask": {str(games): plies},
                "step": {str(games): plies, str(2 * games): 4 * plies}}
        if tafl(split["batches"]) != want:
            fail(f"rank {r}: the split match launched by batch {split['batches']}, not {want}")
    plies = whole["launches"]["legal_mask"]
    if tafl(whole["batches"]) != {"legal_mask": {"64": plies},
                                  "step": {"64": plies, "128": 4 * plies}}:
        fail(f"the whole match launched by batch {whole['batches']}")
    c = whole["counts"]
    if sum(c) != SPLIT_GAMES or c[0] + c[1] < 1 or not 0 < whole["fallback"] < 1:
        fail(f"the split match decided nothing: counts {c}, fallback {whole['fallback']}")


#: Phase 19's cuts of the flagship record (``runs/copenhagen_r4ab_puct/
#: config.jsonl``, last line), in simulations and counts only: one iteration
#: with its arena, 256 games at a self-play batch of 256, self-play at 32
#: simulations and the arena at 16 (both at the record's two leaves a
#: wave), 20 learner steps (at the record's batch of 512) and a ring of
#: 40,960 positions. Plies (games of 256, arena games of 300), the net's
#: width, the temperature switch, resignation, the gate and the minimum
#: replay stay the record's. The iteration's games write about 54,000
#: positions, so the ring wraps; but the rows still on their first game
#: are all truncated at the last move and write about 26,000 positions of
#: value 0 at once (101 games of 256 plies on the H100), so a ring of
#: 16,384 holds those alone and the learner sees no decided target. At
#: 40,960 it also holds the games decided before them.
WHOLE_GAME_CUTS = {"iterations": 1, "arena_every": 1, "games": 256, "selfplay_batch": 256,
                   "sims": 32, "arena_sims": 16, "train_steps": 20,
                   "replay_capacity": 40960}
#: Moves (self-play) and plies (arena) from which every recorded step is held
#: against the kernels' plain versions.
LATE_PLY = 100
#: The second self-play, where the record's resignation threshold fired no
#: resignation: this many games at a batch of this many.
RESIGN_GAMES = 64
STATE_FIELDS = ("board", "side_to_play", "recent_plays", "rep_first_i", "reps", "mid_pair",
                "plays_since_capture", "turn", "terminated", "result", "reason")
INFO_FIELDS = ("captures", "n_captures", "terminated", "result", "reason", "reward_mover",
               "invalid")
#: How a game ended: the env's reason codes (``core/rules.py`` ``WinReason``;
#: draws at 16 + ``DrawReason``), then the two ends that the self-play
#: actor makes itself.
END_REASONS = {0: "king_escape", 1: "exit_fort", 2: "capture", 3: "capture", 4: "encirclement",
               5: "no_moves", 6: "repetition", 16: "repetition", 17: "no_moves"}
END_NAMES = ("king_escape", "capture", "encirclement", "exit_fort", "repetition", "no_moves",
             "resigned", "truncated")


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_state(states) -> dict:
    """An ``EnvState`` batch as numpy arrays, field by field."""
    return {f: getattr(states, f).cpu().numpy() for f in STATE_FIELDS}


def device_state(state: dict, device):
    """A :func:`host_state` record back on ``device``."""
    import torch

    from alphazeroforhnefatafl_tpu_torch.core.env import EnvState

    return EnvState(**{f: torch.as_tensor(v, device=device) for f, v in state.items()})


def row(state: dict, r: int) -> dict:
    return {f: v[r] for f, v in state.items()}


def same_row(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[f], b[f]) for f in a)


class GameRecorder:
    """Records on the host every move-level env step of self-play and of the
    arena: the states before and after, the actions, and the step's info
    (all but the next mask, which the kernel checks recompute). Of the
    search's leaf steps it keeps one wave a self-play move, the middle one.
    It also keeps the rows that each self-play move restarted, every game
    written to the replay, every sample the learner draws, every learner
    step's metrics, each move's root values, the arena's result and seconds,
    and the loop's config.

    :meth:`installed` wraps, for the length of a block, the class methods
    ``TaflEnv.step_many``, ``MCTS.search``, ``SelfPlayActor.play`` and ``.move``,
    ``ReplayBuffer.add`` and ``ReplayBuffer.sample``, and the module
    functions ``arena._play``, ``selfplay.where_state``,
    ``loop.make_train_step`` and ``train_run.run_loop``: the entry points
    run as they are, and only their calls are seen."""

    def __init__(self):
        self.steps = {"selfplay": [], "arena": []}
        self.env = None
        self.waves = []
        self.ended = {}
        self.adds = []
        self.samples = []
        self.train_metrics = []
        self.actors = []
        self.stats = []
        self.root_values = []
        self.arena_results = []
        self.seconds = {"selfplay": 0.0, "arena": 0.0}
        self.replay = None
        self.loop_config = None
        self.path = None
        self._wave = None  # [waves seen, the one to keep] inside a search

    def _record(self, states, actions, new, info) -> dict:
        return {"before": host_state(states), "actions": actions.cpu().numpy(),
                "after": host_state(new),
                "info": {f: getattr(info, f).cpu().numpy() for f in INFO_FIELDS}}

    @contextlib.contextmanager
    def installed(self):
        from alphazeroforhnefatafl_tpu_torch.core.env import TaflEnv
        from alphazeroforhnefatafl_tpu_torch.scripts import train_run
        from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTS
        from alphazeroforhnefatafl_tpu_torch.train import arena, loop, selfplay
        from alphazeroforhnefatafl_tpu_torch.train.replay import ReplayBuffer

        rec, patches = self, []

        def wrap(owner, name):
            """Decorate ``make(real) -> wrapper``: ``owner.name`` becomes the
            wrapper until the block ends."""
            def install(make):
                real = owner.__dict__[name]
                patches.append((owner, name, real))
                setattr(owner, name, make(real))
            return install

        @wrap(TaflEnv, "step_many")
        def _(real):
            def step_many(env, states, actions):
                new, info = real(env, states, actions)
                rec.env = env
                if rec._wave is not None:
                    if rec._wave[0] == rec._wave[1]:
                        rec.waves.append(rec._record(states, actions, new, info))
                    rec._wave[0] += 1
                elif rec.path is not None:
                    rec.steps[rec.path].append(rec._record(states, actions, new, info))
                return new, info
            return step_many

        @wrap(MCTS, "search")
        def _(real):
            def search(mcts, *args, **kw):
                cfg = mcts.config
                keep = cfg.num_simulations // cfg.leaves_per_wave // 2
                rec._wave = [0, keep if rec.path == "selfplay" else -1]
                try:
                    return real(mcts, *args, **kw)
                finally:
                    rec._wave = None
            return search

        @wrap(selfplay.SelfPlayActor, "play")
        def _(real):
            def play(actor, *args, **kw):
                rec.actors.append(actor)
                rec.path = "selfplay"
                _sync(actor.device)
                t0 = time.perf_counter()
                try:
                    stats = real(actor, *args, **kw)
                finally:
                    rec.path = None
                _sync(actor.device)
                rec.seconds["selfplay"] += time.perf_counter() - t0
                rec.stats.append(stats)
                return stats
            return play

        @wrap(selfplay.SelfPlayActor, "move")
        def _(real):
            def move(actor, states, *args, **kw):
                out = real(actor, states, *args, **kw)
                rec.root_values.append((out[5].cpu().numpy(), states.turn.cpu().numpy()))
                return out
            return move

        @wrap(arena, "_play")
        def _(real):
            def _play(env, *args, **kw):
                rec.path = "arena"
                _sync(env.device)
                t0 = time.perf_counter()
                try:
                    result = real(env, *args, **kw)
                finally:
                    rec.path = None
                _sync(env.device)
                rec.seconds["arena"] += time.perf_counter() - t0
                rec.arena_results.append(result)
                return result
            return _play

        @wrap(selfplay, "where_state")
        def _(real):
            def where_state(mask, a, b):
                rec.ended[len(rec.steps["selfplay"]) - 1] = mask.cpu().numpy().copy()
                return real(mask, a, b)
            return where_state

        @wrap(ReplayBuffer, "add")
        def _(real):
            def add(buf, *arrays):
                rec.replay = buf
                rec.adds.append((len(rec.steps["selfplay"]) - 1,
                                 tuple(np.array(a) for a in arrays)))
                return real(buf, *arrays)
            return add

        @wrap(ReplayBuffer, "sample")
        def _(real):
            def sample(buf, rng, batch_size):
                probe = np.random.RandomState()
                probe.set_state(rng.get_state())
                slots = probe.randint(0, buf.size, size=batch_size)
                out = real(buf, rng, batch_size)
                rec.samples.append((slots, buf.total_added, out))
                return out
            return sample

        @wrap(loop, "make_train_step")
        def _(real):
            def make_train_step(*args, **kw):
                step = real(*args, **kw)

                def train_step(batch):
                    metrics = step(batch)
                    got = {k: float(v) for k, v in metrics.items()}
                    got["decided_targets"] = int((batch.value_target.abs() == 1).sum())
                    rec.train_metrics.append(got)
                    return metrics
                return train_step
            return make_train_step

        @wrap(train_run, "run_loop")
        def _(real):
            def run_loop(env, config, *args, **kw):
                rec.loop_config = config
                return real(env, config, *args, **kw)
            return run_loop

        try:
            yield self
        finally:
            for owner, name, real in reversed(patches):
                setattr(owner, name, real)


def selfplay_games(rec: GameRecorder, cap: int) -> list:
    """The self-play games that ended, in the order the actor wrote them to
    the replay, each a dict: its row, the batched move it started at, its
    actions, the states before each of its moves, how it ended and its last
    state. Fails unless every row carries its game from one move to the
    next, a row restarts from the fresh state exactly after its game ended,
    and every terminated game and every game at its cap ended."""
    steps = rec.steps["selfplay"]
    B = len(steps[0]["actions"])
    fresh = row(steps[0]["before"], 0)
    start = np.zeros(B, np.int64)
    acts = [[] for _ in range(B)]
    befores = [[] for _ in range(B)]
    prev_end = np.ones(B, bool)
    games = []
    for m, st in enumerate(steps):
        before, after = st["before"], st["after"]
        for r in range(B):
            want = fresh if prev_end[r] else row(steps[m - 1]["after"], r)
            if not same_row(row(before, r), want):
                fail(f"self-play move {m} row {r}: the state is neither the row's last one "
                     f"nor, after its game ended, a fresh game")
            acts[r].append(int(st["actions"][r]))
            befores[r].append(row(before, r))
        end = rec.ended.get(m, np.zeros(B, bool))
        must = after["terminated"] | (after["turn"] >= cap)
        if (must & ~end).any():
            fail(f"self-play move {m}: rows {np.nonzero(must & ~end)[0].tolist()} "
                 "terminated or reached the cap and played on")
        for r in np.nonzero(end)[0]:
            last = row(after, r)
            if last["terminated"]:
                how = END_REASONS[int(last["reason"])]
            elif last["turn"] >= cap:
                how = "truncated"
            else:
                how = "resigned"
            games.append({"row": int(r), "first_move": int(start[r]), "end_move": m,
                          "actions": acts[r], "befores": befores[r], "how": how, "last": last})
            start[r], acts[r], befores[r] = m + 1, [], []
        prev_end = end
    return games


def check_selfplay_replay(rec: GameRecorder, games: list) -> dict:
    """Each game's replay write against its moves: the positions are the
    states before its moves (board, side to move, the mover's repetition
    count), and the value targets are the game's outcome for each mover: +1
    on the winner's positions and -1 on the loser's for a decided game (a
    resigned game is lost by the side that resigned, the mover of its last
    position), 0 on a drawn or truncated one. Returns the counts."""
    if len(rec.adds) != len(games):
        fail(f"the replay took {len(rec.adds)} games, the moves ended {len(games)}")
    decided = 0
    for g, (move, (board, side, reps, _, _, z)) in zip(games, rec.adds):
        what = f"self-play game of row {g['row']} from move {g['first_move']}"
        if move != g["end_move"] or len(board) != len(g["actions"]):
            fail(f"{what}: written at move {move} with {len(board)} positions; it ended at "
                 f"move {g['end_move']} after {len(g['actions'])}")
        want_side = np.array([b["side_to_play"] for b in g["befores"]], np.int8)
        want_reps = np.array([b["reps"][b["side_to_play"]] for b in g["befores"]], np.int8)
        if not (np.array_equal(board, np.stack([b["board"] for b in g["befores"]]))
                and np.array_equal(side, want_side) and np.array_equal(reps, want_reps)):
            fail(f"{what}: the replay's positions are not the game's")
        last = g["last"]
        if g["how"] == "resigned":
            winner = 1 - int(side[-1])
        elif g["how"] == "truncated" or int(last["result"]) == 2:
            winner = None
        else:
            winner = int(last["result"])
        want = (np.zeros(len(z), np.float32) if winner is None
                else np.where(side == winner, 1.0, -1.0).astype(np.float32))
        if not np.array_equal(z, want):
            fail(f"{what}: value targets {np.unique(z).tolist()} for a game that ended by "
                 f"{g['how']} (winner {winner})")
        decided += winner is not None
    return {"decided": decided}


def check_ring(rec: GameRecorder) -> dict:
    """The replay ring after the iteration's games: it holds exactly the
    last ``capacity`` positions written, each in its slot, and every sample
    the learner drew returned positions of those (each the newest position
    written to its slot), not positions that the wrap overwrote."""
    buf = rec.replay
    cap = buf.capacity
    written = [np.concatenate([a[i] for _, a in rec.adds]) for i in range(6)]
    total = len(written[0])
    if buf.total_added != total or total <= cap:
        fail(f"the ring of {cap} took {buf.total_added} positions ({total} written): "
             "it did not wrap")
    slots = np.arange(total - cap, total) % cap
    fields = ("board", "side", "reps", "policy_idx", "policy_p", "value")
    for name, w in zip(fields, written):
        if not np.array_equal(getattr(buf, name)[slots], w[total - cap:]):
            fail(f"after the wrap the ring's {name} is not the last {cap} positions written")
    if not rec.samples:
        fail("the learner drew no sample from the ring")
    for slot, at, sample in rec.samples:
        newest = at - 1 - (at - 1 - slot) % cap
        if (newest < at - cap).any():
            fail("a sample's slot holds no position")
        for name, w in zip(fields, written):
            if not np.array_equal(getattr(sample, name), w[newest]):
                fail(f"a sample's {name} is not the newest position of its slot")
    return {"written": total, "capacity": cap, "samples": len(rec.samples)}


def arena_games(rec: GameRecorder, cap: int) -> list:
    """The arena's games, one a row: its actions up to its end, the states
    before them, how it ended and its last state. Fails unless every row
    carries its state from one ply to the next, and every ply of a game that
    had ended left its state unchanged and set ``info.invalid``. Returns
    the games and the count of those frozen steps."""
    steps = rec.steps["arena"]
    B = len(steps[0]["actions"])
    games = [{"row": r, "actions": [], "befores": [], "last": None, "how": "truncated"}
             for r in range(B)]
    frozen = 0
    for p, st in enumerate(steps):
        before, after, info = st["before"], st["after"], st["info"]
        for r, g in enumerate(games):
            b, a = row(before, r), row(after, r)
            if p and not same_row(b, row(steps[p - 1]["after"], r)):
                fail(f"arena ply {p} row {r}: the state is not the row's last one")
            if b["terminated"]:
                frozen += 1
                if not same_row(a, b) or not info["invalid"][r]:
                    fail(f"arena ply {p} row {r}: the step of an ended game changed its state "
                         "or did not set info.invalid")
                continue
            g["actions"].append(int(st["actions"][r]))
            g["befores"].append(b)
            g["last"] = a
            if a["terminated"]:
                g["how"] = END_REASONS[int(a["reason"])]
    if len(steps) > cap:
        fail(f"the arena played {len(steps)} plies, past its cap of {cap}")
    outcomes = tuple(int(g["last"]["result"]) if g["last"]["terminated"] else -2 for g in games)
    if rec.arena_results[-1].outcomes != outcomes:
        fail(f"the arena's outcomes {rec.arena_results[-1].outcomes} are not its games' "
             f"{outcomes}")
    return games, frozen


def oracle_replay(job):
    """Replays one game through the port's ``core/oracle.py`` from the start
    FEN: ``job`` is ``(preset, actions)``. Every action must be a legal play
    there. Returns, per ply, the position before the play (board, side to
    move, the mover's repetition count) and the state after the last play
    in the env's terms, or ``{"error": ...}``. A module-level function, so
    that a process pool can run it."""
    from alphazeroforhnefatafl_tpu_torch.core import actions as A
    from alphazeroforhnefatafl_tpu_torch.core import oracle
    from alphazeroforhnefatafl_tpu_torch.core.fen import board_from_fen
    from alphazeroforhnefatafl_tpu_torch.core.rules import PRESETS

    preset, actions = job
    rules, board_fen = PRESETS[preset]
    n = board_from_fen(board_fen).shape[0]
    logic = oracle.GameLogic(rules, n)
    state = oracle.GameState.from_fen(board_fen, rules.starting_side)
    boards, sides, reps = [], [], []
    for i, action in enumerate(actions):
        if not state.ongoing:
            return {"error": f"ply {i}: a play after the game ended"}
        side = int(state.side_to_play)
        r = state.repetitions
        boards.append(state.board.copy())
        sides.append(side)
        reps.append(r.defender_reps if side else r.attacker_reps)
        try:
            state, _, _ = logic.do_play(oracle.Play.from_tiles(*A.decode_to_tiles(n, action)),
                                        state)
        except oracle.InvalidPlayError as e:
            return {"error": f"ply {i}: {e}"}
    r, o = state.repetitions, state.outcome
    if o is None:
        result, reason = -1, -1
    elif o.winner is None:
        result, reason = 2, 16 + int(o.draw_reason)
    else:
        result, reason = int(o.winner), int(o.win_reason)
    return {"boards": np.stack(boards), "sides": np.array(sides), "reps": np.array(reps),
            "final": {"board": state.board, "reps": np.array([r.attacker_reps, r.defender_reps]),
                      "mid_pair": np.array([r.attacker_mid_pair, r.defender_mid_pair]),
                      "plays_since_capture": state.plays_since_capture, "turn": state.turn,
                      "side_to_play": int(state.side_to_play), "result": result,
                      "reason": reason}}


def check_oracle(preset: str, games: list, what: str, processes: int = 1) -> int:
    """Every game of ``games`` replayed through the oracle (in ``processes``
    worker processes): every action legal, every position before a move the
    env's, and the last state's board, side to move, result, reason,
    repetition counts and pairs, plays since a capture and turn the env's.
    Returns the plies replayed."""
    jobs = [(preset, g["actions"]) for g in games]
    if processes > 1:
        import multiprocessing

        with multiprocessing.get_context("spawn").Pool(processes) as pool:
            out = pool.map(oracle_replay, jobs, chunksize=4)
    else:
        out = [oracle_replay(job) for job in jobs]
    for i, (g, got) in enumerate(zip(games, out)):
        name = f"{what} game {i} (row {g['row']}, ended by {g['how']})"
        if "error" in got:
            fail(f"{name}: the oracle refuses its transcript: {got['error']}")
        b = g["befores"]
        if not (np.array_equal(got["boards"], np.stack([x["board"] for x in b]))
                and np.array_equal(got["sides"], [x["side_to_play"] for x in b])
                and np.array_equal(got["reps"], [x["reps"][x["side_to_play"]] for x in b])):
            fail(f"{name}: a position before a move differs from the oracle's")
        for field, want in got["final"].items():
            if not np.array_equal(g["last"][field], want):
                fail(f"{name}: the last state's {field} is {g['last'][field]}, the oracle's "
                     f"{want}")
    return sum(len(g["actions"]) for g in games)


def check_recorded_kernels(rec: GameRecorder, checker: KernelCheck, device,
                           rows: int = 4096) -> dict:
    """Both kernels against their plain versions, bit for bit, on the
    recorded inputs of every self-play move and arena ply from
    :data:`LATE_PLY` on (ended arena games among them) and of every sampled
    wave: kernel 2 field by field and kernel 1 on the same states
    (:class:`KernelCheck`), and the step the run took (the state after and
    the info) equal to the env's step of the same inputs through the kernel
    now. A game's step depends on its own row alone, so consecutive
    recorded steps of a path are checked together, up to ``rows`` rows a
    call. Returns the steps checked by path."""
    import torch

    def cat(dicts):
        return {f: np.concatenate([d[f] for d in dicts]) for f in dicts[0]}

    checked = {}
    for path, steps, first in (("selfplay", rec.steps["selfplay"], LATE_PLY),
                               ("arena", rec.steps["arena"], LATE_PLY),
                               ("wave", rec.waves, 0)):
        env, todo = rec.env, steps[first:]
        per = max(1, rows // len(todo[0]["actions"])) if todo else 1
        for i in range(0, len(todo), per):
            part = todo[i:i + per]
            what = f"recorded {path} steps {first + i}-{first + i + len(part) - 1}"
            states = device_state(cat([st["before"] for st in part]), device)
            actions = torch.as_tensor(np.concatenate([st["actions"] for st in part]),
                                      device=device)
            checker.check(env, states, actions, what)
            new, info = env.step_many(states, actions)
            want = cat([st["info"] for st in part])
            if not same_row(host_state(new), cat([st["after"] for st in part])) or not all(
                    np.array_equal(getattr(info, f).cpu().numpy(), want[f])
                    for f in INFO_FIELDS):
                fail(f"{what}: the run's step differs from the same step taken again")
        checked[path] = len(todo)
    return checked


def check_launches(rec: GameRecorder, batches: dict, cfg) -> dict:
    """The launches of the run by batch, exactly: kernel 1 once a self-play
    move (at the self-play batch), once a learner step (at the learner's
    batch) and once an arena ply (at the arena's games); kernel 2 ``sims /
    L`` times a move at ``L`` rows a game and once at the batch, and
    ``arena_sims / L`` times a ply and once; the GroupNorm kernel 14 times
    a forward: a self-play move's ``sims / L`` waves at ``L`` rows a game
    and its root at the batch, an arena ply's waves and root in two halves
    (the candidate's games and the incumbent's), the learner never."""
    moves, plies, steps = (len(rec.steps["selfplay"]), len(rec.steps["arena"]),
                           len(rec.train_metrics))
    B, G, L = cfg.selfplay.batch_size, cfg.arena_games, cfg.mcts.leaves_per_wave
    want = {"legal_mask": {}, "step": {}, "group_norm": {}}

    def add(kernel, batch, count):
        if count:
            want[kernel][str(batch)] = want[kernel].get(str(batch), 0) + count

    add("legal_mask", B, moves)
    add("legal_mask", cfg.train_batch_size, steps)
    add("legal_mask", G, plies)
    add("step", B * L, moves * (cfg.mcts.num_simulations // L))
    add("step", B, moves)
    add("step", G * L, plies * (cfg.arena_sims // L))
    add("step", G, plies)
    add("group_norm", B * L, SITES * moves * (cfg.mcts.num_simulations // L))
    add("group_norm", B, SITES * moves)
    add("group_norm", G * L // 2, 2 * SITES * plies * (cfg.arena_sims // L))
    add("group_norm", G // 2, 2 * SITES * plies)
    if batches != want:
        fail(f"whole games launched {batches} by batch, not {want}")
    return {k: sum(v.values()) for k, v in batches.items()}


def profile_move(rec: GameRecorder, move: int) -> dict:
    """``torch.profiler`` over one self-play move of the recorded batch at
    batched move ``move`` (after a warm move from it): the card's busy
    milliseconds (the union of its kernels and copies), their share of the
    profiled move's wall time and of the median of three unprofiled moves
    (the profiler slows the host, so the first share understates what the
    card does in a move without it), and the two ported kernels' share of
    the card's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alphazeroforhnefatafl_tpu_torch.scripts.analyze_trace import union_ms

    actor = rec.actors[0]
    st = rec.steps["selfplay"][move]["before"]
    states = device_state(st, actor.device)
    temps = torch.as_tensor((st["turn"] < actor.cfg.temp_threshold).astype(np.float32),
                            device=actor.device)
    gen = torch.Generator(device=actor.device).manual_seed(SEED)
    actor.move(states, temps, gen)
    plain_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        actor.move(states, temps, gen)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        actor.move(states, temps, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not on_card:
        return {"busy_share": "not measured", "kernels_share": "not measured"}
    spans = [(e.time_range.start, e.time_range.end) for e in on_card]
    lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
    busy_ms = union_ms(spans, lo, hi)
    total = sum(e.time_range.elapsed_us() for e in on_card)
    ours = {k: sum(e.time_range.elapsed_us() for e in on_card if k in e.name)
            for k in ("tafl_legal_mask_kernel", "tafl_step_kernel")}
    move_ms = float(np.median(plain_ms))
    return {"move": move, "profiled_ms": wall_ms, "move_ms": move_ms, "busy_ms": busy_ms,
            "busy_share_profiled": busy_ms / wall_ms, "busy_share": busy_ms / move_ms,
            "events": len(on_card),
            "kernels_share": {k: v / total for k, v in ours.items()}}


def resign_threshold_from(rec: GameRecorder, min_moves: int) -> float:
    """A threshold at which a net resigns: minus the median of the root
    values that the movers of the recorded self-play saw from move
    ``min_moves`` on, so that half of those positions lie below it."""
    values = np.concatenate([v[t >= min_moves] for v, t in rec.root_values])
    return float(-np.median(values))


def end_split(games: list) -> dict:
    split = dict.fromkeys(END_NAMES, 0)
    for g in games:
        split[g["how"]] += 1
    return split


def checked_selfplay(rec: GameRecorder, cap: int):
    """The recorded self-play's games (:func:`selfplay_games`), held to the
    actor's own counts and to their replay writes
    (:func:`check_selfplay_replay`). Returns the games, how they ended and
    how many were decided."""
    games = selfplay_games(rec, cap)
    split = end_split(games)
    stats = rec.stats[0]
    if (stats.games, stats.resigned, stats.truncated) != (
            len(games), split["resigned"], split["truncated"]):
        fail(f"self-play counted {stats.games} games, {stats.resigned} resigned and "
             f"{stats.truncated} truncated; its moves ended {len(games)}: {split}")
    return games, split, check_selfplay_replay(rec, games)["decided"]


def phase_whole_games(device, card, checker, phase5_rate):
    """Phase 19: the flagship record's iteration through ``train_run.main``,
    every game played to its end, recorded and checked (see the module's
    docstring); then, where the record's threshold fired no resignation, a
    second self-play at a lower one. Returns the launches of the two runs."""
    import os

    import torch

    from alphazeroforhnefatafl_tpu_torch.scripts import train_run
    from alphazeroforhnefatafl_tpu_torch.train.loop import gate_passes
    from alphazeroforhnefatafl_tpu_torch.train.replay import ReplayBuffer
    from alphazeroforhnefatafl_tpu_torch.train.selfplay import SelfPlayActor

    root = Path(__file__).resolve().parent
    rec_line = json.loads((root / "runs" / "copenhagen_r4ab_puct" / "config.jsonl")
                          .read_text().splitlines()[-1])
    rec_line.update(WHOLE_GAME_CUTS, name="whole_r4ab", cpu=torch.device(device).type == "cpu")
    t_phase = time.perf_counter()
    rec = GameRecorder()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            with rec.installed():
                zero_launches()
                before = read_batches()
                rc, out, err = captured(train_run.main, train_run.record_argv(rec_line))
                _sync(device)
                batches = batches_since(before)
                plain = read_launches()["norm_plain"]
            if rc != 0:
                fail(f"phase 19 train_run returned {rc}; stderr:\n{err}")
            metrics = json.loads((Path(tmp) / "runs" / "whole_r4ab" / "metrics.jsonl")
                                 .read_text().splitlines()[-1])
        finally:
            os.chdir(cwd)
    run_s = time.perf_counter() - t_phase
    cfg = rec.loop_config
    launches = check_launches(rec, batches, cfg)
    # Only the learner's forwards (grad on) take the plain chain.
    if plain != SITES * len(rec.train_metrics):
        fail(f"whole games took the plain chain at {plain} GroupNorm sites, not 14 in each of "
             f"{len(rec.train_metrics)} learner steps")
    launches["norm_plain"] = plain
    sp_cfg = cfg.selfplay

    # (a) every game ends, rows restart mid-batch; (d) the replay.
    games, split, decided = checked_selfplay(rec, sp_cfg.max_game_len)
    stats = rec.stats[0]
    starts = sorted({g["first_move"] for g in games})
    restarts = sum(g["first_move"] > 0 for g in games)
    if restarts == 0 or len(starts) < 2:
        fail(f"no self-play row restarted while the others played on (starts {starts})")
    if decided == 0:
        fail(f"no self-play game was decided: {split}")
    ring = check_ring(rec)

    # (b) the oracle; (c) the kernels on the late and ended steps.
    a_games, frozen = arena_games(rec, cfg.arena_max_game_len)
    workers = max(1, min(8, (os.cpu_count() or 1) - 1))
    t0 = time.perf_counter()
    plies = check_oracle(cfg.preset, games, "self-play", workers)
    plies += check_oracle(cfg.preset, a_games, "arena", workers)
    oracle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernel_checked = check_recorded_kernels(rec, checker, device)
    kernel_s = time.perf_counter() - t0

    # (e) the learner; (f) the gate.
    losses = rec.train_metrics
    if len(losses) != cfg.train_steps_per_iteration or not all(
            np.isfinite(list(m.values())).all() for m in losses):
        fail(f"the learner took {len(losses)} steps with metrics {losses}")
    if not all(m["value_loss"] > 0 for m in losses) or not any(
            m["decided_targets"] for m in losses):
        fail(f"the learner fitted no decided value target: {losses}")
    result = rec.arena_results[0]
    if result.decisive_games < cfg.gate_min_decisive:
        fail(f"the arena reached {result.decisive_games} decisive games, fewer than "
             f"{cfg.gate_min_decisive}: raise its simulations toward the record's 64 "
             f"({result.as_dict()})")
    passed = gate_passes(cfg, result)
    if metrics.get("arena/promoted") != float(passed):
        fail(f"the loop promoted {metrics.get('arena/promoted')}, gate_passes says {passed}")

    late = next((m for m, st in enumerate(rec.steps["selfplay"])
                 if m >= LATE_PLY and st["before"]["turn"].max() >= LATE_PLY), None)
    if late is None:
        fail(f"self-play made no move past move {LATE_PLY}")
    profile = profile_move(rec, late)

    # Resignation, on the card: under the record's threshold, else lower.
    resign = {"threshold": sp_cfg.resign_threshold, "games": stats.games,
              "resigned": stats.resigned, "resign_fp_rate": stats.as_dict()["resign_fp_rate"],
              "resign_checked": stats.resign_checked, "launches": None}
    if stats.resigned == 0:
        threshold = resign_threshold_from(rec, sp_cfg.resign_min_moves)
        second = GameRecorder()
        actor = rec.actors[0]
        small = SelfPlayActor(actor.env, actor.evaluate, actor.mcts.config,
                              dataclasses.replace(sp_cfg, batch_size=RESIGN_GAMES,
                                                  resign_threshold=threshold))
        with second.installed():
            zero_launches()
            before = read_batches()
            small.play(ReplayBuffer(actor.env, RESIGN_GAMES * sp_cfg.max_game_len,
                                    sp_cfg.policy_k),
                       torch.Generator(device=device).manual_seed(SEED), RESIGN_GAMES)
            _sync(device)
            r_batches = batches_since(before)
            r_plain = read_launches()["norm_plain"]
        r_stats = second.stats[0]
        _, r_split, _ = checked_selfplay(second, sp_cfg.max_game_len)
        L, sims = cfg.mcts.leaves_per_wave, cfg.mcts.num_simulations
        moves = len(second.steps["selfplay"])
        want = {"legal_mask": {str(RESIGN_GAMES): moves},
                "step": {str(RESIGN_GAMES * L): moves * (sims // L), str(RESIGN_GAMES): moves},
                "group_norm": {str(RESIGN_GAMES * L): SITES * moves * (sims // L),
                               str(RESIGN_GAMES): SITES * moves}}
        if r_batches != want or r_plain != 0:
            fail(f"the resignation run launched {r_batches} by batch, not {want}, and took "
                 f"the plain chain at {r_plain} GroupNorm sites")
        if r_stats.resigned == 0:
            fail(f"no game resigned at threshold {threshold} either")
        resign = {"threshold": threshold, "games": r_stats.games, "resigned": r_stats.resigned,
                  "resign_fp_rate": r_stats.as_dict()["resign_fp_rate"],
                  "resign_checked": r_stats.resign_checked, "split": r_split,
                  "seconds": second.seconds["selfplay"],
                  "launches": {**{k: sum(v.values()) for k, v in r_batches.items()},
                               "norm_plain": r_plain}}
    phase_s = time.perf_counter() - t_phase

    positions = metrics["selfplay/positions"]
    summary = {
        "games": len(games), "avg_length": stats.length_sum / stats.games, "split": split,
        "decided": decided, "restarts": restarts, "start_moves": len(starts),
        "selfplay_s": metrics["time/selfplay_s"], "positions": positions,
        "positions_per_s": positions / metrics["time/selfplay_s"],
        "phase5_positions_per_s": phase5_rate, "moves": len(rec.steps["selfplay"]),
        "ring": ring, "train_s": metrics["time/train_s"],
        "value_loss": [m["value_loss"] for m in losses],
        "arena_s": rec.seconds["arena"], "arena_plies": len(rec.steps["arena"]),
        "arena_s_per_ply": rec.seconds["arena"] / len(rec.steps["arena"]),
        "arena_decisive": result.decisive_games, "arena": result.as_dict(),
        "arena_split": end_split(a_games),
        "arena_frozen_steps": frozen, "promoted": passed,
        "oracle_games": len(games) + len(a_games), "oracle_plies": plies,
        "oracle_s": oracle_s, "kernel_checked_steps": kernel_checked, "kernel_check_s": kernel_s,
        "resignation": resign, "profile": profile, "launches": launches,
        "train_run_s": run_s, "phase_s": phase_s,
    }
    print(card, flush=True)
    print(json.dumps({"whole_games": summary}), flush=True)
    print(f"whole games on {card}: {len(games)} self-play games to their end "
          f"({summary['avg_length']:.1f} plies on average; {split}), {restarts} restarted "
          f"mid-batch, {decided} decided; the ring of {ring['capacity']} took "
          f"{ring['written']} positions; the arena ended {result.decisive_games} decisive games "
          f"in {len(rec.steps['arena'])} plies, promoted {passed}; the oracle agrees on "
          f"{len(games) + len(a_games)} games ({plies} plies); both kernels bit-exact on "
          f"{kernel_checked} recorded steps; phase {phase_s:.1f} s", flush=True)
    out = {"whole_games": launches}
    if resign["launches"] is not None:
        out["whole_games_resign"] = resign["launches"]
    return out


def main(argv=None) -> int:
    """All the phases, and phase 18 where the process sees two or more
    cards; with ``--every-card``, only the build and
    :func:`phase_every_card`; with ``--across-cards``, only the build,
    :func:`phase_every_card` and phase 18 (failing on fewer than two cards)."""
    import torch

    args = sys.argv[1:] if argv is None else argv
    every_card_only = "--every-card" in args
    across_cards_only = "--across-cards" in args

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
    print(f"build: {path.name} in {seconds:.2f} s", flush=True)
    for line in log.splitlines():
        if "ptxas" in line or "bytes stack frame" in line:
            print(f"build: {line.strip()}", flush=True)

    cards = torch.cuda.device_count()
    if across_cards_only and cards < 2:
        fail(f"--across-cards needs two or more cards; this process sees {cards}")
    if every_card_only or across_cards_only:
        checker = KernelCheck()
        phase_every_card(checker)
        print(json.dumps({"every_card": {"cards": cards, "max_abs_err": checker.err}}), flush=True)
        if across_cards_only:
            zero_launches()
            launches = phase_across_cards(device, card, cards)
            print(json.dumps({"across_cards_launches": launches}), flush=True)
        print_ok()
        return 0

    # Phases 3 and 4: both kernels against their plain versions, then times.
    checker = KernelCheck()
    phase_kernels(device, checker)
    phase_every_card(checker)
    times = phase_timing(device, checker, card)
    group_norm = phase_group_norm(device, card)
    se_net = phase_se_net(device, card)
    phase_net_check(device)

    # Phase 5: self-play at full width through both kernels.
    from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTSConfig

    serial = phase_selfplay(device, card, MCTSConfig(), 8, "serial")
    replay = serial["replay"]

    # Phases 6-8: the learner against the CPU, training at full width, and
    # the whole loop with its arena, checkpoint and resume.
    phase_learner_check(device, replay)
    learner_launches = phase_training(device, card, replay)
    loop_launches = phase_loop(device, card)

    # Phase 9: multi-leaf waves, then the serial search once more, so that
    # the three are read side by side within one run.
    multi = {L: phase_selfplay(device, card, MCTSConfig(leaves_per_wave=L), 4, f"L={L}")
             for L in (2, 4)}
    serial_again = phase_selfplay(device, card, MCTSConfig(), 4, "serial again")
    print(f"selfplay on {card}, 256 games, 128 sims, 8 moves serial and 4 the others, moves/s "
          f"(median seconds a move; of them inside the tree traversals): serial "
          f"{serial['rate']:.1f} ({serial['move_s']:.4f}; "
          f"{serial['traverse_s']:.4f}), "
          + ", ".join(f"L={L} {r['rate']:.1f} ({r['move_s']:.4f}; {r['traverse_s']:.4f})"
                      for L, r in multi.items())
          + f", serial again {serial_again['rate']:.1f} ({serial_again['move_s']:.4f}; "
          f"{serial_again['traverse_s']:.4f})", flush=True)
    turns = phase_interleaved(device, card)

    # Phases 10 and 11: Gumbel root selection, then what judges a run.
    gumbel = phase_selfplay(device, card, MCTSConfig(root_selection="gumbel"), 4, "gumbel")
    config_match_launches = phase_config_match(device, card)
    ladder_launches = phase_ladder(device, card)

    # Phases 12 and 13: the bench and cli play through their entry points.
    bench_launches = phase_bench(device, card)
    play_launches = phase_play(device, card)

    # Phases 14-16: seeded determinism, the search's profile, the run drivers.
    determinism_launches = phase_determinism(device, card)
    profile_launches = phase_profile_wave(device, card)
    driver_launches = phase_run_drivers(device, card)

    # Phase 17: two ranks of the loop on the one card, and the dry run;
    # phase 18: a rank a card, where there are two cards or more.
    multirank_launches = phase_multirank(device, card)
    if cards >= 2:
        multirank_launches.update(phase_across_cards(device, card, cards))
    else:
        print(f"phase 18 (across cards) not run: this process sees {cards} card", flush=True)

    # Phase 19: the flagship record's iteration, every game to its end.
    whole_launches = phase_whole_games(device, card, checker, serial["rate"])
    by_path = {
        name: {
            "selfplay": serial["launches"][name] + serial_again["launches"][name]
            + loop_launches["selfplay"][name] + turns["serial"][name],
            "learner": learner_launches[name] + loop_launches["learner"][name],
            "arena": loop_launches["arena"][name],
            "selfplay_multileaf": sum(r["launches"][name] for r in multi.values())
            + turns["L=2"][name] + turns["L=4"][name],
            "selfplay_gumbel": gumbel["launches"][name],
            "config_match": config_match_launches[name],
            "ladder": ladder_launches[name],
            "bench_rollout": bench_launches["rollout"][name],
            "bench_mcts": bench_launches["mcts"][name],
            "play": play_launches[name],
            "determinism": determinism_launches[name],
            "profile_wave": profile_launches[name],
            **{driver: counts[name] for driver, counts in driver_launches.items()},
            **{path: counts[name] for path, counts in multirank_launches.items()},
            **{path: counts[name] for path, counts in whole_launches.items()},
        }
        for name in LAUNCH_KEYS
    }
    plain_by_path = by_path.pop("norm_plain")
    for name in TAFL:
        for path, count in by_path[name].items():
            if count <= 0 and (name, path) != ("step", "learner"):
                fail(f"kernel {name} was not launched on the {path} path")
    # The GroupNorm kernel serves every path that searches with a bf16
    # GroupNorm net; the learner takes the plain chain; the split matches'
    # nets have no GroupNorm, and the rank phases are counted but not held.
    served = ("selfplay", "arena", "selfplay_multileaf", "selfplay_gumbel", "config_match",
              "ladder", "bench_mcts", "play", "determinism", "profile_wave",
              *whole_launches)
    for path in served:
        if by_path["group_norm"][path] <= 0:
            fail(f"kernel group_norm was not launched on the {path} path")
        if path != "whole_games" and plain_by_path[path] != 0:
            fail(f"{plain_by_path[path]} GroupNorm sites took PyTorch's chain on the {path} path")
    if by_path["group_norm"]["learner"] != 0 or plain_by_path["learner"] <= 0:
        fail(f"the learner launched the GroupNorm kernel {by_path['group_norm']['learner']} "
             f"times and took the plain chain at {plain_by_path['learner']} sites")

    sources = {
        "legal_mask": ("csrc/legal_mask.cu", "ops/legal_mask.py:148"),
        "step": ("csrc/step_kernel.cu", "ops/step_kernel.py:706"),
    }
    # Times at B=256, the self-play batch; "ms" is what a call of the wrapper
    # takes, the host's issue of it included, "device_ms" the kernel on the
    # card alone. No single PyTorch call computes either function, so there
    # is no library time.
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": f"alphazeroforhnefatafl_tpu_torch/{source}",
            "replaces": f"alphazeroforhnefatafl_tpu/{replaces}",
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": checker.err[name],
            "ms": times[256][name]["ms"],
            "plain_ms": times[256][name]["plain_ms"],
            "bound_ms": times[256][name]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "device_ms": times[256][name]["device_ms"],
            "bytes": times[256][name]["bytes"],
            # The batch of a two-leaf wave of 256 games.
            "at_b512": times[512][name],
        }
        for name, (source, replaces) in sources.items()
    ]
    # The GroupNorm kernel at 1,024 rows (a two-leaf wave of 512 games),
    # without the skip; "library_ms" is PyTorch's chain, which the port
    # does not call on this path. It replaces no TPU kernel.
    at = {(c["rows"], c["skip"]): c for c in group_norm["cases"]}
    kernels.append({
        "name": "group_norm",
        "route": "cuda",
        "source": "alphazeroforhnefatafl_tpu_torch/csrc/group_norm.cu",
        "replaces": None,
        "launches": sum(by_path["group_norm"].values()),
        "launches_by_path": by_path["group_norm"],
        "plain_calls_by_path": plain_by_path,
        "max_ulps_from_chain": max(c["chain_ulps"] for c in group_norm["cases"]),
        "max_ulps_from_exact": max(c["exact_ulps"] for c in group_norm["cases"]),
        "ms": at[1024, False]["ms"],
        "bound_ms": at[1024, False]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": at[1024, False]["library_ms"],
        "device_ms": at[1024, False]["device_ms"],
        "bytes": at[1024, False]["bytes"],
        "with_skip": at[1024, True],
    })
    # The SE net's two kernels at 1,024 rows, as the GroupNorm kernel; their
    # paths are phase 4's: the net against its reference, its learner's
    # forward (every site on the chain), self-play, the arena and play.
    for name, key in (("se_block", "se"), ("bn_relu", "bn")):
        cases = [c for c in se_net["cases"] if c["kernel"] == name]
        se_at = {c["rows"]: c for c in cases}
        by = se_net["counts_by_path"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "alphazeroforhnefatafl_tpu_torch/csrc/se_block.cu",
            "replaces": None,
            "launches": sum(c[key] for c in by.values()),
            "launches_by_path": {path: c[key] for path, c in by.items()},
            "plain_calls_by_path": {path: c[key + "_plain"] for path, c in by.items()},
            "max_ulps_from_exact": max(c["exact_ulps"] for c in cases),
            "ms": se_at[1024]["ms"],
            "bound_ms": se_at[1024]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": se_at[1024]["library_ms"],
            "device_ms": se_at[1024]["device_ms"],
            "bytes": se_at[1024]["bytes"],
            "at_rows": {r: c for r, c in se_at.items() if r != 1024},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print_ok()
    return 0


def print_ok():
    """The last line: what ran it."""
    import torch

    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
