"""Arena evaluation: pit two policies against each other.

The counterpart of ``alphazeroforhnefatafl_tpu/train/arena.py``.
``play_match`` plays a lockstep batch of games with MCTS on both sides —
candidate vs incumbent — alternating colors, and reports win rates and an
Elo delta estimate; ``play_config_match`` pits two search configurations
against each other; ``ladder`` plays a round robin and fits Elo ratings.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..core.env import DRAW, TaflEnv
from ..search.mcts import MCTS, MCTSConfig, select_actions


@dataclass
class ArenaResult:
    games: int
    candidate_wins: int
    incumbent_wins: int
    draws: int
    #: Games that hit ``max_game_len`` without terminating. Scored as draws
    #: (the conservative choice) but reported separately: on drawish rulesets
    #: with short ply caps these can dominate.
    truncated: int = 0
    #: Mean per-search prior-fallback rate over the match (legal-masked NN
    #: policy summed to zero -> uniform fallback).
    prior_fallback_rate: float = 0.0

    @property
    def score(self) -> float:
        """Candidate score in [0, 1] (draws and truncations count half)."""
        if self.games == 0:
            return 0.5
        return (
            self.candidate_wins + 0.5 * (self.draws + self.truncated)
        ) / self.games

    @property
    def decisive_score(self) -> float:
        """Candidate win rate over decisive games only (0.5 when none): the
        draw-robust gating signal."""
        decisive = self.candidate_wins + self.incumbent_wins
        if decisive == 0:
            return 0.5
        return self.candidate_wins / decisive

    @property
    def decisive_games(self) -> int:
        return self.candidate_wins + self.incumbent_wins

    @property
    def elo_delta(self) -> float:
        s = min(max(self.score, 1e-3), 1 - 1e-3)
        return -400.0 * math.log10(1.0 / s - 1.0)

    def decisive_wilson_lb(self, z: float = 1.0) -> float:
        """Wilson-score lower bound on the candidate's decisive win rate.

        The confidence-aware gating signal: the bound shrinks unless the
        decisive sample actually supports promotion. ``z`` is the one-sided
        normal quantile (1.0 ~ 84%, 1.64 ~ 95%). Returns 0 when no decisive
        games were played.
        """
        n = self.decisive_games
        if n == 0:
            return 0.0
        p = self.candidate_wins / n
        z2 = z * z
        denom = 1.0 + z2 / n
        center = p + z2 / (2 * n)
        margin = z * math.sqrt(p * (1 - p) / n + z2 / (4 * n * n))
        return (center - margin) / denom

    def as_dict(self):
        return {
            "games": self.games,
            "candidate_wins": self.candidate_wins,
            "incumbent_wins": self.incumbent_wins,
            "draws": self.draws,
            "truncated": self.truncated,
            "score": self.score,
            "decisive_score": self.decisive_score,
            "decisive_wilson_lb": self.decisive_wilson_lb(),
            "elo_delta": self.elo_delta,
            "prior_fallback_rate": self.prior_fallback_rate,
        }


def _pair_evaluate(evaluate_candidate: Callable, evaluate_incumbent: Callable) -> Callable:
    """``ev(i0, obs)``: one evaluation that serves both players.

    ``i0`` selects which net (0 candidate, 1 incumbent) evaluates the first
    half of the game batch; the second half gets the other. Games are laid
    out so each half is owned by one player for a whole ply, so the cost is
    two half-batch forwards, and the tree work runs once instead of twice.
    """
    nets = (evaluate_candidate, evaluate_incumbent)

    def ev(i0: int, obs: torch.Tensor):
        half = obs.shape[0] // 2
        l0, v0 = nets[i0](obs[:half])
        l1, v1 = nets[1 - i0](obs[half:])
        return torch.cat([l0, l1], 0), torch.cat([v0, v1], 0)

    return ev


def _match_searches(env, evaluate_candidate, evaluate_incumbent, mcts_config):
    """The two searches of a match, indexed by the side to move: the
    candidate owns the first half of the batch exactly when the attacker
    (side 0) is on turn."""
    pair = _pair_evaluate(evaluate_candidate, evaluate_incumbent)
    return [MCTS(env, functools.partial(pair, i0), mcts_config, env.device) for i0 in (0, 1)]


def _pick_actions(mcts: MCTS, result, legal, generator) -> torch.Tensor:
    """The move a noise-free match plays: the halving winner under Gumbel,
    else the most visited action with ties broken by ``generator``."""
    if mcts.config.root_selection == "gumbel":
        return result.best_action
    temperature = torch.zeros((legal.shape[0],), device=legal.device)
    return select_actions(result.action_probs, legal, temperature, generator)


def _play(env: TaflEnv, num_games: int, max_game_len: int, move) -> ArenaResult:
    """The ply loop of a match. ``move(side, states) -> (states, fallback
    rate f32[B])`` plays one ply of every game; every running game is at
    the same ply (terminated games freeze)."""
    B = num_games
    states = env.reset_batch(B)
    done_results = np.full(B, -2, np.int32)  # -2 = still running
    fb_sum, fb_n = 0.0, 0
    starting_side = int(env.rules.starting_side)
    for move_i in range(max_game_len):
        with torch.inference_mode():
            states, fb = move((starting_side + move_i) % 2, states)
        res = states.result.cpu().numpy()
        term = states.terminated.cpu().numpy()
        # Only searches of still-running games count toward the fallback
        # metric (terminated games freeze but still run the batched search).
        running = done_results == -2
        if running.any():
            fb_np = fb.cpu().numpy()
            fb_sum += float(fb_np[running].sum())
            fb_n += int(running.sum())
        newly = term & running
        done_results[newly] = res[newly]
        if term.all():
            break

    # The candidate plays attacker in games [0, B/2), defender in [B/2, B).
    cand_is_attacker = np.arange(B) < B // 2
    cand_w = incumbent_w = draws = truncated = 0
    for g in range(B):
        r = int(done_results[g])
        if r == -2:
            truncated += 1
        elif r == DRAW:
            draws += 1
        elif (r == 0) == bool(cand_is_attacker[g]):
            cand_w += 1
        else:
            incumbent_w += 1
    return ArenaResult(
        games=B,
        candidate_wins=cand_w,
        incumbent_wins=incumbent_w,
        draws=draws,
        truncated=truncated,
        prior_fallback_rate=fb_sum / fb_n if fb_n else 0.0,
    )


def play_match(
    env: TaflEnv,
    evaluate_candidate: Callable,
    evaluate_incumbent: Callable,
    mcts_config: MCTSConfig,
    num_games: int = 32,
    max_game_len: int = 256,
    generator: Optional[torch.Generator] = None,
) -> ArenaResult:
    """Play ``num_games`` (half with candidate as attacker, half as defender).

    ``evaluate_*(obs) -> (logits, value)``: the two nets. One batched search
    per ply: every running game is at the same ply (terminated games
    freeze), so the side to move — and with the attacker-games-first layout,
    which net owns which half of the batch — is a function of the move
    index. ``generator`` (on the env's device) breaks ties between equally
    visited moves.
    """
    if num_games % 2 != 0:
        raise ValueError("num_games must be even (candidate plays each color)")
    if generator is None:
        generator = torch.Generator(device=env.device).manual_seed(0)
    searches = _match_searches(env, evaluate_candidate, evaluate_incumbent, mcts_config)

    def move(side, states):
        legal = env.legal_mask_many(states)
        result = searches[side].search(states, legal, add_noise=False)
        actions = _pick_actions(searches[side], result, legal, generator)
        return env.step_many(states, actions)[0], result.prior_fallback_rate

    return _play(env, num_games, max_game_len, move)


def play_config_match(
    env: TaflEnv,
    evaluate_candidate: Callable,
    evaluate_incumbent: Callable,
    config_candidate: MCTSConfig,
    config_incumbent: MCTSConfig,
    num_games: int = 32,
    max_game_len: int = 256,
    generator: Optional[torch.Generator] = None,
) -> ArenaResult:
    """Pit two search configurations (multi-leaf against serial waves, other
    budgets, Gumbel against PUCT) against each other; the two nets may be
    one net.

    The layout is :func:`play_match`'s (the candidate is the attacker in the
    first half of the batch, the defender in the second), so on any ply one
    configuration owns each half: a ply runs one half-batch search per
    configuration, the candidate's on the first half exactly when the
    attacker is on turn.
    """
    if num_games % 2 != 0:
        raise ValueError("num_games must be even (candidate plays each color)")
    if generator is None:
        generator = torch.Generator(device=env.device).manual_seed(0)
    mcts_c = MCTS(env, evaluate_candidate, config_candidate, env.device)
    mcts_i = MCTS(env, evaluate_incumbent, config_incumbent, env.device)
    half = num_games // 2

    def move(side, states):
        actions, fb = [], []
        owners = (mcts_c, mcts_i) if side == 0 else (mcts_i, mcts_c)
        for m, part in zip(owners, (slice(0, half), slice(half, None))):
            s = states.map(lambda x: x[part])
            legal = env.legal_mask_many(s)
            result = m.search(s, legal, add_noise=False)
            actions.append(_pick_actions(m, result, legal, generator))
            fb.append(result.prior_fallback_rate)
        return env.step_many(states, torch.cat(actions))[0], torch.cat(fb)

    return _play(env, num_games, max_game_len, move)


def ladder(
    env: TaflEnv,
    named_evaluates,  # list of (name, evaluate)
    mcts_config: MCTSConfig,
    games_per_pair: int = 16,
    generator: Optional[torch.Generator] = None,
    iters: int = 200,
    max_game_len: int = 256,
):
    """Round-robin all entries and fit Elo ratings.

    Plays every unordered pair once (``games_per_pair`` games, colors
    alternating inside :func:`play_match`), then fits the ratings that
    maximize the Bradley-Terry likelihood by minorization updates, with the
    first entry anchored at 0. ``named_evaluates``: ``(name, evaluate(obs)
    -> (logits, value))`` pairs: nets, or the anchors of
    ``train/anchors.py``. Returns ``(ratings dict, wins, games)``:
    ``wins[i, j]`` is i's score sum against j.
    """
    if generator is None:
        generator = torch.Generator(device=env.device).manual_seed(0)
    n = len(named_evaluates)
    wins = np.zeros((n, n))
    games = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            res = play_match(
                env, named_evaluates[i][1], named_evaluates[j][1], mcts_config,
                num_games=games_per_pair, max_game_len=max_game_len, generator=generator,
            )
            wins[i, j] = res.score * res.games
            wins[j, i] = (1 - res.score) * res.games
            games[i, j] = games[j, i] = res.games

    r = np.zeros(n)
    for _ in range(iters):
        expect = 1.0 / (1.0 + 10 ** ((r[None, :] - r[:, None]) / 400.0))
        grad = (wins - games * expect).sum(axis=1)
        r = r + 4.0 * grad / np.maximum(games.sum(axis=1), 1)
        r -= r[0]  # anchor
    ratings = {name: float(r[i]) for i, (name, _) in enumerate(named_evaluates)}
    return ratings, wins, games
