"""Batched self-play actor in PyTorch.

The counterpart of the host move loop of
``alphazeroforhnefatafl_tpu/train/selfplay.py``: a lockstep batch of B games
lives on the device; each move runs one batched search, picks actions with
the temperature schedule, and steps every game in one env step. The host
keeps the episode buffers, resignation and the replay writes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..core.env import DRAW, TaflEnv, where_state
from ..search.mcts import MCTS, MCTSConfig, _top_k, select_actions
from ..utils.profiling import span
from .replay import ReplayBuffer


@dataclass(frozen=True)
class SelfPlayConfig:
    """The JAX ``SelfPlayConfig`` without its TPU transport knobs
    (``search_chunk``, ``scan_moves``)."""

    batch_size: int = 64
    temp_threshold: int = 12  # moves with temp=1 before switching to argmax
    max_game_len: int = 256  # length cap; see bootstrap_truncated
    policy_k: int = 128  # sparse policy-target width
    #: Value target for games cut at max_game_len: the final root value
    #: (sign-adjusted per side) instead of a draw.
    bootstrap_truncated: bool = False
    #: A game ends as a loss for the mover when their root value stays below
    #: -resign_threshold for resign_consecutive of their moves. None
    #: disables. A random resign_disable_frac of games ignores resignation
    #: so the false-positive rate can be measured.
    resign_threshold: "float | None" = None
    resign_consecutive: int = 2
    resign_disable_frac: float = 0.1
    #: No resignation before this many moves have been played.
    resign_min_moves: int = 0
    #: Under Gumbel root selection: while the temperature is on (move <
    #: temp_threshold), sample the move from the improved policy
    #: softmax(logits + sigma(completed Q)) instead of playing the
    #: sequential-halving winner (the stochastic variant of Danihelka et al.
    #: 2022, section 5). No effect under PUCT.
    gumbel_sample_temp_moves: bool = False


@dataclass
class SelfPlayStats:
    games: int = 0
    positions: int = 0
    attacker_wins: int = 0
    defender_wins: int = 0
    draws: int = 0
    truncated: int = 0
    length_sum: int = 0
    resigned: int = 0
    resign_checked: int = 0
    resign_false_positive: int = 0
    fallback_sum: float = 0.0
    fallback_searches: int = 0

    def as_dict(self):
        g = max(self.games, 1)
        return {
            "games": self.games,
            "positions": self.positions,
            "attacker_win_rate": self.attacker_wins / g,
            "defender_win_rate": self.defender_wins / g,
            "draw_rate": self.draws / g,
            "truncated": self.truncated,
            "avg_length": self.length_sum / g,
            "resigned": self.resigned,
            "resign_fp_rate": (
                self.resign_false_positive / self.resign_checked if self.resign_checked else 0.0
            ),
            "resign_checked": self.resign_checked,
            "prior_fallback_rate": (
                self.fallback_sum / self.fallback_searches if self.fallback_searches else 0.0
            ),
        }


class SelfPlayActor:
    """Plays lockstep self-play games on ``device`` and feeds a replay buffer.

    ``evaluate(obs) -> (logits, value)``, typically the policy/value net.
    Assign :attr:`evaluate` to play the next games with another net (the
    training loop switches between the incumbent and the net in training).
    """

    def __init__(
        self,
        env: TaflEnv,
        evaluate: Callable,
        mcts_config: MCTSConfig,
        config: SelfPlayConfig,
        device=None,
    ):
        self.device = torch.device(device) if device is not None else env.device
        if self.device != env.device:
            raise ValueError(f"actor on {self.device} but env on {env.device}")
        self.env = env
        self.cfg = config
        self.mcts = MCTS(env, evaluate, mcts_config, self.device)
        self.moves_played = 0  # batched moves, for rates

    @property
    def evaluate(self) -> Callable:
        return self.mcts.evaluate

    @evaluate.setter
    def evaluate(self, evaluate: Callable) -> None:
        self.mcts.evaluate = evaluate

    def policy_target(self, action_probs: torch.Tensor):
        """Sparse top-``policy_k`` policy target: (actions, probs), -1 pad."""
        top_p, top_a = _top_k(action_probs, self.cfg.policy_k)
        return torch.where(top_p > 0, top_a, -1).to(torch.int32), top_p

    def move_tail(self, states, legal, action_probs, temps, generator, best_action=None):
        """Action selection, env step and policy target of one move.

        Under Gumbel root selection the move is the search's ``best_action``
        (exploration comes from the sampled root Gumbels, not a
        temperature), unless ``gumbel_sample_temp_moves`` samples it."""
        with span("selfplay/tail"):
            if self.mcts.config.root_selection == "gumbel":
                actions = best_action
                if self.cfg.gumbel_sample_temp_moves:
                    sampled = select_actions(action_probs, legal, temps, generator)
                    actions = torch.where(temps > 0, sampled, actions)
            else:
                actions = select_actions(action_probs, legal, temps, generator)
            new_states, info = self.env.step_many(states, actions)
            top_a, top_p = self.policy_target(action_probs)
        return new_states, actions, info, top_a, top_p

    @torch.inference_mode()
    def move(self, states, temps, generator):
        """One move of every game: root mask, search, then :meth:`move_tail`.

        Returns (states, actions, info, top_a, top_p, root_value,
        prior_fallback_rate).
        """
        with span("selfplay/move"):
            with span("selfplay/root_mask"):
                legal = self.env.legal_mask_many(states)
            # Called through the instance attribute, which a caller may
            # replace to observe each search.
            result = self.mcts.search(states, legal, generator, add_noise=True)
            out = self.move_tail(
                states, legal, result.action_probs, temps, generator, result.best_action
            )
            self.moves_played += 1
        return out + (result.root_value, result.prior_fallback_rate)

    def play(
        self,
        replay: Optional[ReplayBuffer],
        generator: torch.Generator,
        num_games: int,
        stats: Optional[SelfPlayStats] = None,
    ) -> SelfPlayStats:
        """Play at least ``num_games`` complete games, writing every finished
        episode's positions with final-outcome value targets to ``replay``.
        ``generator`` lives on the actor's device and draws all randomness."""
        env, cfg = self.env, self.cfg
        B, L, K = cfg.batch_size, cfg.max_game_len, cfg.policy_k
        n = env.n
        stats = stats or SelfPlayStats()
        states = env.reset_batch(B)
        fresh = env.reset_batch(B)
        rows = np.arange(B)
        ep_board = np.zeros((B, L, n, n), np.int8)
        ep_side = np.zeros((B, L), np.int8)
        ep_reps = np.zeros((B, L), np.int8)
        ep_pidx = np.full((B, L, K), -1, np.int32)
        ep_pp = np.zeros((B, L, K), np.float32)
        ep_rootv = np.zeros((B, L), np.float32)
        ep_len = np.zeros((B,), np.int32)

        # Resignation bookkeeping: per (game, side) streak of root values
        # below -threshold, an enable flag (a random cohort plays on for
        # false-positive monitoring), and the side that would have resigned.
        resign_on = cfg.resign_threshold is not None
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator, device=self.device))
        np_rng = np.random.RandomState(seed)
        resign_streak = np.zeros((B, 2), np.int32)
        would_resign_side = np.full((B,), -1, np.int8)
        resign_enabled = np_rng.rand(B) >= cfg.resign_disable_frac

        completed = 0
        while completed < num_games:
            temps = torch.as_tensor(
                (ep_len < cfg.temp_threshold).astype(np.float32), device=self.device
            )
            b_board = states.board.cpu().numpy()
            b_side = states.side_to_play.cpu().numpy().astype(np.int8)
            b_reps = states.reps.cpu().numpy()[rows, b_side].astype(np.int8)

            states, _, _, top_a, top_p, root_v, fb = self.move(states, temps, generator)
            fb_np = fb.cpu().numpy()
            stats.fallback_sum += float(fb_np.sum())
            stats.fallback_searches += B
            top_a_np = top_a.cpu().numpy()
            top_p_np = top_p.cpu().numpy()
            root_v_np = root_v.cpu().numpy()
            g_idx = np.nonzero(ep_len < L)[0]
            t_idx = ep_len[g_idx]
            ep_board[g_idx, t_idx] = b_board[g_idx]
            ep_side[g_idx, t_idx] = b_side[g_idx]
            ep_reps[g_idx, t_idx] = b_reps[g_idx]
            ep_pidx[g_idx, t_idx] = top_a_np[g_idx]
            ep_pp[g_idx, t_idx] = top_p_np[g_idx]
            ep_rootv[g_idx, t_idx] = root_v_np[g_idx]
            ep_len += 1

            done = states.terminated.cpu().numpy()
            results = states.result.cpu().numpy()
            truncate = (ep_len >= L) & ~done
            if resign_on:
                low = root_v_np < -cfg.resign_threshold
                mover = b_side.astype(np.int64)
                cur = resign_streak[rows, mover]
                resign_streak[rows, mover] = np.where(low, cur + 1, 0)
                trig = (resign_streak[rows, mover] >= cfg.resign_consecutive) & (
                    ep_len >= cfg.resign_min_moves
                )
                resign_now = trig & resign_enabled & ~done & ~truncate
                first = trig & ~resign_enabled & (would_resign_side < 0)
                would_resign_side[first] = b_side[first]
            else:
                resign_now = np.zeros((B,), bool)
            for g in np.nonzero(done | truncate | resign_now)[0]:
                length = int(min(ep_len[g], L))
                if done[g]:
                    r = int(results[g])
                elif resign_now[g]:
                    r = 1 - int(b_side[g])  # the mover resigns
                else:
                    r = DRAW
                sides = ep_side[g, :length]
                if not done[g] and not resign_now[g] and cfg.bootstrap_truncated:
                    v_last = float(ep_rootv[g, length - 1])
                    z = np.where(sides == sides[length - 1], v_last, -v_last).astype(np.float32)
                elif r == DRAW:
                    z = np.zeros(length, np.float32)
                else:
                    z = np.where(sides == r, 1.0, -1.0).astype(np.float32)
                if replay is not None:
                    replay.add(
                        ep_board[g, :length], sides, ep_reps[g, :length],
                        ep_pidx[g, :length], ep_pp[g, :length], z,
                    )
                stats.games += 1
                stats.positions += length
                stats.length_sum += length
                if done[g] or resign_now[g]:
                    if r == DRAW:
                        stats.draws += 1
                    elif r == 0:
                        stats.attacker_wins += 1
                    else:
                        stats.defender_wins += 1
                    if resign_now[g]:
                        stats.resigned += 1
                    elif would_resign_side[g] >= 0:
                        # The flagged mover was wrong iff they did not lose.
                        stats.resign_checked += 1
                        if r != 1 - int(would_resign_side[g]):
                            stats.resign_false_positive += 1
                else:
                    stats.truncated += 1
                    stats.draws += 1
                    if would_resign_side[g] >= 0:
                        stats.resign_checked += 1
                        stats.resign_false_positive += 1  # a draw, not a loss
                completed += 1
                ep_len[g] = 0
                resign_streak[g] = 0
                would_resign_side[g] = -1
                resign_enabled[g] = np_rng.rand() >= cfg.resign_disable_frac

            ended = done | truncate | resign_now
            if ended.any():
                states = where_state(torch.as_tensor(ended, device=self.device), fresh, states)
        return stats
