"""Net-free anchor opponents for externally grounded Elo ladders.

The counterpart of ``alphazeroforhnefatafl_tpu/train/anchors.py``. A run's
own ladder entries (init, iterN, ...) drift with the run: "+311 Elo over
init" is not comparable across runs. These anchors are fixed points outside
any run:

- ``uniform``: uniform-prior MCTS — zero logits and zero values, so the
  whole search is the uniform-over-legal fallback of ``src/mcts.py:83-102``,
  led only by the terminal values found in the tree.
- ``material``: uniform priors and a piece-count value (normalized by each
  side's starting strength): a weak classical evaluator.
- ``random``: an arbitrary but deterministic legal move per position (huge
  pseudo-random logits swamp the search): a random-legal bot that is
  reproducible for Elo fitting.

An anchor is an ``evaluate(obs) -> (logits, value)`` like a net, so it goes
into ``play_match`` and ``ladder`` as one. The JAX package wraps every entry
as ``{"net": params, "anchor": code}`` and runs the net forward for anchors
too, to keep one compiled graph for every pairing; here a pure anchor runs
no net.

The ``random`` anchor hashes the position with an integer mixer of its own,
where the JAX package folds the hash into a ``jax.random`` key: the two
packages' random anchors are both deterministic in the position, but they
do not play the same moves.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.env import TaflEnv

ANCHOR_NET = 0
ANCHOR_UNIFORM = 1
ANCHOR_MATERIAL = 2
ANCHOR_RANDOM = 3

ANCHOR_CODES = {
    "uniform": ANCHOR_UNIFORM,
    "material": ANCHOR_MATERIAL,
    "random": ANCHOR_RANDOM,
}

_MASK64 = (1 << 64) - 1


def _signed64(x: int) -> int:
    """The int64 with the bits of the unsigned 64-bit ``x``."""
    x &= _MASK64
    return x - (1 << 64) if x >= 1 << 63 else x


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer on int64 tensors (products wrap; the shifts
    are made logical by masking the sign's copies off)."""
    for shift, mult in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
        x = (x ^ ((x >> shift) & ((1 << (64 - shift)) - 1))) * _signed64(mult)
    return x ^ ((x >> 31) & ((1 << 33) - 1))


def position_hash(obs: torch.Tensor) -> torch.Tensor:
    """``i64[B]``: the planes weighted by their 1-based flat index, as the
    JAX package hashes a position, times 3 so that the repetition plane
    (thirds) stays an integer and the sum is exact on any device."""
    flat = (obs.reshape(obs.shape[0], -1) * 3.0).round().to(torch.int64)
    weights = torch.arange(1, flat.shape[1] + 1, dtype=torch.int64, device=obs.device)
    return (flat * weights).sum(-1)


def make_anchored_evaluate(env: TaflEnv, code: int, net: Optional[Callable] = None) -> Callable:
    """The ``evaluate(obs)`` of a ladder entry: ``net`` itself for
    ``ANCHOR_NET``, else the net-free anchor behavior of ``code``."""
    if code == ANCHOR_NET:
        if net is None:
            raise ValueError("ANCHOR_NET needs a net")
        return net
    if code not in ANCHOR_CODES.values():
        raise ValueError(f"unknown anchor code {code!r}; expected one of {ANCHOR_CODES}")
    A = env.num_actions
    # Starting piece counts normalize the material advantage per preset.
    board = env.reset_batch(1).board
    n_att0 = float((board == 1).sum())
    n_def0 = float(((board == 2) | (board == 3)).sum())

    def evaluate(obs: torch.Tensor):
        B = obs.shape[0]
        logits = torch.zeros((B, A), dtype=torch.float32, device=obs.device)
        value = torch.zeros((B,), dtype=torch.float32, device=obs.device)
        if code == ANCHOR_MATERIAL:
            # The mover's normalized piece advantage.
            att = obs[..., 0].sum((1, 2))
            deff = obs[..., 1].sum((1, 2))
            side = obs[:, 0, 0, 4]  # 0 attacker / 1 defender to move
            att_adv = att / n_att0 - deff / n_def0
            value = torch.tanh(1.5 * torch.where(side == 0, att_adv, -att_adv))
        elif code == ANCHOR_RANDOM:
            # Pseudo-random logits, deterministic in the position. The 1e4
            # scale swamps the search's Q and exploration terms, so it plays
            # the masked argmax: an arbitrary legal move.
            a = torch.arange(A, dtype=torch.int64, device=obs.device)
            bits = _mix64(position_hash(obs)[:, None] * A + a[None, :])
            logits = (bits & 0xFFFFFF).to(torch.float32) / float(1 << 24) * 1e4
        return logits, value

    return evaluate
