"""Replay buffer for self-play positions (numpy, on the host).

The counterpart of ``ReplayBuffer``/``ReplaySample`` in
``alphazeroforhnefatafl_tpu/train/replay.py``: a ring of compact positions
(int8 boards, sparse top-K policy targets) with uniform sampling;
observation planes, dense policy targets and legal masks are rebuilt on the
device at sample time by :func:`make_batch_builder`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.profiling import span
from .learner import Batch


@dataclass
class ReplaySample:
    board: np.ndarray  # i8[B, N, N]
    side: np.ndarray  # i8[B]
    reps: np.ndarray  # i8[B] repetition count of the side to move
    policy_idx: np.ndarray  # i32[B, K] action ids (-1 pad)
    policy_p: np.ndarray  # f32[B, K]
    value: np.ndarray  # f32[B]


class ReplayBuffer:
    """Uniform-sampling ring buffer of compact positions."""

    def __init__(self, env, capacity: int, policy_k: int):
        n = env.n
        self.capacity = capacity
        self.policy_k = policy_k
        self.board = np.zeros((capacity, n, n), np.int8)
        self.side = np.zeros((capacity,), np.int8)
        self.reps = np.zeros((capacity,), np.int8)
        self.policy_idx = np.full((capacity, policy_k), -1, np.int32)
        self.policy_p = np.zeros((capacity, policy_k), np.float32)
        self.value = np.zeros((capacity,), np.float32)
        self.write = 0
        self.size = 0
        self.total_added = 0

    def add(self, board, side, reps, policy_idx, policy_p, value) -> None:
        """Append a batch of positions, evicting the oldest on overflow
        (``write_to_file``, ``game/main.rs:103-106``)."""
        with span("replay/add"):
            m = board.shape[0]
            idx = (self.write + np.arange(m)) % self.capacity
            self.board[idx] = board
            self.side[idx] = side
            self.reps[idx] = reps
            k = min(policy_idx.shape[1], self.policy_k)
            self.policy_idx[idx, :k] = policy_idx[:, :k]
            self.policy_idx[idx, k:] = -1
            self.policy_p[idx, :k] = policy_p[:, :k]
            self.policy_p[idx, k:] = 0
            self.value[idx] = value
            self.write = int((self.write + m) % self.capacity)
            self.size = int(min(self.size + m, self.capacity))
            self.total_added += int(m)

    def sample(self, rng: np.random.RandomState, batch_size: int) -> ReplaySample:
        idx = rng.randint(0, self.size, size=batch_size)
        return ReplaySample(
            board=self.board[idx],
            side=self.side[idx],
            reps=self.reps[idx],
            policy_idx=self.policy_idx[idx],
            policy_p=self.policy_p[idx],
            value=self.value[idx],
        )


def make_batch_builder(env):
    """Device-side reconstruction: compact sample -> training :class:`Batch`.

    ``build(board, side, reps, policy_idx, policy_p, value)`` takes the six
    arrays of a :class:`ReplaySample` (numpy arrays, or tensors already
    moved and augmented) and rebuilds, on ``env.device``, the observation
    planes, the legal-action mask (kernel 1 on a CUDA card) and the dense
    policy target from the sparse top-K form.
    """
    from ..ops.legal_mask import batched_legal_mask

    def build(board, side, reps, policy_idx, policy_p, value) -> Batch:
        dev = env.device
        board = torch.as_tensor(board, device=dev).to(torch.int8)
        side = torch.as_tensor(side, device=dev).to(torch.int32)
        reps = torch.as_tensor(reps, device=dev).to(torch.int32)
        policy_idx = torch.as_tensor(policy_idx, device=dev).long()
        policy_p = torch.as_tensor(policy_p, device=dev).to(torch.float32)
        B = board.shape[0]
        # The stored count is the mover's; the other side's plane is unread.
        reps2 = torch.zeros((B, 2), dtype=torch.int32, device=dev)
        reps2.scatter_(1, side.long()[:, None], reps[:, None])
        state = env.reset_batch(B).replace(board=board, side_to_play=side, reps=reps2)
        valid = policy_idx >= 0
        target = torch.zeros((B, env.num_actions), dtype=torch.float32, device=dev)
        # scatter_add_: an action listed twice gets both weights.
        target.scatter_add_(1, policy_idx.clamp(min=0), torch.where(valid, policy_p, 0.0))
        return Batch(
            obs=env.observe(state),
            policy_target=target,
            value_target=torch.as_tensor(value, device=dev).to(torch.float32),
            legal_mask=batched_legal_mask(env, board, side),
        )

    return build
