"""Dihedral (D4) board/action symmetries for training augmentation.

The counterpart of ``alphazeroforhnefatafl_tpu/core/symmetry.py``. Tafl
boards, rules and all shipped presets are symmetric under the 8 rotations
and reflections of the square, so every self-play position yields 8
equivalent training samples. In the ``(from_tile, direction, distance)``
action encoding (``core/actions.py``) a transform permutes the from-tile and
the direction and leaves the distance unchanged.

Transforms are indexed 0..7: ``t = flip * 4 + k`` meaning "rotate 90 degrees
counterclockwise k times, then (if flip) flip up-down".
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

NUM_TRANSFORMS = 8

# Direction order: up, down, left, right (core.actions.DIR_OFFSETS).
# After one CCW rot90 (as np.rot90: (r, c) -> (n-1-c, r)), a move that went
# "up" now goes "left", etc.
_ROT_DIR = {0: 2, 1: 3, 2: 1, 3: 0}  # up->left, down->right, left->down, right->up
_FLIP_DIR = {0: 1, 1: 0, 2: 2, 3: 3}  # flipud swaps up/down


@functools.lru_cache(maxsize=None)
def action_permutations(n: int) -> np.ndarray:
    """``perm[t, a]`` = the action index of ``a`` after transform ``t``.

    A policy over the original board maps to the transformed board as
    ``policy_t[perm[t, a]] = policy[a]``. The array is cached and shared:
    do not write to it.
    """
    ndist = n - 1
    A = n * n * 4 * ndist
    a = np.arange(A)
    per_tile = 4 * ndist
    fr, rem = np.divmod(a, per_tile)
    d, k = np.divmod(rem, ndist)
    r, c = np.divmod(fr, n)

    perms = np.zeros((NUM_TRANSFORMS, A), dtype=np.int32)
    for t in range(NUM_TRANSFORMS):
        flip, rot = divmod(t, 4)
        r2, c2, d2 = r.copy(), c.copy(), d.copy()
        for _ in range(rot):
            r2, c2 = n - 1 - c2, r2
            d2 = np.vectorize(_ROT_DIR.get)(d2)
        if flip:
            r2 = n - 1 - r2
            d2 = np.vectorize(_FLIP_DIR.get)(d2)
        perms[t] = ((r2 * n + c2) * 4 + d2) * ndist + k
    return perms


@functools.lru_cache(maxsize=None)
def _permutation_tensor(n: int, device: str) -> torch.Tensor:
    """:func:`action_permutations` as a tensor ``[8, A]`` on ``device``."""
    return torch.as_tensor(action_permutations(n), device=device)


def transform_board(board: torch.Tensor, t: int) -> torch.Tensor:
    """Apply transform ``t`` to a ``[..., N, N]`` board."""
    flip, rot = divmod(t, 4)
    out = torch.rot90(board, rot, dims=(-2, -1))
    if flip:
        out = torch.flip(out, dims=(-2,))
    return out


def all_board_transforms(board: torch.Tensor) -> torch.Tensor:
    """Stack of all 8 transforms of ``[..., N, N]`` -> ``[8, ..., N, N]``."""
    return torch.stack([transform_board(board, t) for t in range(NUM_TRANSFORMS)])


def random_symmetry_batch(
    generator: Optional[torch.Generator],
    boards: torch.Tensor,  # [B, N, N]
    policy_idx: torch.Tensor,  # i32[B, K] sparse action indices, -1 = empty
    transforms: Optional[torch.Tensor] = None,  # int[B] in [0, 8)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply an independent random D4 transform to each sample.

    Returns (transformed boards, transformed sparse policy indices). Values
    (policy_p, value, side, reps) are invariant under the symmetry.
    ``generator`` (on the boards' device) draws the transforms unless the
    caller passes them as ``transforms``.
    """
    B, n = boards.shape[0], boards.shape[-1]
    dev = boards.device
    if transforms is None:
        transforms = torch.randint(0, NUM_TRANSFORMS, (B,), generator=generator, device=dev)
    t = transforms.to(device=dev, dtype=torch.long)
    variants = all_board_transforms(boards)  # [8, B, N, N]
    boards_t = variants[t, torch.arange(B, device=dev)]
    idx_t = _permutation_tensor(n, str(dev))[t[:, None], policy_idx.clamp(min=0).long()]
    idx_t = torch.where(policy_idx >= 0, idx_t, -1)
    return boards_t, idx_t.to(torch.int32)
