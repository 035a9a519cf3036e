"""Kernel 1: the legal-move ray scan, for a batch of games.

Replaces the Pallas TPU kernel of ``alphazeroforhnefatafl_tpu/ops/legal_mask.py``
(``_build_kernel``, entry ``batched_legal_mask``) with the CUDA kernel in
``csrc/legal_mask.cu``.

What bounds it on the H100: bytes, nearly all of them the output. A game's
mask is ``A`` bytes (4840 at 11x11) against a 121-byte board and there is no
arithmetic to speak of, so the least time is ``B * (A + N * N + 4)`` bytes
over the card's memory rate; below about a thousand games the launch and the
kernel's chain of dependent steps decide its time instead. The design serves
a group of consecutive games per CTA, one warp each: the warp holds the
board as row bit masks (lane = row), gets each moving piece's reach from one
find-first-set on its row's or column's mask, and writes the few legal bytes
into the group's span of the mask, staged zero-filled in shared memory; the
span then leaves in one bulk copy from shared to global memory.

:func:`legal_mask_plain` is the plain PyTorch version of the same function;
:func:`batched_legal_mask` dispatches on the device of its input.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from . import _build

# Cell codes (core/rules.py) and the side each piece code belongs to.
EMPTY, CELL_ATT, CELL_DEF, CELL_KING = 0, 1, 2, 3
PIECE_SIDES = (0, 1, 1)  # attacker soldier, defender soldier, king

# Columns of the plain version's move table.
MOVE_COLS = 6


def _shift_masks(n: int) -> np.ndarray:
    """``valid[dir, dist, cell]``: whether the tile ``dist`` steps from
    ``cell`` in ``dir`` (up, down, left, right) is on the board."""
    valid = np.zeros((4, n - 1, n * n), dtype=bool)
    rows, cols = np.divmod(np.arange(n * n), n)
    for d, (dr, dc) in enumerate([(-1, 0), (1, 0), (0, -1), (0, 1)]):
        for k in range(1, n):
            r2, c2 = rows + dr * k, cols + dc * k
            valid[d, k - 1] = (r2 >= 0) & (r2 < n) & (c2 >= 0) & (c2 < n)
    return valid


@dataclass(frozen=True)
class MoveTables:
    """Piece classes deduplicated by their movement rules.

    Attacker and defender soldiers usually move alike, so they share one ray
    scan (core/env.py ``legal_mask_for_side``, ops/legal_mask.py
    ``batched_legal_mask``).
    """

    table: np.ndarray  # int32[nn, 6]: occupiable at 2i, passable at 2i + 1
    max_dist: Tuple[int, int, int]  # per move class (0 where unused)
    cls_of_code: Tuple[int, int, int, int]  # cell code -> move class
    codes: Tuple[Tuple[int, ...], ...]  # per move class, its cell codes

    @property
    def num_classes(self) -> int:
        return len(self.codes)


def _move_tables(env) -> MoveTables:
    n = env.n
    nn = n * n
    table = np.zeros((nn, MOVE_COLS), dtype=np.int32)
    cfg_to_idx = {}
    max_dist = [0, 0, 0]
    codes = []
    cls_of_code = [0, 0, 0, 0]
    for cls in range(3):
        cfg = env.cls_cfg[cls]
        if cfg not in cfg_to_idx:
            i = cfg_to_idx[cfg] = len(codes)
            table[:, 2 * i] = env._occupiable[cls].reshape(nn)
            table[:, 2 * i + 1] = (~(env.throne_mask & cfg.throne_pass_blocked)).reshape(nn)
            max_dist[i] = 1 if cfg.slow else n - 1
            codes.append([])
        i = cfg_to_idx[cfg]
        codes[i].append(cls + 1)
        cls_of_code[cls + 1] = i
    return MoveTables(
        table=table,
        max_dist=tuple(max_dist),
        cls_of_code=tuple(cls_of_code),
        codes=tuple(tuple(c) for c in codes),
    )


def _plain_tables(env, device):
    """Device tensors of :func:`legal_mask_plain`: the gather index of the
    tile at (cell, dir, dist), ``nn`` where it is off the board, and the
    move table."""

    def build(dev):
        n = env.n
        nn = n * n
        valid = _shift_masks(n)  # [4, n-1, nn]
        offs = np.array([-n, n, -1, 1])[:, None] * np.arange(1, n)[None, :]  # [4, n-1]
        idx = np.arange(nn)[None, None, :] + offs[:, :, None]
        idx = np.where(valid, idx, nn).transpose(2, 0, 1)  # [nn, 4, n-1]
        mt = _move_tables(env)
        return (
            torch.as_tensor(idx, dtype=torch.long, device=dev),
            torch.as_tensor(mt.table != 0, device=dev),
            mt,
        )

    return env.cached("legal_mask_plain", device, build)


def legal_mask_plain(env, boards: torch.Tensor, sides: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch legal mask: ``boards`` int8[B, N, N], ``sides`` int32[B]
    -> bool[B, A] in action order (cell, dir, dist)."""
    B = boards.shape[0]
    n = env.n
    nn = n * n
    ray_idx, table, mt = _plain_tables(env, boards.device)
    flat = boards.reshape(B, nn)
    empty = flat == EMPTY
    pad = torch.zeros((B, 1), dtype=torch.bool, device=boards.device)
    dist = torch.arange(1, n, device=boards.device)
    out = torch.zeros((B, nn, 4, n - 1), dtype=torch.bool, device=boards.device)
    for i in range(mt.num_classes):
        dest_ok = torch.cat([empty & table[:, 2 * i], pad], dim=1)[:, ray_idx]
        pass_ok = torch.cat([empty & table[:, 2 * i + 1], pad], dim=1)[:, ray_idx]
        # Tiles before distance k all passable: exclusive running AND.
        run = torch.cummin(pass_ok.to(torch.uint8), dim=-1).values
        open_before = torch.cat([torch.ones_like(run[..., :1]), run[..., :-1]], dim=-1)
        legal = dest_ok & (open_before != 0) & (dist <= mt.max_dist[i])
        sel = torch.zeros((B, nn), dtype=torch.bool, device=boards.device)
        for code in mt.codes[i]:
            sel |= (flat == code) & (sides[:, None] == PIECE_SIDES[code - 1])
        out |= legal & sel[:, :, None, None]
    return out.reshape(B, env.num_actions)


def batched_legal_mask(env, boards: torch.Tensor, sides: torch.Tensor) -> torch.Tensor:
    """Legal-action mask ``bool[B, A]`` of ``sides`` on ``boards``.

    A CPU tensor goes to :func:`legal_mask_plain`; a CUDA tensor to the CUDA
    kernel, which raises if it cannot build or launch.
    """
    if boards.device.type == "cpu":
        return legal_mask_plain(env, boards, sides)
    if boards.device.type != "cuda":
        raise ValueError(f"batched_legal_mask: unsupported device {boards.device}")
    n = env.n
    B = boards.shape[0]
    if boards.dtype != torch.int8 or tuple(boards.shape[1:]) != (n, n):
        raise ValueError(f"boards must be int8[B, {n}, {n}], got {boards.dtype}{tuple(boards.shape)}")
    if sides.dtype != torch.int32 or tuple(sides.shape) != (B,) or sides.device != boards.device:
        raise ValueError("sides must be int32[B] on the boards' device")
    boards = boards.contiguous()
    sides = sides.contiguous()
    from .step_kernel import cuda_args

    tab, params = cuda_args(env, boards.device)
    lib = _build.load_library()
    out = torch.empty((B, env.num_actions), dtype=torch.bool, device=boards.device)
    stream = torch.cuda.current_stream(boards.device).cuda_stream
    # The ctypes call launches on the host thread's CURRENT device, on a
    # stream of the tensor's: a rank on cuda:1 whose current device is 0
    # would fail at launch, so enter the tensor's device around it.
    with torch.cuda.device(boards.device):
        rc = lib.tafl_legal_mask(
            boards.data_ptr(), sides.data_ptr(), tab.data_ptr(), ctypes.addressof(params),
            B, out.data_ptr(), stream,
        )
    _build.check(rc, "tafl_legal_mask")
    batched_legal_mask.launches += 1
    return out


batched_legal_mask.launches = 0
