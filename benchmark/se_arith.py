"""The frozen arithmetic of the squeeze-excitation net's cells: the FLOPs of
one evaluation and the bytes of the SE kernel's launches, from the
configuration's sizes alone, so that the count is the same whatever
implements the net."""

from __future__ import annotations

import harness


def net_flops_per_eval(n: int, in_planes: int, channels: int, blocks: int, value_hidden: int,
                       se_ratio: int) -> float:
    """Analytic forward FLOPs of one evaluation of the SE net: those of
    :func:`harness.net_flops_per_eval` (its convolutions and dense layers
    are the same), plus each block's two SE dense layers, ``C -> C / r``
    and ``C / r -> 2C`` (multiply-adds x 2; norms, the cells' mean and
    elementwise work are left out)."""
    hidden = channels // se_ratio
    se = 2.0 * (channels * hidden + hidden * 2 * channels)
    return harness.net_flops_per_eval(n, in_planes, channels, blocks, value_hidden) + blocks * se


def se_block_bytes(rows: int, launches: int, n: int, channels: int, se_ratio: int) -> int:
    """Bytes the SE kernel's launches must move: a row's ``y`` and skip read
    once and its output written once (bf16, ``N * N * C`` each), and a
    launch's float32 weights read once (the norm's four vectors of ``C``,
    ``W1`` and ``b1``, ``W2`` and ``b2``)."""
    hidden = channels // se_ratio
    per_row = 3 * n * n * channels * 2
    per_launch = 4 * (4 * channels + hidden * channels + hidden + 2 * channels * hidden
                      + 2 * channels)
    return rows * per_row + launches * per_launch
