"""The collectives the training loop makes across ranks.

The counterpart of the behaviours of ``alphazeroforhnefatafl_tpu/parallel/
mesh.py`` that the loop uses. JAX lays a global array over a device mesh
and lets XLA insert the psum; here each rank simply holds its slice, and
the loop calls these few collectives itself:

- :func:`replicate`: rank 0's parameters and running statistics on every
  rank (one broadcast);
- :func:`mean_`: the mean over ranks of a list of tensors, in place (one
  flat ``all_reduce(SUM)`` and a division; ``ReduceOp.AVG`` is not on every
  backend for CUDA tensors);
- :func:`gather_ints`: every rank's few integers, from which the loop takes
  a minimum, an "any" or a check that the ranks agree, and the arena the
  results of its games;
- :func:`gather_floats`: every rank's few floats (the arena's fallback sum).

The batch split that raises on a remainder is
:func:`..launch.local_batch_slice`.

Under ``gloo`` the small gathers run on CPU tensors (gloo gathers no CUDA
tensor); under ``nccl`` on the rank's card.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflatten_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()


def replicate(module: nn.Module, group) -> None:
    """Overwrite ``module``'s parameters and floating buffers (batch norm's
    running statistics) with rank 0's, in one broadcast (all float32)."""
    params = [p.data for p in module.parameters()]
    params += [b for b in module.buffers() if b.is_floating_point()]
    flat = _flat(params)
    dist.broadcast(flat, src=0, group=group)
    _unflatten_into(flat, params)


def mean_(tensors: Sequence[torch.Tensor], group) -> None:
    """Replace each tensor by its mean over the ranks, in place, with one
    ``all_reduce`` of their concatenation. They share one dtype and device."""
    flat = _flat(tensors)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    _unflatten_into(flat, tensors)


def _scalar_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _gather(values: Sequence, dtype: torch.dtype, group) -> np.ndarray:
    mine = torch.tensor(list(values), dtype=dtype, device=_scalar_device(group))
    rows: List[torch.Tensor] = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(rows, mine, group=group)
    return torch.stack(rows).cpu().numpy()


def gather_ints(values: Sequence[int], group) -> np.ndarray:
    """``int64[world, len(values)]``: row r holds rank r's ``values``."""
    return _gather(values, torch.int64, group)


def gather_floats(values: Sequence[float], group) -> np.ndarray:
    """``float64[world, len(values)]``: row r holds rank r's ``values``."""
    return _gather(values, torch.float64, group)
