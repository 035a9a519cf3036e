"""Multi-rank launch and process-group initialization.

The counterpart of ``alphazeroforhnefatafl_tpu/parallel/launch.py``. A rank
is the counterpart of a JAX host (process): every rank runs the same
program on one device of its own, and ``torch.distributed`` joins them.

- **Self-play**: each rank plays its own games into its own replay (no
  traffic between ranks inside a move).
- **Learner**: each rank samples its slice of the global batch from its
  replay; one all-reduce a step takes the mean of the gradients, so the
  update is the global batch's and the parameters stay bit-identical.
- **Arena**: every rank plays the whole match on identical parameters with
  the shared generator, so every rank takes the same gate decision.

Start ranks with ``torchrun --nproc-per-node N`` (one per card), or pass
the group's address, size and rank to :func:`initialize_distributed`.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class HostTopology:
    process_id: int
    num_processes: int
    #: Devices this rank drives: always 1 (a rank is one process on one
    #: device; ``global_devices`` counts the ranks).
    local_devices: int
    global_devices: int
    #: The rank's device: ``cuda:{local rank}`` (shared round-robin when a
    #: host has fewer cards than ranks), or the CPU.
    device: torch.device
    #: The process group's backend, None when there is no group (world 1).
    backend: Optional[str]


def choose_backend(device_type: str, local_ranks: int, cards: int) -> str:
    """``nccl`` when every rank on the host has a CUDA card of its own,
    else ``gloo`` (which also reduces CUDA tensors, through the host: NCCL
    refuses two ranks on one card)."""
    if device_type == "cuda" and local_ranks <= cards:
        return "nccl"
    return "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> HostTopology:
    """Join the process group when running multi-rank; returns this rank's
    :class:`HostTopology`.

    No-op (world 1) when no coordinator is configured, so the same entry
    point works in one process and under a launcher. Arguments default to
    torchrun's variables: ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK`` and ``LOCAL_RANK`` (``LOCAL_WORLD_SIZE`` says how many ranks
    share this host's cards). ``coordinator_address`` is ``host:port`` or an
    ``init_method`` URL such as ``file:///path/store``.

    On the card the rank is bound to ``cuda:{LOCAL_RANK}`` (unless
    ``device`` names a card) with ``torch.cuda.set_device``.
    ``backend=None`` picks :func:`choose_backend` and prints the choice.
    Without CUDA, and without ``device="cpu"``, it raises: it never moves
    to the CPU by itself. In a process that already joined a group it
    joins nothing and returns that group's topology.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "initialize_distributed(device='cuda'): CUDA is not available; "
            "pass device='cpu' to run the ranks on the CPU"
        )
    if dist.is_available() and dist.is_initialized():
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return _topology(device)
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (
            f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        )
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    # NOT `process_id or env`: 0 is a legitimate explicit id and must not
    # fall through to a stale RANK in the environment.
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))

    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if device.index is None:
            device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    else:
        cards = 0
    if not coordinator_address or num_processes <= 1:
        return HostTopology(0, 1, 1, 1, device, None)

    if backend is None:
        backend = choose_backend(device.type, local_ranks, cards)
        if process_id == 0:
            print(
                f"initialize_distributed: {num_processes} ranks, {local_ranks} on this "
                f"host over {cards} CUDA cards ({device.type}); backend {backend}",
                file=sys.stderr, flush=True,
            )
    dist.init_process_group(
        backend,
        init_method=(coordinator_address if "://" in coordinator_address
                     else f"tcp://{coordinator_address}"),
        world_size=num_processes,
        rank=process_id,
    )
    return _topology(device)


def _topology(device: torch.device) -> HostTopology:
    return HostTopology(
        process_id=dist.get_rank(),
        num_processes=dist.get_world_size(),
        local_devices=1,
        global_devices=dist.get_world_size(),
        device=device,
        backend=dist.get_backend(),
    )


def world() -> tuple[int, int]:
    """``(rank, world size)`` of the default process group; ``(0, 1)``
    when there is none. Makes no collective call."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_batch_slice(global_batch: int) -> slice:
    """The slice of a global batch owned by this rank (equal split)."""
    rank, count = world()
    if global_batch % count:
        # A silent floor-split would orphan the remainder games: no rank
        # owns them, but the global batch still expects global_batch rows.
        raise ValueError(
            f"global batch {global_batch} must be divisible by the "
            f"process count {count}"
        )
    per = global_batch // count
    return slice(rank * per, rank * per + per)


def rank_log_path(path: str, rank: int) -> str:
    """The metrics file of ``rank``: rank 0 writes ``path`` itself, rank
    r > 0 ``<stem>.rank{r}<suffix>`` beside it, so that ranks never
    interleave lines in one file."""
    if rank == 0:
        return path
    stem, suffix = os.path.splitext(path)
    return f"{stem}.rank{rank}{suffix}"
