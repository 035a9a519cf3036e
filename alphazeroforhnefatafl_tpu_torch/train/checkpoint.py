"""Checkpoint / resume for the AlphaZero loop.

The counterpart of ``alphazeroforhnefatafl_tpu/train/checkpoint.py``, with
``torch.save`` in place of Orbax. A checkpoint is one file per iteration,
written under a temporary name and renamed, that captures the full loop
state — the net's (its running statistics with it), optimizer's and
schedule's ``state_dict``, the replay
buffer, the loop generator's state, the iteration and an ``extra`` dict (the
gating incumbent) — so a restart resumes at the last iteration boundary.
Every leaf is a tensor or a plain Python value, so the file loads with
``torch.load(weights_only=True)``.

Across ranks (a manager given a process group) rank 0 writes that file
without the replay, and every rank writes its own replay and self-play
generator to a sidecar ``replay_host{rank}/{iteration}.pt`` beside it:
replay buffers are rank-local, so one replay in the shared file would hand
every rank rank 0's games on restore.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..models.network import architecture
from .learner import TrainState
from .replay import ReplayBuffer

_REPLAY_ARRAYS = ("board", "side", "reps", "policy_idx", "policy_p", "value")
_REPLAY_COUNTERS = ("write", "size", "total_added")
_FILE = re.compile(r"^ckpt_(\d+)\.pt$")
_SIDECAR = re.compile(r"^(\d+)\.pt$")


def _replay_state(replay: ReplayBuffer) -> Dict[str, Any]:
    state = {k: torch.from_numpy(getattr(replay, k)) for k in _REPLAY_ARRAYS}
    state.update({k: int(getattr(replay, k)) for k in _REPLAY_COUNTERS})
    return state


def _restore_replay(replay: ReplayBuffer, st: Dict[str, Any]) -> None:
    for k in _REPLAY_ARRAYS:
        getattr(replay, k)[...] = st[k].numpy()
    for k in _REPLAY_COUNTERS:
        setattr(replay, k, int(st[k]))


def _clone(obj):
    """A copy of a tree of dicts, lists, tuples and tensors that shares no
    memory with the (memory-mapped) file it was loaded from."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(v) for v in obj)
    return obj


def _check_architecture(where: str, net: torch.nn.Module, saved: Dict[str, torch.Tensor]) -> None:
    """Raise unless ``saved`` has exactly the net's tensors (parameters and
    batch norm's running statistics), by name and shape; the error names
    both architectures by their keys."""
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in saved.items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    shape_diff = sorted(k for k in set(want) & set(got) if want[k] != got[k])
    if missing or extra or shape_diff:
        detail = "; ".join(
            filter(
                None,
                [
                    missing and f"tensors only in the net {missing[:4]}",
                    extra and f"tensors only on disk {extra[:4]}",
                    shape_diff
                    and f"shape mismatches {[(k, want[k], got[k]) for k in shape_diff[:4]]}",
                ],
            )
        )
        def keys(state):
            return " ".join(f"{k}={v}" for k, v in architecture(state).items())

        raise ValueError(
            f"checkpoint {where} was saved with a different architecture ({keys(saved)}) than "
            f"the net to restore into ({keys(net.state_dict())}; check "
            f"--channels/--blocks/--norm/--se-ratio): {detail}"
        )


def _save_atomic(payload, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Iteration-boundary checkpointing with retention.

    With a process ``group`` every rank of it calls :meth:`save` at the same
    iterations (the call ends in a barrier)."""

    def __init__(self, directory: str, max_to_keep: int = 3, group=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, iteration: int) -> str:
        return os.path.join(self.directory, f"ckpt_{iteration:08d}.pt")

    def _sidecar_dir(self) -> str:
        return os.path.join(self.directory, f"replay_host{self.rank}")

    def _sidecar(self, iteration: int) -> str:
        return os.path.join(self._sidecar_dir(), f"{iteration}.pt")

    def all_iterations(self) -> List[int]:
        found = (_FILE.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_iteration(self) -> Optional[int]:
        its = self.all_iterations()
        return its[-1] if its else None

    def save(
        self,
        iteration: int,
        train_state: TrainState,
        replay: Optional[ReplayBuffer],
        generator: torch.Generator,
        extra: Optional[Dict[str, Any]] = None,
        rank_generator: Optional[torch.Generator] = None,
    ) -> None:
        """Write iteration ``iteration``. ``generator`` is the generator
        every rank shares; across ranks ``rank_generator`` (the rank's
        self-play generator) goes to the rank's sidecar with its replay."""
        payload = {
            "iteration": int(iteration),
            "train_state": train_state.state_dict(),
            "rng": generator.get_state(),
            "extra": extra or {},
        }
        if replay is not None and self.group is None:
            payload["replay"] = _replay_state(replay)
        if self.rank == 0:
            _save_atomic(payload, self._path(iteration))
        if self.group is not None:
            if replay is not None:
                os.makedirs(self._sidecar_dir(), exist_ok=True)
                side = {"replay": _replay_state(replay)}
                if rank_generator is not None:
                    side["rng"] = rank_generator.get_state()
                _save_atomic(side, self._sidecar(iteration))
            # Every rank's files are on disk before any rank returns, and
            # before the listing below decides what to keep. NCCL is told the
            # rank's card (it would guess one from the rank).
            nccl = dist.get_backend(self.group) == "nccl"
            dist.barrier(group=self.group,
                         device_ids=[torch.cuda.current_device()] if nccl else None)
        keep = set(self.all_iterations()[-self.max_to_keep:])
        if self.rank == 0:
            for old in set(self.all_iterations()) - keep:
                os.remove(self._path(old))
        if self.group is not None and os.path.isdir(self._sidecar_dir()):
            for f in os.listdir(self._sidecar_dir()):
                m = _SIDECAR.match(f)
                if m and int(m.group(1)) not in keep:
                    os.remove(os.path.join(self._sidecar_dir(), f))

    def _load(self, iteration: Optional[int]) -> Tuple[int, Dict[str, Any]]:
        step = iteration if iteration is not None else self.latest_iteration()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        # Memory-mapped: a caller that wants the parameters only, or the
        # keys of ``extra``, does not read the replay buffer.
        return step, torch.load(self._path(step), map_location="cpu", mmap=True, weights_only=True)

    def saved_extra_keys(self, iteration: Optional[int] = None) -> Tuple[str, ...]:
        """Keys of the ``extra`` payload the on-disk checkpoint was saved
        with (empty for ungated runs, and when there is no checkpoint)."""
        if iteration is None and self.latest_iteration() is None:
            return ()
        return tuple(self._load(iteration)[1]["extra"].keys())

    def restore(
        self,
        train_state: TrainState,
        replay: Optional[ReplayBuffer],
        iteration: Optional[int] = None,
        rank_generator: Optional[torch.Generator] = None,
    ) -> Tuple[int, TrainState, torch.Tensor, Dict[str, Any]]:
        """Load a checkpoint into ``train_state`` (in place) and ``replay``.

        ``replay=None`` restores the parameters and optimizer only (an Elo
        ladder over a run's checkpoints). Returns ``(iteration, train_state,
        generator state, extra)``. Raises ``ValueError`` when the checkpoint
        holds another architecture than ``train_state.net``, instead of
        loading a partly fresh net. A checkpoint written across ranks has
        no replay in its file: ``replay`` and ``rank_generator`` are then
        read from this rank's sidecar.
        """
        step, payload = self._load(iteration)
        saved = payload["train_state"]
        _check_architecture(f"{self.directory}:{step}", train_state.net, saved["net"])
        train_state.load_state_dict(_clone(saved))
        if replay is not None:
            if "replay" in payload:
                _restore_replay(replay, payload["replay"])
            else:
                side = torch.load(self._sidecar(step), map_location="cpu", weights_only=True)
                _restore_replay(replay, side["replay"])
                if rank_generator is not None and "rng" in side:
                    rank_generator.set_state(side["rng"])
        return step, train_state, payload["rng"].clone(), _clone(payload["extra"])
