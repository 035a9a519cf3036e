"""Batched tafl environment in PyTorch.

The counterpart of ``alphazeroforhnefatafl_tpu/core/env.py``. Every state is
a batch: each :class:`EnvState` field carries a leading game dimension. The
array phase of a step (move, captures, floods, next legal mask, repetition
ring, outcome select) is one call of :func:`..ops.step_kernel.step_arrays`,
which runs the CUDA kernel on a CUDA tensor and its plain PyTorch version on
a CPU tensor; only the invalid/terminal freeze and the :class:`StepInfo`
packing (:meth:`TaflEnv._epilogue`) remain here.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .fen import board_from_fen
from .rules import (
    CELL_ATT,
    CELL_DEF,
    CELL_KING,
    PIECE_CLASSES,
    PieceType,
    Ruleset,
    ThroneRule,
)

# Result codes (as core/env.py).
ONGOING = -1
WIN_ATTACKER = 0
WIN_DEFENDER = 1
DRAW = 2

# Reason codes: rules.WinReason; draws offset by 16.
R_NONE = -1
R_DRAW_REPETITION = 16
R_DRAW_NO_PLAYS = 17


@dataclass
class EnvState:
    """A batch of game states (``game/game/state.rs:119-133``)."""

    board: torch.Tensor  # int8[B, N, N]
    side_to_play: torch.Tensor  # int32[B]: 0 attacker, 1 defender
    recent_plays: torch.Tensor  # int32[B, 4] encoded records, -1 = empty
    rep_first_i: torch.Tensor  # int32[B] ring index
    reps: torch.Tensor  # int32[B, 2] consecutive repetition counts
    mid_pair: torch.Tensor  # bool[B, 2]
    plays_since_capture: torch.Tensor  # int32[B]
    turn: torch.Tensor  # int32[B]
    terminated: torch.Tensor  # bool[B]
    result: torch.Tensor  # int32[B]
    reason: torch.Tensor  # int32[B]

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)

    def map(self, fn) -> "EnvState":
        """Apply ``fn`` to every field."""
        return EnvState(**{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})

    @property
    def batch_size(self) -> int:
        return self.board.shape[0]


@dataclass
class StepInfo:
    """Effects of a batch of steps (``PlayEffects``, ``game/game/mod.rs:56-61``)."""

    captures: torch.Tensor  # bool[B, N, N]
    n_captures: torch.Tensor  # int32[B]
    terminated: torch.Tensor  # bool[B]: game ended on this step
    result: torch.Tensor  # int32[B]
    reason: torch.Tensor  # int32[B]
    reward_mover: torch.Tensor  # f32[B]
    legal_mask: torch.Tensor  # bool[B, A] for the next player
    invalid: torch.Tensor  # bool[B]: the action was illegal (no-op applied)


def where_state(mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Per game: ``a`` where ``mask`` else ``b``."""

    def pick(x, y):
        return torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 1)), x, y)

    return EnvState(
        **{f.name: pick(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)}
    )


@dataclass(frozen=True)
class ClassCfg:
    """Static rule constants of one piece class (as core/env._ClassCfg)."""

    throne_entry_blocked: bool
    throne_pass_blocked: bool
    corner_entry_blocked: bool
    slow: bool
    hostile_throne: bool
    hostile_corner: bool
    hostile_edge: bool


def _class_cfg(rules: Ruleset, cls: int) -> ClassCfg:
    piece = PIECE_CLASSES[cls]
    is_king = piece.piece_type == PieceType.KING
    tm = rules.throne_movement
    return ClassCfg(
        throne_entry_blocked=(
            tm == ThroneRule.NO_ENTRY or (tm == ThroneRule.KING_ENTRY and not is_king)
        ),
        throne_pass_blocked=(
            tm == ThroneRule.NO_PASS or (tm == ThroneRule.KING_PASS and not is_king)
        ),
        corner_entry_blocked=not rules.may_enter_corners.contains(piece),
        slow=rules.slow_pieces.contains(piece),
        hostile_throne=rules.hostility.throne.contains(piece),
        hostile_corner=rules.hostility.corners.contains(piece),
        hostile_edge=rules.hostility.edge.contains(piece),
    )


class TaflEnv:
    """A tafl environment for one ruleset and starting board, on one device.

    The static tables are numpy arrays; the ops modules keep their device
    copies in ``self.cache``, keyed by device. The env lives on the CUDA
    card unless the caller asks for ``device="cpu"``, and raises when it is
    to live on a card and there is none.
    """

    def __init__(self, rules: Ruleset, start_board_fen: str, device="cuda"):
        self.rules = rules
        self._start_fen = start_board_fen
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"TaflEnv(device={str(self.device)!r}): CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        start = board_from_fen(start_board_fen)
        self.n = n = int(start.shape[0])
        self.num_actions = n * n * 4 * (n - 1)
        self._start_board = start

        self.throne = (n // 2, n // 2)
        throne_mask = np.zeros((n, n), dtype=bool)
        throne_mask[self.throne] = True
        corner_mask = np.zeros((n, n), dtype=bool)
        for t in [(0, 0), (0, n - 1), (n - 1, 0), (n - 1, n - 1)]:
            corner_mask[t] = True
        edge_mask = np.zeros((n, n), dtype=bool)
        edge_mask[0, :] = edge_mask[-1, :] = edge_mask[:, 0] = edge_mask[:, -1] = True
        self.throne_mask = throne_mask
        self.corner_mask = corner_mask
        self.edge_mask = edge_mask

        self.cls_cfg = tuple(_class_cfg(rules, c) for c in range(3))
        # bool[3, N, N]: empty special tiles hostile to each class (logic.rs:76-82).
        self._special_hostile = np.stack(
            [
                (throne_mask & cfg.hostile_throne) | (corner_mask & cfg.hostile_corner)
                for cfg in self.cls_cfg
            ]
        )
        # bool[3, N, N]: tiles each class may stand on, ignoring occupancy
        # (logic.rs:250-266).
        self._occupiable = np.stack(
            [
                ~(throne_mask & cfg.throne_entry_blocked)
                & ~(corner_mask & cfg.corner_entry_blocked)
                for cfg in self.cls_cfg
            ]
        )
        self._special_plane = torch.as_tensor(
            (throne_mask | corner_mask).astype(np.float32), device=self.device
        )
        self.cache = {}

    # Value identity, as core/env.py, plus the device.
    def __eq__(self, other):
        return (
            type(other) is TaflEnv
            and self.rules == other.rules
            and self._start_fen == other._start_fen
            and self.device == other.device
        )

    def __hash__(self):
        return hash((self.rules, self._start_fen, str(self.device)))

    def cached(self, key, device: torch.device, build):
        """``build(device)`` once per (key, device)."""
        k = (key, str(device))
        if k not in self.cache:
            self.cache[k] = build(device)
        return self.cache[k]

    # ------------------------------------------------------------------
    # Reset
    # ------------------------------------------------------------------

    def reset_batch(self, batch_size: int) -> EnvState:
        """A batch of fresh games (``GameState::new``, ``state.rs:136-145``)."""
        B, dev, i32 = batch_size, self.device, torch.int32
        board = torch.as_tensor(self._start_board, dtype=torch.int8, device=dev)
        return EnvState(
            board=board.expand(B, self.n, self.n).clone(),
            side_to_play=torch.full((B,), int(self.rules.starting_side), dtype=i32, device=dev),
            recent_plays=torch.full((B, 4), -1, dtype=i32, device=dev),
            rep_first_i=torch.zeros((B,), dtype=i32, device=dev),
            reps=torch.zeros((B, 2), dtype=i32, device=dev),
            mid_pair=torch.zeros((B, 2), dtype=torch.bool, device=dev),
            plays_since_capture=torch.zeros((B,), dtype=i32, device=dev),
            turn=torch.zeros((B,), dtype=i32, device=dev),
            terminated=torch.zeros((B,), dtype=torch.bool, device=dev),
            result=torch.full((B,), ONGOING, dtype=i32, device=dev),
            reason=torch.full((B,), R_NONE, dtype=i32, device=dev),
        )

    def reset(self) -> EnvState:
        """One fresh game, as a batch of one."""
        return self.reset_batch(1)

    # ------------------------------------------------------------------
    # Legal moves and steps
    # ------------------------------------------------------------------

    def legal_mask_many(self, states: EnvState) -> torch.Tensor:
        """``bool[B, A]`` legal actions of the side to move; all-false when
        terminal. Kernel 1 (:mod:`..ops.legal_mask`)."""
        from ..ops.legal_mask import batched_legal_mask

        m = batched_legal_mask(self, states.board, states.side_to_play)
        return m & ~states.terminated[:, None]

    def step_many(
        self, states: EnvState, actions: torch.Tensor
    ) -> Tuple[EnvState, StepInfo]:
        """Apply one action per game. Kernel 2 (:mod:`..ops.step_kernel`).

        ``actions`` must lie in ``[0, A)``. An action whose piece is missing,
        belongs to the other side or leaves the board, or a step of a
        terminated game, leaves the state unchanged and sets
        ``info.invalid``; the ray-legality of the action is not checked (the
        ``validate=False`` path of core/env.py, used by search and
        self-play, which only pick masked actions).
        """
        from ..ops.step_kernel import SCALAR_INDEX, step_arrays

        actions = actions.to(torch.int32)
        board3, cap, next_mask, scal = step_arrays(
            self,
            states.board,
            states.side_to_play,
            actions,
            states.recent_plays,
            states.rep_first_i,
            states.reps,
            states.mid_pair,
            states.plays_since_capture,
        )
        s = SCALAR_INDEX
        valid = (scal[:, s["valid"]] != 0) & ~states.terminated
        return self._epilogue(
            states,
            valid,
            board3,
            cap,
            scal[:, s["n_captures"]],
            scal[:, s["ring0"] : s["ring0"] + 4],
            scal[:, s["rep_first_i"]],
            scal[:, s["reps_att"] : s["reps_att"] + 2],
            scal[:, s["mid_att"] : s["mid_att"] + 2] != 0,
            scal[:, s["plays_since_capture"]],
            scal[:, s["result"]],
            scal[:, s["reason"]],
            scal[:, s["terminated"]] != 0,
            next_mask,
        )

    def _epilogue(
        self, state, valid, board3, cap, n_captures, recent, rep_first_i,
        reps, mid_pair, psc, result, reason, terminated, next_mask,
    ) -> Tuple[EnvState, StepInfo]:
        """Freeze invalid and terminal games; pack :class:`StepInfo`
        (core/env.py ``_epilogue``)."""
        side = state.side_to_play
        other = 1 - side
        reward_mover = torch.where(
            result == side, 1.0, torch.where(result == other, -1.0, 0.0)
        ).to(torch.float32)
        new_state = EnvState(
            board=board3,
            side_to_play=other,
            recent_plays=recent.contiguous(),
            rep_first_i=rep_first_i.contiguous(),
            reps=reps.contiguous(),
            mid_pair=mid_pair.contiguous(),
            plays_since_capture=psc.contiguous(),
            turn=state.turn + 1,
            terminated=terminated,
            result=result.contiguous(),
            reason=reason.contiguous(),
        )
        new_state = where_state(valid, new_state, state)
        info = StepInfo(
            captures=cap & valid[:, None, None],
            n_captures=torch.where(valid, n_captures, 0).to(torch.int32),
            terminated=terminated & valid,
            result=torch.where(valid, result, state.result),
            reason=torch.where(valid, reason, state.reason),
            reward_mover=torch.where(valid, reward_mover, 0.0),
            legal_mask=next_mask & ~terminated[:, None] & valid[:, None],
            invalid=~valid,
        )
        return new_state, info

    # ------------------------------------------------------------------
    # Observation
    # ------------------------------------------------------------------

    @property
    def num_observation_planes(self) -> int:
        """Planes of :meth:`observe` (``models.network.OBS_PLANES``)."""
        return 6

    def observe(self, states: EnvState) -> torch.Tensor:
        """Network input planes ``f32[B, N, N, 6]`` (NHWC, as core/env.py)."""
        b = states.board
        B, n = b.shape[0], self.n
        side = states.side_to_play
        rep = states.reps.gather(1, side.long()[:, None])[:, 0].to(torch.float32) / 3.0
        planes = [
            (b == CELL_ATT).to(torch.float32),
            ((b == CELL_DEF) | (b == CELL_KING)).to(torch.float32),
            (b == CELL_KING).to(torch.float32),
            self._special_plane.to(b.device).expand(B, n, n),
            side.to(torch.float32)[:, None, None].expand(B, n, n),
            rep[:, None, None].expand(B, n, n),
        ]
        return torch.stack(planes, dim=-1)


@functools.lru_cache(maxsize=None)
def _make_env_cached(preset: str, device: str) -> TaflEnv:
    from .rules import PRESETS

    rules, board = PRESETS[preset]
    return TaflEnv(rules, board, device)


def make_env(preset: str, device="cuda") -> TaflEnv:
    """An env for a named preset (``rules.PRESETS``) on ``device``: the CUDA
    card unless the caller asks for ``"cpu"``; raises without CUDA."""
    return _make_env_cached(preset, str(torch.device(device)))
