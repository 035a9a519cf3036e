"""ctypes bindings for the native C++ tafl engine.

The port's own copy of the JAX package's ``native/__init__.py``: the
host-side rules engine compiled from ``tafl_engine.cpp`` beside this file
(the port's copy of the repository's ``native/tafl_engine.cpp``), used for
differential testing of the port's env and oracle at scale. It is host code
and runs the same with or without a card.

The shared library is built on first use with ``g++`` into the package's
``_kernels/`` directory (listed in ``.gitignore``), beside the CUDA kernels;
the C ABI and ctypes keep the boundary free of binding libraries.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from ..core.rules import (
    EnclosureWinRules,
    Ruleset,
    Side,
)

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PACKAGE_DIR, "native", "tafl_engine.cpp")
_BUILD_DIR = os.path.join(_PACKAGE_DIR, "_kernels")
_LIB_PATH = os.path.join(_BUILD_DIR, "libtafl_native.so")

_lib = None


class TaflRulesStruct(ctypes.Structure):
    _fields_ = [
        ("edge_escape", ctypes.c_int32),
        ("king_strength", ctypes.c_int32),
        ("king_attack", ctypes.c_int32),
        ("has_shieldwall", ctypes.c_int32),
        ("sw_corners_may_close", ctypes.c_int32),
        ("sw_captures", ctypes.c_uint32),
        ("exit_fort", ctypes.c_int32),
        ("throne_movement", ctypes.c_int32),
        ("may_enter_corners", ctypes.c_uint32),
        ("hostility_throne", ctypes.c_uint32),
        ("hostility_corners", ctypes.c_uint32),
        ("hostility_edge", ctypes.c_uint32),
        ("slow_pieces", ctypes.c_uint32),
        ("starting_side", ctypes.c_int32),
        ("has_enclosure_win", ctypes.c_int32),
        ("enclosure_without_edge_access", ctypes.c_int32),
        ("has_repetition_rule", ctypes.c_int32),
        ("rep_n", ctypes.c_int32),
        ("rep_is_loss", ctypes.c_int32),
        ("draw_on_no_plays", ctypes.c_int32),
        ("linnaean_capture", ctypes.c_int32),
    ]


def build_library(force: bool = False) -> str:
    """Compile the shared library if missing or stale. The library is
    written under a temporary name and renamed, so a process that loads it
    while another builds never sees half a file."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if (
        not force
        and os.path.exists(_LIB_PATH)
        and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)
    ):
        return _LIB_PATH
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _LIB_PATH


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library())
    lib.tafl_new.restype = ctypes.c_void_p
    lib.tafl_new.argtypes = [
        ctypes.POINTER(TaflRulesStruct),
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.tafl_free.argtypes = [ctypes.c_void_p]
    for name in [
        "tafl_n",
        "tafl_num_actions",
        "tafl_side_to_play",
        "tafl_result",
        "tafl_reason",
    ]:
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.tafl_turn.restype = ctypes.c_longlong
    lib.tafl_turn.argtypes = [ctypes.c_void_p]
    lib.tafl_reps.restype = ctypes.c_longlong
    lib.tafl_reps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tafl_board.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int8)]
    lib.tafl_legal_actions.restype = ctypes.c_int
    lib.tafl_legal_actions.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.tafl_step.restype = ctypes.c_int
    lib.tafl_step.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tafl_last_captures.restype = ctypes.c_int
    lib.tafl_last_captures.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


def rules_to_struct(rules: Ruleset) -> TaflRulesStruct:
    return TaflRulesStruct(
        edge_escape=int(rules.edge_escape),
        king_strength=int(rules.king_strength),
        king_attack=int(rules.king_attack),
        has_shieldwall=int(rules.shieldwall is not None),
        sw_corners_may_close=int(
            rules.shieldwall.corners_may_close if rules.shieldwall else 0
        ),
        sw_captures=(rules.shieldwall.captures.mask if rules.shieldwall else 0),
        exit_fort=int(rules.exit_fort),
        throne_movement=int(rules.throne_movement),
        may_enter_corners=rules.may_enter_corners.mask,
        hostility_throne=rules.hostility.throne.mask,
        hostility_corners=rules.hostility.corners.mask,
        hostility_edge=rules.hostility.edge.mask,
        slow_pieces=rules.slow_pieces.mask,
        starting_side=int(rules.starting_side),
        has_enclosure_win=int(rules.enclosure_win is not None),
        enclosure_without_edge_access=int(
            rules.enclosure_win == EnclosureWinRules.WITHOUT_EDGE_ACCESS
        ),
        has_repetition_rule=int(rules.repetition_rule is not None),
        rep_n=(rules.repetition_rule.n_repetitions if rules.repetition_rule else 0),
        rep_is_loss=int(
            rules.repetition_rule.is_loss if rules.repetition_rule else 0
        ),
        draw_on_no_plays=int(rules.draw_on_no_plays),
        linnaean_capture=int(rules.linnaean_capture),
    )


class NativeGame:
    """A single game on the native engine (ctypes handle)."""

    def __init__(self, rules: Ruleset, fen: str, side_to_play: Optional[Side] = None):
        lib = _load()
        self._lib = lib
        self._rules_struct = rules_to_struct(rules)  # keep alive
        side = rules.starting_side if side_to_play is None else side_to_play
        self._h = lib.tafl_new(
            ctypes.byref(self._rules_struct), fen.encode(), int(side)
        )
        if not self._h:
            raise ValueError(f"native engine rejected FEN {fen!r}")
        self.n = lib.tafl_n(self._h)
        self.num_actions = lib.tafl_num_actions(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tafl_free(self._h)
            self._h = None

    @property
    def side_to_play(self) -> int:
        return self._lib.tafl_side_to_play(self._h)

    @property
    def result(self) -> int:
        return self._lib.tafl_result(self._h)

    @property
    def reason(self) -> int:
        return self._lib.tafl_reason(self._h)

    @property
    def turn(self) -> int:
        return self._lib.tafl_turn(self._h)

    def reps(self, side: int) -> int:
        return self._lib.tafl_reps(self._h, side)

    def board(self) -> np.ndarray:
        out = np.zeros(self.n * self.n, np.int8)
        self._lib.tafl_board(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
        return out.reshape(self.n, self.n)

    def legal_mask(self) -> np.ndarray:
        out = np.zeros(self.num_actions, np.uint8)
        self._lib.tafl_legal_actions(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        )
        return out.astype(bool)

    def step(self, action: int) -> None:
        rc = self._lib.tafl_step(self._h, int(action))
        if rc == 1:
            raise ValueError(f"invalid action {action}")
        if rc == 2:
            raise ValueError("game is over")

    def last_captures(self) -> List[Tuple[int, int]]:
        out = np.zeros(64, np.int32)
        k = self._lib.tafl_last_captures(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        )
        return [(int(t) // self.n, int(t) % self.n) for t in out[:k]]
