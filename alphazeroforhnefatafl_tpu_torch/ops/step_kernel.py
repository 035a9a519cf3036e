"""Kernel 2: one env step per game, for a batch of games.

Replaces the Pallas TPU kernel of ``alphazeroforhnefatafl_tpu/ops/step_kernel.py``
(``_build_step_kernel``, tables ``_static_tables``, entry ``step_arrays``) with
the CUDA kernel in ``csrc/step_kernel.cu``. Per game it computes the action
decode and move, custodian and shieldwall captures, the surround-win and
exit-fort floods, the next player's legal mask (also the NoPlays check), the
repetition ring and the outcome priority select.

What bounds it on the H100: bytes. At 11x11 a game reads 163 bytes and writes
5178 (two boards, the 4840-byte mask, 24 scalars) with no arithmetic to speak
of; what stands between the kernel and that bound is the latency of a step's
dependent phases at small batches and their instruction count at large ones.
The kernel runs one warp per game with the board in registers as row bit
masks (lane = row), so every phase is warp votes, shuffles and bit
arithmetic with no block barrier: a ray or a shieldwall run ends at the
nearest set bit of a mask, a flood fill grows whole rows per iteration, and
a flood whose seed is empty is skipped. The next player's mask is staged in
shared memory for the CTA's group of games and leaves in one bulk copy
(``csrc/tafl_common.cuh``).

:func:`step_plain` is the plain PyTorch version of the same function and is
the port's env array phase on the CPU; :func:`step_arrays` dispatches on the
device of its input.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..core.rules import PIECE_CLASSES, KingAttack, KingStrength
from . import _build
from .legal_mask import (
    CELL_ATT,
    CELL_DEF,
    CELL_KING,
    EMPTY,
    MOVE_COLS,
    _move_tables,
    legal_mask_plain,
)

DRDC = ((-1, 0), (1, 0), (0, -1), (0, 1))  # up, down, left, right

# Columns of the plain version's per-cell table, after the move columns.
COL_SPECIAL_HOSTILE = 6  # + piece class
COL_CLS_OCC = 9  # + piece class
COL_CORNER = 12
COL_EDGE = 13
COL_CC = 14
NUM_COLS = 15

#: The 24 per-game int32 scalars of a step, in the order of the Pallas
#: kernel's scalar rows (ops/step_kernel.py:645-672).
SCALAR_ROWS = (
    "valid", "moving", "trc", "tcc", "kflat", "king_captured", "to_at_edge",
    "to_at_corner", "o_enclosed", "o_exit_fort", "result", "reason",
    "terminated", "rep_first_i", "reps_att", "reps_def", "mid_att", "mid_def",
    "plays_since_capture", "ring0", "ring1", "ring2", "ring3", "n_captures",
)
SCALAR_INDEX = {name: i for i, name in enumerate(SCALAR_ROWS)}


class TaflParams(ctypes.Structure):
    """The rule switches (csrc/tafl_common.cuh ``TaflParams``). Per-class
    facts are bit fields, bit ``cls`` for piece class ``cls``."""

    _fields_ = [
        (name, ctypes.c_int)
        for name in (
            "n", "thr_r", "thr_c", "slow_bits", "king_attacks",
            "king_hostile_when_enemy", "king_strength", "special_rules_on",
            "linnaean", "enclosure_win", "exit_fort", "sw_on", "sw_caps_bits",
            "sw_corners_close", "edge_hostile_bits", "edge_escape", "rep_n",
            "rep_is_loss", "draw_on_no_plays",
        )
    ]


# Planes of the kernels' rule table (csrc/tafl_common.cuh TAFL_PL_*), each
# followed by its piece class where it has three.
PL_OCC_ROW = 0
PL_PASS_ROW = 3
PL_OCC_COL = 6
PL_PASS_COL = 9
PL_HOSTILE_ROW = 12
PL_CORNER_ROW = 15
PL_EDGE_ROW = 16
NUM_PLANES = 17


def _pack_rows(plane: np.ndarray) -> np.ndarray:
    """``bool[n, n]`` -> ``uint32[32]``: word i is row i, bit c column c."""
    n = plane.shape[0]
    out = np.zeros(32, dtype=np.uint32)
    out[:n] = (plane.astype(np.uint32) << np.arange(n, dtype=np.uint32)[None, :]).sum(1)
    return out


def _bit_planes(env) -> np.ndarray:
    """The kernels' rule table ``uint32[NUM_PLANES, 32]``: every per-cell rule
    fact as one bit mask per row, and the movement facts per column too."""
    n = env.n
    if n > 21:
        raise ValueError(f"the CUDA kernels take boards up to 21x21, got {n}x{n}")
    tab = np.zeros((NUM_PLANES, 32), dtype=np.uint32)
    for c, cfg in enumerate(env.cls_cfg):
        occupiable = env._occupiable[c]
        passable = ~(env.throne_mask & cfg.throne_pass_blocked)
        tab[PL_OCC_ROW + c] = _pack_rows(occupiable)
        tab[PL_PASS_ROW + c] = _pack_rows(passable)
        tab[PL_OCC_COL + c] = _pack_rows(occupiable.T)
        tab[PL_PASS_COL + c] = _pack_rows(passable.T)
        tab[PL_HOSTILE_ROW + c] = _pack_rows(env._special_hostile[c])
    tab[PL_CORNER_ROW] = _pack_rows(env.corner_mask)
    tab[PL_EDGE_ROW] = _pack_rows(env.edge_mask)
    return tab


def _static_tables(env) -> Tuple[np.ndarray, dict]:
    """The plain version's per-cell rule table ``int32[nn, NUM_COLS]`` and the
    rule switches."""
    rules = env.rules
    n = env.n
    nn = n * n
    mt = _move_tables(env)
    table = np.zeros((nn, NUM_COLS), dtype=np.int32)
    table[:, :MOVE_COLS] = mt.table
    for c in range(3):
        table[:, COL_SPECIAL_HOSTILE + c] = env._special_hostile[c].reshape(nn)
        table[:, COL_CLS_OCC + c] = env._occupiable[c].reshape(nn)
    thr_r, thr_c = env.throne
    sw = rules.shieldwall
    table[:, COL_CORNER] = env.corner_mask.reshape(nn)
    table[:, COL_EDGE] = env.edge_mask.reshape(nn)
    table[:, COL_CC] = env.corner_mask.reshape(nn) & bool(sw is not None and sw.corners_may_close)
    rep = rules.repetition_rule
    static = dict(
        n=n,
        thr_flat=thr_r * n + thr_c,
        king_attacks=rules.king_attack in (KingAttack.ARMED, KingAttack.HAMMER),
        king_hostile_when_enemy=rules.king_attack in (KingAttack.ARMED, KingAttack.ANVIL),
        king_strength=int(rules.king_strength),
        special_rules_on=(
            rules.king_strength == KingStrength.STRONG_BY_THRONE
            and rules.throne_movement.name in ("NO_ENTRY", "KING_ENTRY")
        ),
        linnaean=bool(rules.linnaean_capture),
        enclosure_win=-1 if rules.enclosure_win is None else int(rules.enclosure_win),
        exit_fort=bool(rules.exit_fort),
        sw_on=sw is not None,
        sw_caps=tuple(bool(sw and sw.captures.contains(p)) for p in PIECE_CLASSES),
        edge_hostile=tuple(cfg.hostile_edge for cfg in env.cls_cfg),
        edge_escape=bool(rules.edge_escape),
        rep_n=int(rep.n_repetitions) if rep is not None else 0,
        rep_is_loss=bool(rep is not None and rep.is_loss),
        draw_on_no_plays=bool(rules.draw_on_no_plays),
    )
    return table, static


def _bits(flags) -> int:
    return sum(int(bool(f)) << i for i, f in enumerate(flags))


def params_struct(env) -> TaflParams:
    """The env's rule switches as the kernels' C struct."""
    _, st = _static_tables(env)
    sw = env.rules.shieldwall
    thr_r, thr_c = env.throne
    derived = dict(
        thr_r=thr_r,
        thr_c=thr_c,
        slow_bits=_bits(cfg.slow for cfg in env.cls_cfg),
        sw_caps_bits=_bits(st["sw_caps"]),
        sw_corners_close=bool(sw is not None and sw.corners_may_close),
        edge_hostile_bits=_bits(st["edge_hostile"]),
    )
    p = TaflParams()
    for name, _ in TaflParams._fields_:
        setattr(p, name, int(derived[name] if name in derived else st[name]))
    return p


# ----------------------------------------------------------------------
# Plain PyTorch version
# ----------------------------------------------------------------------


def _shift(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """``out[..., r, c] = x[..., r + dr, c + dc]``; False off the board."""
    n0, n1 = x.shape[-2], x.shape[-1]
    out = torch.zeros_like(x)
    out[..., max(0, -dr): n0 - max(0, dr), max(0, -dc): n1 - max(0, dc)] = x[
        ..., max(0, dr): n0 - max(0, -dr), max(0, dc): n1 - max(0, -dc)
    ]
    return out


def _dil4(x: torch.Tensor) -> torch.Tensor:
    return x | _shift(x, 1, 0) | _shift(x, -1, 0) | _shift(x, 0, 1) | _shift(x, 0, -1)


def _flood(seed: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """4-connected component of ``allowed`` holding ``seed``, per game.

    The reference aborts a fill once it has failed (core/env.py ``_flood``);
    the fill here runs to its fixpoint, which gives the same verdicts
    because every fail test grows with the reached set.
    """
    reach = seed & allowed
    while True:
        grown = _dil4(reach) & allowed
        if torch.equal(grown, reach):
            return reach
        reach = grown


def _hostile(board: torch.Tensor, special: torch.Tensor, st: dict) -> torch.Tensor:
    """``bool[B, 3, ...]``: tiles hostile to each piece class (logic.rs:85-99)."""
    empty = board == EMPTY
    att = board == CELL_ATT
    att_enemy = board == CELL_DEF
    if st["king_hostile_when_enemy"]:
        att_enemy = att_enemy | (board == CELL_KING)
    return torch.stack(
        [att_enemy | (empty & special[0]), att | (empty & special[1]), att | (empty & special[2])],
        dim=1,
    )


def _secure(boundary, region, board3, hostile3, planes, st, b_cls, hs_cls, inside_safe, outside_safe):
    """``enclosure_secure`` (logic.rs:408-463) for every game."""
    special_h = planes["special_hostile"][b_cls].expand_as(region)
    tile_h = hostile3[:, b_cls]
    occupied = board3 != EMPTY
    occupiable_hs = planes["cls_occ"][hs_cls].expand_as(region)
    on_board = torch.ones_like(region)
    secure = torch.ones_like(region)
    for dirs in (((-1, 0), (1, 0)), ((0, -1), (0, 1))):
        safe = torch.zeros_like(region)
        for dr, dc in dirs:
            inside = _shift(region, dr, dc)
            known = torch.zeros_like(region)
            if inside_safe:
                known = known | inside
            if outside_safe:
                known = known | ~inside
            safe_a = known & ~_shift(special_h, dr, dc)
            safe_b = ~_shift(tile_h, dr, dc) & (_shift(occupied, dr, dc) | ~_shift(occupiable_hs, dr, dc))
            in_b = _shift(on_board, dr, dc)
            safe = safe | (in_b & (safe_a | safe_b))
            if not st["edge_hostile"][b_cls]:
                safe = safe | ~in_b
        secure = secure & safe
    return ~(boundary & ~secure).flatten(1).any(1)


def _plain_args(env, device):
    def build(dev):
        table, st = _static_tables(env)
        n = env.n
        t = torch.as_tensor(table != 0, device=dev)
        lane_cells = np.stack(
            [
                np.arange(n),
                (n - 1) * n + np.arange(n),
                np.arange(n) * n,
                np.arange(n) * n + n - 1,
            ]
        )
        pin_cells = np.stack(
            [
                n + np.arange(n),
                (n - 2) * n + np.arange(n),
                np.arange(n) * n + 1,
                np.arange(n) * n + n - 2,
            ]
        )
        planes = dict(
            special_hostile=t[:, COL_SPECIAL_HOSTILE: COL_SPECIAL_HOSTILE + 3].T.reshape(3, n, n),
            cls_occ=t[:, COL_CLS_OCC: COL_CLS_OCC + 3].T.reshape(3, n, n),
            corner=t[:, COL_CORNER].reshape(n, n),
            edge=t[:, COL_EDGE].reshape(n, n),
            lane_cells=torch.as_tensor(lane_cells, dtype=torch.long, device=dev),
            pin_cells=torch.as_tensor(pin_cells, dtype=torch.long, device=dev),
        )
        return t, st, planes

    return env.cached("step_plain", device, build)


def step_plain(env, boards, sides, actions, recent_plays, rep_first_i, reps,
               mid_pair, plays_since_capture):
    """Plain PyTorch step of a batch; same inputs and outputs as
    :func:`step_arrays`."""
    dev = boards.device
    n = env.n
    nn, nd = n * n, n - 1
    B = boards.shape[0]
    table, st, planes = _plain_args(env, dev)
    ar = torch.arange(B, device=dev)
    side = sides.long()
    a = actions.long()

    # ---- action decode and move ----
    per_tile = 4 * nd
    frm = a // per_tile
    rem = a % per_tile
    d = rem // nd
    dist = rem % nd + 1
    fr, fc = frm // n, frm % n
    dr_t = torch.tensor([-1, 1, 0, 0], device=dev)
    dc_t = torch.tensor([0, 0, -1, 1], device=dev)
    tr, tc = fr + dr_t[d] * dist, fc + dc_t[d] * dist
    to_in_b = (tr >= 0) & (tr < n) & (tc >= 0) & (tc < n)
    trc, tcc = tr.clamp(0, n - 1), tc.clamp(0, n - 1)
    to = trc * n + tcc
    flat = boards.reshape(B, nn)
    moving = flat[ar, frm].long()
    valid_basic = to_in_b & (moving != EMPTY) & (torch.where(moving == CELL_ATT, 0, 1) == side)
    b2 = flat.clone()
    b2[ar, frm] = EMPTY
    b2[ar, to] = moving.to(torch.int8)
    # King on the post-move board: the first king cell, 0 if none.
    kflat = (b2 == CELL_KING).to(torch.uint8).argmax(1)
    kr, kc = kflat // n, kflat % n

    # ---- hostility, padded by 2 with the edge's hostility ----
    hostile2 = _hostile(b2.reshape(B, n, n), planes["special_hostile"], st)
    hp = torch.empty((B, 3, n + 4, n + 4), dtype=torch.bool, device=dev)
    for c in range(3):
        hp[:, c] = bool(st["edge_hostile"][c])
    hp[:, :, 2:-2, 2:-2] = hostile2

    def h_at(cls, r, c):
        return hp[ar, cls, r + 2, c + 2]

    thr_r, thr_c = env.throne
    king_on_throne = kflat == st["thr_flat"]
    king_beside = (kr - thr_r).abs() + (kc - thr_c).abs() == 1
    if st["king_strength"] == int(KingStrength.STRONG):
        king_strong = torch.ones_like(king_on_throne)
    elif st["king_strength"] == int(KingStrength.WEAK):
        king_strong = torch.zeros_like(king_on_throne)
    else:
        king_strong = king_on_throne | king_beside
    may_attack = (moving != CELL_KING) | bool(st["king_attacks"])
    if st["linnaean"]:
        cnt = sum(h_at(2, torch.full_like(ar, thr_r + dr), torch.full_like(ar, thr_c + dc)).long()
                  for dr, dc in DRDC)
        linn_ok = (side == 0) & king_on_throne & (cnt == 3)
    else:
        linn_ok = torch.zeros_like(king_on_throne)

    # ---- custodian captures (logic.rs:604-699) ----
    cap = torch.zeros((B, nn), dtype=torch.bool, device=dev)
    b2d = b2.reshape(B, n, n)
    for dr, dc in DRDC:
        nr, nc = trc + dr, tcc + dc
        in_b = (nr >= 0) & (nr < n) & (nc >= 0) & (nc < n)
        nrc, ncc = nr.clamp(0, n - 1), nc.clamp(0, n - 1)
        q = b2d[ar, nrc, ncc].long()
        enemy = in_b & torch.where(side == 0, (q == CELL_DEF) | (q == CELL_KING), q == CELL_ATT)
        far_r, far_c = trc + 2 * dr, tcc + 2 * dc
        far_h = h_at((q - 1).clamp(0, 2), far_r, far_c)
        if dr == 0:
            perp = h_at(2, nrc + 1, ncc) & h_at(2, nrc - 1, ncc)
        else:
            perp = h_at(2, nrc, ncc + 1) & h_at(2, nrc, ncc - 1)
        king_capt = far_h & (~king_strong | perp)
        if st["special_rules_on"]:
            all_nbr = torch.ones_like(in_b)
            for dr2, dc2 in DRDC:
                r2, c2 = nrc + dr2, ncc + dc2
                a_in = (r2 >= 0) & (r2 < n) & (c2 >= 0) & (c2 < n)
                is_throne = (r2 == thr_r) & (c2 == thr_c)
                all_nbr = all_nbr & (~a_in | is_throne | h_at(2, r2, c2))
            king_capt = king_capt | (king_beside & all_nbr)
        soldier_capt = far_h
        if st["linnaean"]:
            soldier_capt = soldier_capt | (linn_ok & (far_r == thr_r) & (far_c == thr_c) & (q == CELL_DEF))
        captured = enemy & may_attack & torch.where(q == CELL_KING, king_capt, soldier_capt)
        idx = nrc * n + ncc
        cap[ar, idx] = cap[ar, idx] | captured

    # ---- shieldwall (logic.rs:471-569; core/env.py _shieldwall_captures) ----
    if st["sw_on"]:
        case = torch.where(trc == 0, 0, torch.where(trc == n - 1, 1, torch.where(
            tcc == 0, 2, torch.where(tcc == n - 1, 3, 4))))
        lc = planes["lane_cells"][case.clamp(max=3)]  # [B, n]
        lanes = b2.gather(1, lc).long()
        pins = b2.gather(1, planes["pin_cells"][case.clamp(max=3)]).long()
        idx = torch.arange(n, device=dev)
        occupied = lanes != EMPTY
        lane_side = torch.where(lanes == CELL_ATT, 0, 1)
        friendly = occupied & (lane_side == side[:, None])
        enemy_pinned = (occupied & (lane_side != side[:, None]) & (pins != EMPTY)
                        & (torch.where(pins == CELL_ATT, 0, 1) == side[:, None]))
        cc = table[:, COL_CC][lc]
        ext = enemy_pinned & ~cc
        closer = friendly | (~occupied & cc) | (enemy_pinned & cc)
        pos0 = torch.where(case < 2, tcc, trc)

        def scan(step):
            if step > 0:
                q = torch.where(~ext & (idx > pos0[:, None]), idx, n).min(1).values
                q_in = q < n
            else:
                q = torch.where(~ext & (idx < pos0[:, None]), idx, -1).max(1).values
                q_in = q >= 0
            at_q = idx == q[:, None]
            close = q_in & (at_q & closer).any(1)
            incl_q = q_in & (at_q & enemy_pinned & cc).any(1)
            lo, hi = torch.minimum(pos0, q), torch.maximum(pos0, q)
            count = hi - lo - 1 + incl_q.long()
            between = (idx > lo[:, None]) & (idx < hi[:, None])
            return close & (count >= 2), between | (at_q & incl_q[:, None])

        s_neg, w_neg = scan(-1)
        s_pos, w_pos = scan(+1)
        cap_a, cap_d, cap_k = st["sw_caps"]
        cls_ok = (((lanes == CELL_ATT) & cap_a) | ((lanes == CELL_DEF) & cap_d)
                  | ((lanes == CELL_KING) & cap_k))
        wall = torch.where(s_neg[:, None], w_neg, w_pos) & cls_ok
        wall = wall & ((s_neg | s_pos) & (case < 4))[:, None]
        cap.scatter_(1, lc, cap.gather(1, lc) | wall)

    board3 = torch.where(cap, torch.zeros_like(b2), b2)

    # ---- flood-fill outcomes on the post-capture board ----
    b3 = board3.reshape(B, n, n)
    empty3, att3 = b3 == EMPTY, b3 == CELL_ATT
    def3, king3 = b3 == CELL_DEF, b3 == CELL_KING
    defenders3 = def3 | king3
    hostile3 = _hostile(b3, planes["special_hostile"], st)
    kseed = torch.zeros((B, nn), dtype=torch.bool, device=dev)
    kseed[ar, kflat] = True
    kseed = kseed.reshape(B, n, n)
    corner, edge = planes["corner"], planes["edge"]
    if st["enclosure_win"] >= 0:
        reach = _flood(kseed & (side == 0)[:, None, None], empty3 | defenders3)
        fail_mask = corner | edge if st["enclosure_win"] == 1 else corner
        fail = (reach & fail_mask).flatten(1).any(1)
        boundary = _dil4(reach) & ~reach & att3
        all_in = (reach & defenders3).flatten(1).sum(1) == defenders3.flatten(1).sum(1)
        sec = _secure(boundary, reach, b3, hostile3, planes, st, 0, 1, False, True)
        o_enclosed = ~fail & all_in & sec
    else:
        o_enclosed = torch.zeros_like(valid_basic)
    edge_flat = edge.reshape(nn)
    corner_flat = corner.reshape(nn)
    if st["exit_fort"]:
        king_at_edge = edge_flat[kflat]
        live = (side == 1) & king_at_edge
        reach = _flood(kseed & live[:, None, None], empty3 | kseed)
        dil = _dil4(reach)
        fail_neither = (dil & att3).flatten(1).any(1)
        fail_corner = (reach & corner).flatten(1).any(1)
        boundary = dil & ~reach & def3
        king_free = torch.zeros_like(valid_basic)
        for dr, dc in DRDC:
            r2, c2 = kr + dr, kc + dc
            a_in = (r2 >= 0) & (r2 < n) & (c2 >= 0) & (c2 < n)
            king_free = king_free | (a_in & (b3[ar, r2.clamp(0, n - 1), c2.clamp(0, n - 1)] == EMPTY))
        sec = _secure(boundary, reach, b3, hostile3, planes, st, 1, 0, True, False)
        o_exit_fort = king_at_edge & ~fail_neither & ~fail_corner & king_free & sec
    else:
        o_exit_fort = torch.zeros_like(valid_basic)

    # ---- next player's legal mask, also the NoPlays check ----
    next_mask = legal_mask_plain(env, b3, (1 - sides).to(torch.int32))
    has_play = next_mask.any(1)

    # ---- repetition ring (state.rs:92-113) ----
    n_caps = cap.sum(1)
    capt_any = n_caps > 0
    king_captured = cap[ar, kflat]
    rec = side + 2 * capt_any.long() + 4 * a
    fi = rep_first_i.long()
    ring = recent_plays.long()
    oldest = ring.gather(1, fi[:, None])[:, 0]
    match = ~capt_any & (oldest == rec)
    sa = side == 0
    reps_l = reps.long()
    mid = torch.where(sa, mid_pair[:, 0], mid_pair[:, 1])
    cur = torch.where(sa, reps_l[:, 0], reps_l[:, 1])
    new_rep_side = torch.where(match, cur + (~mid).long(), 0)
    new_mid_side = match & ~mid
    ring_out = torch.where(torch.arange(4, device=dev)[None, :] == fi[:, None], rec[:, None], ring)

    # ---- outcome priority select (logic.rs:702-771) ----
    n_att3 = att3.flatten(1).sum(1)
    n_def3 = defenders3.flatten(1).sum(1)
    escape_tile = edge_flat[to] if st["edge_escape"] else corner_flat[to]
    o_rep = new_rep_side >= st["rep_n"] if st["rep_n"] > 0 else torch.zeros_like(sa)
    loss, draw_np = st["rep_is_loss"], st["draw_on_no_plays"]
    candidates = [
        (torch.where(sa, n_def3, n_att3) == 0, side, 3),
        (sa & king_captured, 0, 2),
        (sa & o_enclosed, 0, 4),
        (~sa & (moving == CELL_KING) & escape_tile, 1, 0),
        (~sa & o_exit_fort, 1, 1),
        (o_rep, 1 - side if loss else 2, 6 if loss else 16),
        (~has_play, 2 if draw_np else side, 17 if draw_np else 5),
    ]
    result = torch.full_like(side, -1)
    reason = torch.full_like(side, -1)
    done = torch.zeros_like(sa)
    for cond, res, why in candidates:
        take = cond & ~done
        result = torch.where(take, res, result)
        reason = torch.where(take, why, reason)
        done = done | cond

    rows = [
        valid_basic, moving, trc, tcc, kflat, king_captured, edge_flat[to],
        corner_flat[to], o_enclosed, o_exit_fort, result, reason, done,
        (fi + 1) % 4,
        torch.where(sa, new_rep_side, reps_l[:, 0]),
        torch.where(sa, reps_l[:, 1], new_rep_side),
        torch.where(sa, new_mid_side, mid_pair[:, 0]),
        torch.where(sa, mid_pair[:, 1], new_mid_side),
        plays_since_capture.long() + (~capt_any).long(),
        ring_out[:, 0], ring_out[:, 1], ring_out[:, 2], ring_out[:, 3],
        n_caps,
    ]
    scal = torch.stack([x.to(torch.int32) for x in rows], dim=1)
    return board3.reshape(B, n, n), cap.reshape(B, n, n), next_mask, scal


# ----------------------------------------------------------------------
# Wrapper
# ----------------------------------------------------------------------


def cuda_args(env, device):
    """The kernels' rule table on ``device`` and their rule switches."""

    def build(dev):
        tab = torch.as_tensor(_bit_planes(env).view(np.int32), device=dev).contiguous()
        return tab, params_struct(env)

    return env.cached("kernel_args", device, build)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(
            f"step_arrays: {name} must be {dtype}{shape} on {device}, "
            f"got {t.dtype}{tuple(t.shape)} on {t.device}"
        )
    return t.contiguous()


def step_arrays(env, boards, sides, actions, recent_plays, rep_first_i, reps,
                mid_pair, plays_since_capture):
    """One step of every game: ``(board3 int8[B, N, N], cap bool[B, N, N],
    next_mask bool[B, A], scal int32[B, 24])``, the scalars in
    :data:`SCALAR_ROWS` order.

    ``valid`` does not include the game's terminated flag; the caller's
    freeze (``TaflEnv._epilogue``) discards every output of an invalid or
    terminated game. A CPU tensor goes to :func:`step_plain`; a CUDA tensor
    to the CUDA kernel, which raises if it cannot build or launch.
    """
    if boards.device.type == "cpu":
        return step_plain(env, boards, sides, actions, recent_plays, rep_first_i,
                          reps, mid_pair, plays_since_capture)
    if boards.device.type != "cuda":
        raise ValueError(f"step_arrays: unsupported device {boards.device}")
    n = env.n
    B = boards.shape[0]
    dev = boards.device
    i32 = torch.int32
    boards = _check("boards", boards, torch.int8, (B, n, n), dev)
    sides = _check("sides", sides, i32, (B,), dev)
    actions = _check("actions", actions, i32, (B,), dev)
    recent_plays = _check("recent_plays", recent_plays, i32, (B, 4), dev)
    rep_first_i = _check("rep_first_i", rep_first_i, i32, (B,), dev)
    reps = _check("reps", reps, i32, (B, 2), dev)
    mid_pair = _check("mid_pair", mid_pair, torch.bool, (B, 2), dev)
    psc = _check("plays_since_capture", plays_since_capture, i32, (B,), dev)
    tab, params = cuda_args(env, dev)
    lib = _build.load_library()
    board3 = torch.empty((B, n, n), dtype=torch.int8, device=dev)
    cap = torch.empty((B, n, n), dtype=torch.bool, device=dev)
    next_mask = torch.empty((B, env.num_actions), dtype=torch.bool, device=dev)
    scal = torch.empty((B, len(SCALAR_ROWS)), dtype=i32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # The ctypes call launches on the host thread's CURRENT device, on a
    # stream of the tensor's: a rank on cuda:1 whose current device is 0
    # would fail at launch, so enter the tensor's device around it.
    with torch.cuda.device(dev):
        rc = lib.tafl_step(
            boards.data_ptr(), sides.data_ptr(), actions.data_ptr(),
            recent_plays.data_ptr(), rep_first_i.data_ptr(), reps.data_ptr(),
            mid_pair.data_ptr(), psc.data_ptr(), tab.data_ptr(),
            ctypes.addressof(params), B, board3.data_ptr(),
            cap.data_ptr(), next_mask.data_ptr(), scal.data_ptr(), stream,
        )
    _build.check(rc, "tafl_step")
    step_arrays.launches += 1
    return board3, cap, next_mask, scal


step_arrays.launches = 0
