"""The comparison that decides a self-play cell's ``correct``.

It judges what the window produced, at the window's sizes, against the
plain references beside it: the frozen rules oracle (:mod:`.game`) and the
float32 net (:mod:`.net`). It reads the program's outputs only to judge
them and works every state out again from the traffic's own inputs.

For a sample of rows drawn from the seed:

- ``rules_mismatch`` (exact): the rows are replayed from the opening by the
  traffic's random choices and then by the actions the window played. Each
  start state, each position before a move, each action's legality, each
  state after a move (outcome, repetition counts and pairs, plays since a
  capture, turn), each end of a game and restart, the policy target's
  support, each replay record of an ended game, the root legal mask (kernel
  1) of the captured moves, and every node of the captured search trees
  (each a play of its parent's state, kernel 2) must be the reference's.
- ``move_mismatch`` (exact): a move under the temperature plays an action
  of the policy target; one after it plays an action of the target's
  largest share.
- ``search_mismatch`` (exact): in each captured tree the root's visits are
  the simulations; the policy target is the root's visit shares and the
  root value its mean backed-up value; every visited edge has a node and
  every node was evaluated at least once.
- ``logit_gap``: the largest gap between the net's root logits (over
  legal actions) in the window and the reference's.
- ``value_gap_ratio``: the net's root values against the reference's,
  taken before the tanh (``atanh`` of each): the root mean square of the
  gaps over that of the same reference computed with a bf16 trunk. The
  ratio takes out how far a seed's weights amplify rounding, which moved
  plain gaps 3x from seed to seed for the program and the control alike.
- ``prior_gap``: the largest gap in log space between a tree node's child
  priors and the reference's masked softmax there (at the root mixed with
  the root noise, redrawn from the generator's state before the search),
  and the largest reference prior left out of a node's kept children
  beyond its smallest kept one.
- ``backup_gap_ratio``: every non-root node's value as the backups left
  it (its parent edge's summed value less its children's, per evaluation)
  against the reference's value there, measured as ``value_gap_ratio`` is;
  a node of an ended game must have backed up its result
  (``search_mismatch``).

The control (``benchmark/control.py``) is a run with the reference net
with an fp8 trunk in the program's net's place as the search's
``evaluate``; this same comparison judges it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import game as G
from . import net as N

def _post_of(f: dict) -> tuple:
    return (f["terminated"], f["result"], f["reason"], f["side"], f["turn"],
            f["plays_since_capture"], f["reps"][0], f["reps"][1], f["mid_pair"][0],
            f["mid_pair"][1])


class Tally:
    def __init__(self):
        self.counts = {"rules_mismatch": 0, "move_mismatch": 0, "search_mismatch": 0}
        self.notes = []

    def fail(self, kind: str, what: str):
        self.counts[kind] += 1
        if len(self.notes) < 12:
            self.notes.append(f"{kind}: {what}")


def _same_state(port: dict, ref: dict) -> bool:
    """The port's fields (arrays) equal the reference's :func:`game.fields`."""
    return (np.array_equal(port["board"], ref["board"])
            and int(port["side"]) == ref["side"]
            and tuple(int(x) for x in port["reps"]) == tuple(ref["reps"])
            and tuple(int(x) for x in port["mid_pair"]) == tuple(ref["mid_pair"])
            and int(port["plays_since_capture"]) == ref["plays_since_capture"]
            and int(port["turn"]) == ref["turn"]
            and int(port["terminated"]) == ref["terminated"]
            and int(port["result"]) == ref["result"]
            and int(port["reason"]) == ref["reason"])


def _row_fields(d: dict, *idx) -> dict:
    return {k: v[idx] for k, v in d.items()}


def replay_rows(rec: dict, cfg: dict, R: G.Rules, tally: Tally):
    """Replays the sampled rows; returns the root states of the captured
    moves ``{(move, row): state}`` and the reference's records of the games
    that ended ``{(row, move): (boards, sides, reps, pidx, pp, z)}``."""
    sp = cfg["selfplay"]
    roots, records = {}, {}
    want_roots = {(m, int(r)) for m, c in rec["captures"].items() for r in c["root_rows"]}
    for r in rec["check_rows"]:
        r = int(r)
        S = R.opening()
        for p in range(int(rec["start_ply"][r])):
            legal = R.legal(S)
            S = R.play(S, int(legal[int(rec["choices"][p, r]) % len(legal)]))
            if not S.ongoing:
                S = R.opening()
        if not _same_state(_row_fields(rec["start"], r), G.fields(S)):
            tally.fail("rules_mismatch", f"row {r}: the start state differs")
            continue
        episode = []
        for m, mv in enumerate(rec["moves"]):
            if not np.array_equal(mv["board"][r], S.board):
                tally.fail("rules_mismatch", f"row {r} move {m}: the board before the move")
                break
            legal = R.legal(S)
            if (m, r) in want_roots:
                roots[(m, r)] = S
            a = int(mv["actions"][r])
            pa, pp = mv["top_a"][r], mv["top_p"][r]
            support = pa[pp > 0]
            if not np.isin(support, legal).all():
                tally.fail("rules_mismatch", f"row {r} move {m}: the policy target has an "
                                             "illegal action")
            if S.turn < sp["temp_threshold"]:
                ok = bool((pp[pa == a] > 0).any())
            else:
                ok = a in set(pa[(pp == pp.max()) & (pp > 0)].tolist())
            if not ok:
                tally.fail("move_mismatch", f"row {r} move {m}: action {a} against the policy")
            S2 = R.play(S, a)
            if S2 is None:
                tally.fail("rules_mismatch", f"row {r} move {m}: action {a} is illegal")
                break
            episode.append((S.board.copy(), int(S.side_to_play), G.mover_reps(S), pa, pp))
            if tuple(int(x) for x in mv["post"][r]) != _post_of(G.fields(S2)):
                tally.fail("rules_mismatch", f"row {r} move {m}: the state after the move "
                                             f"{mv['post'][r].tolist()} against "
                                             f"{list(_post_of(G.fields(S2)))}")
                break
            ended = (not S2.ongoing) or S2.turn >= sp["max_game_len"]
            if ended != bool(mv["ended"][r]):
                tally.fail("rules_mismatch", f"row {r} move {m}: the game's end")
                break
            if ended:
                o = S2.outcome
                sides = np.array([e[1] for e in episode], np.int8)
                if o is not None and o.winner is not None:
                    z = np.where(sides == int(o.winner), 1.0, -1.0).astype(np.float32)
                else:
                    z = np.zeros(len(episode), np.float32)
                records[(r, m)] = (np.stack([e[0] for e in episode]), sides,
                                   np.array([e[2] for e in episode], np.int8),
                                   np.stack([e[3] for e in episode]),
                                   np.stack([e[4] for e in episode]), z)
                episode = []
                S = R.opening()
            else:
                S = S2
    return roots, records


def check_records(rec: dict, records: dict, tally: Tally):
    """Every replay record of a sampled row's ended game is the reference's."""
    ring = rec["replay"]
    cap = ring["value"].shape[0]
    for add in rec["adds"]:
        key = (add["row"], add["move"])
        if key not in records:
            tally.fail("rules_mismatch", f"row {key[0]} move {key[1]}: a game the reference "
                                         "did not end was written")
            continue
        boards, sides, reps, pidx, pp, z = records[key]
        idx = (add["at"] + np.arange(add["length"])) % cap
        K = ring["policy_idx"].shape[1]
        if not (len(idx) == len(z)
                and np.array_equal(ring["board"][idx], boards)
                and np.array_equal(ring["side"][idx], sides)
                and np.array_equal(ring["reps"][idx], reps)
                and np.array_equal(ring["value"][idx], z)
                and np.array_equal(ring["policy_idx"][idx], pidx[:, :K])
                and np.array_equal(ring["policy_p"][idx], pp[:, :K])):
            tally.fail("rules_mismatch", f"row {key[0]} move {key[1]}: a replay record")
    ended = {(a["row"], a["move"]) for a in rec["adds"]}
    for key in records:
        if key not in ended:
            tally.fail("rules_mismatch", f"row {key[0]} move {key[1]}: an ended game was not "
                                         "written")


def _noise(gen_state, board_all, side_all, R: G.Rules, rows, alpha_scale, device):
    """The root's Dirichlet noise for ``rows``, redrawn as the search drew it:
    standard gammas of ``alpha = scale / n_legal`` on the legal actions and
    1e-3 elsewhere, over the whole batch, from the generator's state. The
    batch's legal counts come from the boards the window searched, which
    only reproduces the draw: where one is wrong the sampled rows' noise
    differs and the check fails."""
    B, A = board_all.shape[0], R.num_actions
    alpha = np.full((B, A), 1e-3, np.float32)
    legal_rows = {}
    for b in range(B):
        S = R.opening()
        S.board = board_all[b].copy()
        S.side_to_play = type(S.side_to_play)(int(side_all[b]))
        mask = R.legal_mask(S)
        legal_rows[b] = mask
        n = np.float32(max(int(mask.sum()), 1))
        alpha[b] = np.where(mask, np.float32(alpha_scale) / n, np.float32(1e-3))
    g = torch.Generator(device=device)
    g.set_state(torch.as_tensor(gen_state))
    gam = torch._standard_gamma(torch.as_tensor(alpha, device=device), generator=g)
    gam = gam.double().cpu().numpy()
    out = {}
    for r in rows:
        noise = gam[r] / max(gam[r].sum(), 1e-30)
        noise = noise * legal_rows[r]
        out[r] = noise / max(noise.sum(), 1e-30)
    return out


def _log(p):
    with np.errstate(divide="ignore"):
        return np.log(np.asarray(p, np.float64))


def _prior_gap(actions: np.ndarray, priors: np.ndarray, ref: np.ndarray, legal: np.ndarray):
    """Largest gap in log space between the kept children's priors and the
    reference's, and the largest reference prior left out beyond the
    smallest kept one (a ratio, in log space too)."""
    kept = actions >= 0
    if not kept.any():
        return float("inf") if legal.any() else 0.0
    a = actions[kept]
    gap = float(np.abs(_log(priors[kept]) - _log(ref[a])).max())
    rest = legal.copy()
    rest[a] = False
    if rest.any():
        gap = max(gap, float(_log(ref[rest].max()) - _log(ref[a].min())))
    return gap


def _z(v):
    """The value head's pre-tanh activation of values ``v`` in (-1, 1)."""
    v = np.asarray(v, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(np.abs(v) < 1.0, np.arctanh(np.clip(v, -1.0, 1.0)), np.inf)


def _gap_ratio(v_port, v_ref, v_bf16) -> float:
    """The root mean square of ``atanh(v_port) - atanh(v_ref)`` (the value
    head's error before its tanh) over that of the reference computed with
    a bf16 trunk: about 1 for a sound bf16 net on any seed's weights."""
    z_ref = _z(v_ref)
    if not z_ref.size:
        return 0.0
    scale = float(np.sqrt(np.mean((_z(v_bf16) - z_ref) ** 2)))
    return float(np.sqrt(np.mean((_z(v_port) - z_ref) ** 2))) / max(scale, 1e-12)


def check_trees(rec, roots, weights, cfg, R, tally, gen_states, device):
    """The captured search trees against the references; returns the gaps."""
    se = cfg["search"]
    blocks = cfg["net"]["blocks"]
    K = se["max_children"]
    gaps = {"logit_gap": 0.0, "prior_gap": 0.0}
    roots_v, nodes_v = [], []  # values: (program, reference, bf16 reference)
    for m, cap in sorted(rec["captures"].items()):
        mv = rec["moves"][m]
        # The root's net outputs, on every sampled row the replay reached.
        rows = [int(r) for r in cap["root_rows"] if (m, int(r)) in roots]
        pos = {int(r): i for i, r in enumerate(cap["root_rows"])}
        states = [roots[(m, r)] for r in rows]
        if not states:
            continue
        boards = np.stack([s.board for s in states])
        sides = np.array([int(s.side_to_play) for s in states])
        reps = np.array([G.mover_reps(s) for s in states])
        legal = np.stack([R.legal_mask(s) for s in states])
        lo, va = N.evaluate(weights, blocks, boards, sides, reps)
        _, va16 = N.evaluate(weights, blocks, boards, sides, reps, precision="bf16")
        for i, r in enumerate(rows):
            if not np.array_equal(cap["root_legal"][pos[r]], legal[i]):
                tally.fail("rules_mismatch", f"row {r} move {m}: the root legal mask")
            d = np.abs(cap["root_logits"][pos[r]].astype(np.float64) - lo[i])[legal[i]]
            gaps["logit_gap"] = max(gaps["logit_gap"], float(d.max()) if d.size else 0.0)
        v_port = np.array([cap["root_value"][pos[r]] for r in rows], np.float64)
        roots_v.append((v_port, va, va16))

        # The trees.
        tree_rows = [int(r) for r in cap["tree_rows"]]
        noise = _noise(gen_states[m], mv["board"], mv["side"], R,
            [r for r in tree_rows if (m, r) in roots], se["dirichlet_alpha_scale"], device)
        nodes = []  # (tree index t, row r, node i, state, legal mask, parent (i, k) or None)
        for t, r in enumerate(tree_rows):
            if (m, r) not in roots:
                continue
            T = {k: v[t] for k, v in cap["tree"].items()}
            stack = [(0, roots[(m, r)], None)]
            while stack:
                i, S, parent = stack.pop()
                f = G.fields(S)
                port = {"board": T["board"][i], "side": T["side_to_play"][i],
                        "reps": T["reps"][i], "mid_pair": T["mid_pair"][i],
                        "plays_since_capture": T["plays_since_capture"][i],
                        "turn": T["turn"][i], "terminated": T["terminated"][i],
                        "result": T["result"][i], "reason": T["reason"][i]}
                if not _same_state(port, f):
                    tally.fail("rules_mismatch", f"row {r} move {m}: tree node {i}'s state")
                    continue
                mask = R.legal_mask(S)
                if S.ongoing != bool(T["expanded"][i]) or (not S.ongoing) != bool(T["terminal"][i]):
                    tally.fail("search_mismatch", f"row {r} move {m}: node {i}'s flags")
                if not S.ongoing and float(T["terminal_value"][i]) != G.terminal_value(S):
                    tally.fail("rules_mismatch", f"row {r} move {m}: node {i}'s terminal value")
                nodes.append((t, r, i, S, mask, parent, T))
                for k in range(K):
                    a, j = int(T["child_action"][i, k]), int(T["child_node"][i, k])
                    if a >= 0 and not mask[a]:
                        tally.fail("rules_mismatch", f"row {r} move {m}: node {i} keeps an "
                                                     f"illegal child {a}")
                        continue
                    if (T["child_N"][i, k] > 0) != (j >= 0):
                        tally.fail("search_mismatch", f"row {r} move {m}: edge {i}/{k}'s "
                                                      "visits and link")
                    if j >= 0:
                        stack.append((j, R.play(S, a), (i, k)))
            # The root: visits, policy target and value.
            n_root = T["child_N"][0]
            total = int(n_root.sum())
            if total != se["num_simulations"]:
                tally.fail("search_mismatch", f"row {r} move {m}: {total} root visits")
            acts = T["child_action"][0]
            want = {int(a): np.float32(c) / np.float32(total)
                    for a, c in zip(acts, n_root) if a >= 0 and c > 0}
            got = {int(a): p for a, p in zip(mv["top_a"][r], mv["top_p"][r]) if p > 0}
            if want != got:
                tally.fail("search_mismatch", f"row {r} move {m}: the policy target is not "
                                              "the root's visit shares")
            w_sum = np.float32(0.0)
            for a, w in zip(acts, T["child_W"][0]):
                w_sum = np.float32(w_sum + (np.float32(w) if a >= 0 else np.float32(0.0)))
            root_v = w_sum / np.float32(max(total, 1))
            if abs(float(root_v) - float(mv["root_v"][r])) > 1e-6:
                tally.fail("search_mismatch", f"row {r} move {m}: the root value")
        live = [x for x in nodes if x[3].ongoing]
        if not live:
            continue
        bo = np.stack([x[3].board for x in live])
        si = np.array([int(x[3].side_to_play) for x in live])
        rp = np.array([G.mover_reps(x[3]) for x in live])
        lo, va = N.evaluate(weights, blocks, bo, si, rp)
        _, va16 = N.evaluate(weights, blocks, bo, si, rp, precision="bf16")
        value = {}
        for q, (t, r, i, S, mask, parent, T) in enumerate(live):
            value[(t, i)] = (va[q], va16[q])
            p_ref = N.masked_priors(lo[q][None], mask[None])[0]
            if i == 0:
                eps = se["dirichlet_eps"]
                p_ref = ((1 - eps) * p_ref + eps * noise[r]) * mask
            gaps["prior_gap"] = max(gaps["prior_gap"], _prior_gap(
                T["child_action"][i], T["child_prior"][i].astype(np.float64), p_ref, mask))
        # Each node's evaluations as the backups left them: its parent
        # edge's sum less its children's, per evaluation. For a live node
        # that is the program's value there; for an ended game its result.
        for (t, r, i, S, mask, parent, T) in nodes:
            if parent is None:
                continue
            pi, pk = parent
            e = int(T["child_N"][pi, pk]) - int(T["child_N"][i].sum())
            if e < 1:
                tally.fail("search_mismatch", f"row {r} move {m}: node {i} never evaluated")
                continue
            own = -(float(T["child_W"][pi, pk]) + float(T["child_W"][i].astype(np.float64).sum())) / e
            if S.ongoing:
                nodes_v.append((own,) + value[(t, i)])
            elif abs(own - G.terminal_value(S)) > 1e-4:
                tally.fail("search_mismatch", f"row {r} move {m}: node {i}'s result backed up "
                                              f"as {own}")
    gaps["value_gap_ratio"] = _gap_ratio(*_cols(roots_v, 0, 1, 2))
    gaps["backup_gap_ratio"] = _gap_ratio(*_cols(nodes_v, 0, 1, 2))
    return gaps


def _cols(rows, *cols):
    """Columns ``cols`` of ``rows`` (program, reference, bf16 reference),
    each concatenated."""
    return tuple(np.concatenate([np.atleast_1d(np.asarray(r[c], np.float64)) for r in rows])
                 if rows else np.zeros(0) for c in cols)


def check(rec: dict, gen_states: dict, weights: dict, cfg: dict, device) -> dict:
    """``{name: {"value", "limit"}}`` in a fixed order, and beside it
    ``"notes"``: the first faults."""
    R = G.Rules(cfg["preset"])
    tally = Tally()
    roots, records = replay_rows(rec, cfg, R, tally)
    check_records(rec, records, tally)
    gaps = check_trees(rec, roots, weights, cfg, R, tally, gen_states, device)
    limits = cfg["limits"]
    values = dict(tally.counts)
    values.update(gaps)
    out = {name: {"value": float(values[name]), "limit": float(limits[name])} for name in limits}
    extra = {"notes": tally.notes, "roots_checked": len(roots),
             "records_checked": len(rec["adds"])}
    return out, extra
