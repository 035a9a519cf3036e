"""Batched array-tree MCTS in PyTorch.

The counterpart of ``alphazeroforhnefatafl_tpu/search/mcts.py``. A batch of
B trees advances in lockstep. With ``leaves_per_wave=1`` (the exact serial
search) a wave takes one leaf per tree, with one env step and one network
forward over all B leaves; with ``leaves_per_wave=L > 1`` a wave runs L
virtual-loss traversals per tree and then one env step, one forward and one
backup over the B*L leaves. The root is selected by PUCT (with optional
Dirichlet noise) or by Gumbel top-m with sequential halving (Danihelka et
al. 2022); interior selection is PUCT either way.

Semantics kept from the reference (``src/mcts.py``): PUCT
``u = Q + cpuct * P * sqrt(Ns + EPS) / (1 + Nsa)`` with ``Q = 0`` on unvisited
edges; legal-masked, renormalized priors with a uniform fallback; negamax
values backed up as running sums; visit-count action probabilities. Each
node keeps its ``max_children`` highest-prior actions (ties in index order,
as ``lax.top_k``), and the tree is a tree, not a transposition table.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..core.env import EnvState, TaflEnv
from ..utils.profiling import span

EPS = 1e-8  # src/mcts.py:6
NEG_INF = -1e30


@dataclass(frozen=True)
class MCTSConfig:
    """The fields and defaults of the JAX ``MCTSConfig``; every value that
    one accepts the other accepts, and :class:`MCTS` raises ``ValueError``
    on the same invalid ones.

    ``root_selection``: ``"puct"``, or ``"gumbel"`` (Gumbel top-m with
    sequential halving over at most ``gumbel_considered`` root candidates
    and completed Q-values, ``sigma(q) = (gumbel_cvisit + max N) *
    gumbel_cscale * q``). Under ``"gumbel"`` play the returned
    ``best_action``; ``action_probs`` is the improved policy
    ``softmax(logits + sigma(completed Q))``, the training target, and no
    Dirichlet noise is added.

    ``leaves_per_wave`` (PUCT only, must divide ``num_simulations``): L
    virtual-loss traversals per tree per wave, then one env step, one
    forward and one backup over the B*L leaves. Within a wave, traversal l
    counts every edge on an earlier traversal's path as one more visit that
    lost ``virtual_loss``, and a traversal that lands on an edge an earlier
    one claimed evaluates that child again instead of linking a second node.
    1 is the exact serial search. The default ``virtual_loss`` of 0.25 is
    the JAX package's, chosen there by head-to-head matches of a trained
    11x11 net (``runs/search_ab_r5.jsonl``).

    The TPU layout knobs have one form here and are accepted for
    compatibility: ``topk`` (``"approx"`` is ``lax.approx_max_k`` there; the
    port always takes the exact top-k with ties in index order, which meets
    any recall target), ``topk_recall``, ``traverse_unroll``, ``backup`` and
    ``node_read`` (the port reads and writes the tree by indexing and
    scatter).
    """

    num_simulations: int = 128
    max_children: int = 128
    cpuct: float = 1.5
    dirichlet_alpha: float = 0.3
    dirichlet_alpha_scale: "float | None" = None
    dirichlet_eps: float = 0.25  # 0 disables root noise
    max_depth: int = 64
    topk: str = "auto"
    topk_recall: float = 0.99
    traverse_unroll: int = 4
    backup: str = "auto"
    node_read: str = "auto"
    root_selection: str = "puct"
    gumbel_considered: int = 16
    gumbel_cvisit: float = 50.0
    gumbel_cscale: float = 1.0
    leaves_per_wave: int = 1
    virtual_loss: float = 0.25


@dataclass
class Tree:
    """B trees of ``M = num_simulations + 1`` node slots and ``K`` edge slots.

    Node states are kept field by field (``state``: an :class:`EnvState`
    whose tensors are ``[B, M, ...]``).
    """

    state: EnvState
    expanded: torch.Tensor  # bool[B, M]
    terminal: torch.Tensor  # bool[B, M]
    terminal_value: torch.Tensor  # f32[B, M], node-mover perspective
    child_action: torch.Tensor  # i32[B, M, K], -1 = empty slot
    child_prior: torch.Tensor  # f32[B, M, K]
    child_N: torch.Tensor  # i32[B, M, K]
    child_W: torch.Tensor  # f32[B, M, K]
    child_node: torch.Tensor  # i32[B, M, K], -1 = not materialized


@dataclass
class SearchResult:
    action_probs: torch.Tensor  # f32[B, A] visit-count (puct) / improved (gumbel) policy
    root_value: torch.Tensor  # f32[B] root value (mover perspective)
    root_visits: torch.Tensor  # i32[B]
    best_action: torch.Tensor  # i32[B] action to play (gumbel: the halving winner)
    prior_fallback_rate: torch.Tensor  # f32[B]
    tree: Tree


def terminal_value(state: EnvState) -> torch.Tensor:
    """Value of a terminal state for its player to move (``src/mcts.py:77-81``)."""
    side = state.side_to_play
    return torch.where(
        state.result == side, 1.0, torch.where(state.result == 1 - side, -1.0, 0.0)
    ).to(torch.float32)


def _masked_priors_fb(logits: torch.Tensor, legal: torch.Tensor):
    """Legal-masked renormalized priors with the uniform fallback
    (``src/mcts.py:83-102``), and ``bool[B]``: where the fallback fired."""
    masked = torch.where(legal, logits, NEG_INF)
    p = torch.softmax(masked, dim=-1) * legal
    total = p.sum(-1, keepdim=True)
    n_legal = legal.sum(-1, keepdim=True).clamp(min=1)
    fell_back = total[:, 0] <= 0
    return torch.where(total > 0, p / total.clamp(min=1e-30), legal / n_legal), fell_back


def _top_k(x: torch.Tensor, k: int):
    """Descending top-k with ties in index order, as ``lax.top_k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _dirichlet(alpha: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Rows of Dirichlet samples: normalized standard gammas."""
    g = torch._standard_gamma(alpha, generator=generator)
    return g / g.sum(-1, keepdim=True).clamp(min=1e-30)


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel samples ``-log(-log(u))``, ``u`` uniform in (0, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp(min=tiny)
    return -torch.log(-torch.log(u))


def _sh_considered_schedule(sims: int, m0: int) -> list:
    """Sequential-halving schedule: entry w is the size of the considered
    root candidate set at simulation w. About log2(m0) equal-budget phases,
    the candidates halving between phases, the leftover simulations spent on
    the last, two-candidate phase."""
    if m0 <= 1:
        return [1] * sims
    phases = max(1, math.ceil(math.log2(m0)))
    base = sims // phases
    out = []
    m = m0
    for p in range(phases):
        budget = base if p < phases - 1 else sims - base * (phases - 1)
        out.extend([m] * budget)
        m = max(2, m // 2)
    while len(out) < sims:
        out.append(2)
    return out[:sims]


_MODES = (
    ("node_read", ("auto", "gather", "dot")),
    ("topk", ("auto", "approx", "exact")),
    ("backup", ("auto", "dense", "scatter")),
    ("root_selection", ("puct", "gumbel")),
)


class MCTS:
    """Batched MCTS bound to an env and an evaluation function.

    ``evaluate(obs f32[B, N, N, C]) -> (logits f32[B, A], value f32[B])``.
    """

    def __init__(self, env: TaflEnv, evaluate: Callable, config: MCTSConfig, device=None):
        for name, allowed in _MODES:
            val = getattr(config, name)
            if val not in allowed:
                raise ValueError(f"MCTSConfig.{name}={val!r}; expected one of {sorted(allowed)}")
        L = config.leaves_per_wave
        if L < 1:
            raise ValueError(f"leaves_per_wave={L}; must be >= 1")
        if L > 1:
            if config.root_selection == "gumbel":
                raise ValueError(
                    "leaves_per_wave > 1 needs root_selection='puct' (the gumbel "
                    "halving schedule forces one root slot per simulation)"
                )
            if config.num_simulations % L:
                raise ValueError(
                    f"num_simulations={config.num_simulations} must be a multiple "
                    f"of leaves_per_wave={L}"
                )
        self.env = env
        self.evaluate = evaluate
        self.config = config
        self.device = torch.device(device) if device is not None else env.device
        self.num_nodes = config.num_simulations + 1

    # -------------------- tree --------------------

    def _empty_tree(self, root: EnvState, priors: torch.Tensor) -> Tree:
        B = root.batch_size
        M, K = self.num_nodes, self.config.max_children
        dev = root.board.device
        i32 = torch.int32
        state = root.map(lambda x: x[:, None].expand((B, M) + x.shape[1:]).clone())
        top_p, top_a = _top_k(priors, K)
        has_mass = top_p > 0
        child_action = torch.full((B, M, K), -1, dtype=i32, device=dev)
        child_prior = torch.zeros((B, M, K), dtype=torch.float32, device=dev)
        child_action[:, 0] = torch.where(has_mass, top_a, -1).to(i32)
        child_prior[:, 0] = torch.where(has_mass, top_p, 0.0)
        expanded = torch.zeros((B, M), dtype=torch.bool, device=dev)
        expanded[:, 0] = True
        terminal = torch.zeros((B, M), dtype=torch.bool, device=dev)
        terminal[:, 0] = root.terminated
        tval = torch.zeros((B, M), dtype=torch.float32, device=dev)
        tval[:, 0] = terminal_value(root)
        return Tree(
            state=state,
            expanded=expanded,
            terminal=terminal,
            terminal_value=tval,
            child_action=child_action,
            child_prior=child_prior,
            child_N=torch.zeros((B, M, K), dtype=i32, device=dev),
            child_W=torch.zeros((B, M, K), dtype=torch.float32, device=dev),
            child_node=torch.full((B, M, K), -1, dtype=i32, device=dev),
        )

    def _select_slot(self, tree: Tree, rows, node, vn=None) -> torch.Tensor:
        """PUCT argmax over each game's node's edge slots (``src/mcts.py:109-121``).

        ``vn`` (``f32[B, K]``, multi-leaf waves only): virtual visit counts
        from this wave's pending traversals; each counts as ``virtual_loss``
        losses on its edge. Without it the visit counts stay integers, so a
        single-leaf search is exactly the serial search.
        """
        N = tree.child_N[rows, node]
        W = tree.child_W[rows, node]
        P = tree.child_prior[rows, node]
        if vn is None:
            Ns = N.sum(-1).to(torch.float32)  # Ns == sum of edge visits
            Q = torch.where(N > 0, W / N.clamp(min=1), 0.0)
            u = Q + self.config.cpuct * P * torch.sqrt(Ns + EPS)[:, None] / (1.0 + N)
        else:
            Nf = N.to(torch.float32) + vn
            Wf = W - self.config.virtual_loss * vn
            Ns = Nf.sum(-1)
            Q = torch.where(Nf > 0, Wf / Nf.clamp(min=1.0), 0.0)
            u = Q + self.config.cpuct * P * torch.sqrt(Ns + EPS)[:, None] / (1.0 + Nf)
        u = torch.where(tree.child_action[rows, node] >= 0, u, NEG_INF)
        return u.argmax(-1)

    def _traverse(self, tree: Tree, forced_root_slot=None, prev=()):
        """Walk every tree from its root to a leaf edge (no env step).

        ``forced_root_slot`` (``i64[B]``): the edge slot to take at the root,
        -1 for PUCT (Gumbel root selection forces root candidates). ``prev``: the
        results of this wave's earlier traversals; every ``(node, slot)`` on
        one of their paths adds one virtual visit to selection at that node.

        Returns a dict: ``node`` (where the walk stopped), ``depth``, the
        recorded ``path_nodes``/``path_slots`` ``[B, D]``, ``leaf_parent``/
        ``leaf_slot`` of the unmaterialized edge reached, and
        ``at_node_leaf``: the walk stopped at an unexpanded, terminal or
        depth-capped node instead.
        """
        B = tree.expanded.shape[0]
        D = self.config.max_depth
        K = self.config.max_children
        dev = tree.expanded.device
        rows = torch.arange(B, device=dev)
        node = torch.zeros(B, dtype=torch.long, device=dev)
        depth = torch.zeros(B, dtype=torch.long, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        at_node_leaf = torch.zeros(B, dtype=torch.bool, device=dev)
        leaf_parent = torch.zeros(B, dtype=torch.long, device=dev)
        leaf_slot = torch.zeros(B, dtype=torch.long, device=dev)
        path_nodes = torch.full((B, D), -1, dtype=torch.long, device=dev)
        path_slots = torch.full((B, D), -1, dtype=torch.long, device=dev)
        if prev:
            # Off-path entries hold node -1 and never match a node.
            prev_nodes = torch.cat([t["path_nodes"] for t in prev], 1)  # [B, Lp * D]
            prev_slots = torch.cat([t["path_slots"] for t in prev], 1).clamp(min=0)
        for _ in range(D):
            is_leaf = ~tree.expanded[rows, node] | tree.terminal[rows, node]
            vn = None
            if prev:
                match = (prev_nodes == node[:, None]).to(torch.float32)
                vn = torch.zeros((B, K), dtype=torch.float32, device=dev)
                vn.scatter_add_(1, prev_slots, match)
            slot = self._select_slot(tree, rows, node, vn)
            if forced_root_slot is not None:
                # Node 0 is only ever visited as the root.
                slot = torch.where((node == 0) & (forced_root_slot >= 0), forced_root_slot, slot)
            child = tree.child_node[rows, node, slot].long()
            hit_edge = ~is_leaf & (child < 0)
            descend = ~is_leaf & (child >= 0)
            capped = descend & (depth >= D - 1)
            record = ~is_leaf & ~done
            d = depth.clamp(max=D - 1)
            path_nodes[rows, d] = torch.where(record, node, path_nodes[rows, d])
            path_slots[rows, d] = torch.where(record, slot, path_slots[rows, d])
            live = ~done
            at_node_leaf = torch.where(live, is_leaf | capped, at_node_leaf)
            leaf_parent = torch.where(live & hit_edge, node, leaf_parent)
            leaf_slot = torch.where(live & hit_edge, slot, leaf_slot)
            node = torch.where(live & descend, child, node)
            depth = depth + record.long()
            done = done | is_leaf | hit_edge | capped
            # The walk's one host sync: every level waits for the card here.
            with span("mcts/level_sync"):
                finished = bool(done.all())
            if finished:
                break
        return dict(
            node=node, depth=depth, path_nodes=path_nodes, path_slots=path_slots,
            leaf_parent=leaf_parent, leaf_slot=leaf_slot, at_node_leaf=at_node_leaf,
        )

    def _wave(self, tree: Tree, sim0: int, forced_root_slot=None):
        """One simulation wave of ``leaves_per_wave`` = L leaves a tree,
        writing node slots ``sim0 + 1 .. sim0 + L``; returns (fallbacks,
        consumed) ``i32[B]``, counted over the wave's leaves.

        L sequential traversals, each seeing the earlier ones' paths as
        virtual losses, then one env step, one forward and one top-k over
        the B*L leaves (leaf-minor order), and one backup over all L paths.
        A traversal that lands on an edge an earlier leaf of the wave
        claimed is demoted to a second evaluation of that child: its value
        backs up its own path, but its node slot stays unlinked. With L = 1
        there is no earlier path, and the wave is the serial search's.
        """
        cfg = self.config
        L, D, K = cfg.leaves_per_wave, cfg.max_depth, cfg.max_children
        B = tree.expanded.shape[0]
        dev = tree.expanded.device
        ts = []
        for _ in range(L):
            with span("mcts/traverse"):
                ts.append(self._traverse(tree, forced_root_slot, prev=ts))

        def stacked(name):
            return torch.stack([t[name] for t in ts], 1)

        with span("mcts/leaf_step"):
            parent, slot = stacked("leaf_parent"), stacked("leaf_slot")  # [B, L]
            stop_node, at_node_leaf = stacked("node"), stacked("at_node_leaf")
            depth = stacked("depth")
            path_nodes, path_slots = stacked("path_nodes"), stacked("path_slots")  # [B, L, D]

            # Only the first claimant of an unmaterialized edge links and
            # expands. (A leaf demoted at j cannot hide a collision: l's
            # collision is then with j's own earlier claimant.)
            make_new = ~at_node_leaf
            for l in range(1, L):
                dup = torch.zeros(B, dtype=torch.bool, device=dev)
                for j in range(l):
                    dup |= (make_new[:, j] & (parent[:, j] == parent[:, l])
                            & (slot[:, j] == slot[:, l]))
                make_new[:, l] &= ~dup

            # One state read, env step and forward over [B, L] -> B*L.
            rows = torch.arange(B, device=dev).repeat_interleave(L)
            read_node = torch.where(at_node_leaf, stop_node, parent).reshape(-1)
            parent_state = tree.state.map(lambda x: x[rows, read_node])
            actions = tree.child_action[rows, parent.reshape(-1), slot.reshape(-1)].clamp(min=0)
            child, info = self.env.step_many(parent_state, actions)

            # Materialize the stepped children in slots idx0 .. idx0 + L - 1.
            idx0 = sim0 + 1
            slots = slice(idx0, idx0 + L)

            def write(buf, val, mask):
                """``buf[:, idx0 + l] = val[b * L + l]`` where ``mask[b, l]``."""
                val = val.reshape((B, L) + val.shape[1:])
                m = mask.reshape(mask.shape + (1,) * (val.dim() - 2))
                buf[:, slots] = torch.where(m, val, buf[:, slots])

            for f in dataclasses.fields(child):
                write(getattr(tree.state, f.name), getattr(child, f.name), make_new)
            term, tvals = child.terminated, terminal_value(child)
            write(tree.terminal, term, make_new)
            write(tree.terminal_value, tvals, make_new)
            term, tvals = term.reshape(B, L), tvals.reshape(B, L)
            # Unmaterialized links hold -1 and duplicates were demoted, so
            # adding idx + 1 at each claimed (parent, slot) sets the link; the
            # others add 0.
            idxs = torch.arange(idx0, idx0 + L, device=dev, dtype=torch.int32)
            tree.child_node.view(B, -1).scatter_add_(
                1, parent * K + slot, torch.where(make_new, idxs[None, :] + 1, 0).to(torch.int32)
            )

            # Terminal flags come from the stepped child (fresh or duplicate
            # leaves) or the stored node (at_node_leaf), not from the buffers
            # just written: a duplicate's slot was never written.
            stop = stop_node.reshape(-1)
            leaf_terminal = torch.where(at_node_leaf, tree.terminal[rows, stop].reshape(B, L), term)
            leaf_tv = torch.where(at_node_leaf, tree.terminal_value[rows, stop].reshape(B, L),
                                  tvals)

            anl = at_node_leaf.reshape(-1)
            leaf_state = child.replace(
                board=torch.where(anl[:, None, None], parent_state.board, child.board),
                side_to_play=torch.where(anl, parent_state.side_to_play, child.side_to_play),
                reps=torch.where(anl[:, None], parent_state.reps, child.reps),
            )
        with span("mcts/evaluate"):
            logits, value = self.evaluate(self.env.observe(leaf_state))
        with span("mcts/expand"):
            priors, fell_back = _masked_priors_fb(logits.float(), info.legal_mask)
            top_p, top_a = _top_k(priors, K)
            has_mass = top_p > 0
            expand = make_new & ~term
            write(tree.expanded, torch.ones_like(anl), expand)
            write(tree.child_action, torch.where(has_mass, top_a, -1).to(torch.int32), expand)
            write(tree.child_prior, torch.where(has_mass, top_p, 0.0), expand)

        # One negamax backup over all L paths (src/mcts.py:125-136): path
        # position j receives v * (-1)^(depth - j); off-path entries add 0 at
        # slot (0, 0). Two leaves of a wave share at least the root edge
        # unless virtual loss diverts them, and the JAX search adds W + (a +
        # b + ...) with the wave's contributions summed in leaf order;
        # scattering the paths straight into child_W would make it (W + a) +
        # b. So sum the wave in a zeroed buffer, leaf by leaf (no edge
        # repeats within one path), and add once.
        with span("mcts/backup"):
            v = torch.where(leaf_terminal, leaf_tv, value.float().reshape(B, L))
            j = torch.arange(D, device=dev)[None, None, :]
            on_path = j < depth[:, :, None]  # [B, L, D]
            sign_v = torch.where(
                (depth[:, :, None] - j) % 2 == 1, -v[:, :, None], v[:, :, None]
            ) * on_path
            flat = path_nodes.clamp(min=0) * K + path_slots.clamp(min=0)
            child_W = tree.child_W.view(B, -1)
            w_add = child_W if L == 1 else torch.zeros_like(child_W)
            for l in range(L):
                w_add.scatter_add_(1, flat[:, l], sign_v[:, l])
            if L > 1:
                child_W += w_add
            tree.child_N.view(B, -1).scatter_add_(
                1, flat.reshape(B, -1), on_path.reshape(B, -1).to(torch.int32)
            )
            consumed = expand  # priors are consumed only at fresh expansions
            fb = (fell_back.reshape(B, L) & consumed).sum(1, dtype=torch.int32)
            ex = consumed.sum(1, dtype=torch.int32)
        return fb, ex

    # -------------------- gumbel root --------------------

    def _root_completed_q(self, tree: Tree, root_nn_value: torch.Tensor):
        """Per root slot: completed Q (root mover's perspective; unvisited
        slots take the root net value) and visit count."""
        N = tree.child_N[:, 0]
        q = torch.where(N > 0, tree.child_W[:, 0] / N.clamp(min=1), root_nn_value[:, None])
        return q, N

    def _gumbel_sigma(self, q: torch.Tensor, N: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        max_n = N.max(-1, keepdim=True).values.to(torch.float32)
        return (cfg.gumbel_cvisit + max_n) * cfg.gumbel_cscale * q

    def _gumbel_score(self, tree: Tree, aux):
        """``g + logits + sigma(completed Q)`` per root slot, and (q, N)."""
        q, N = self._root_completed_q(tree, aux["root_nn_value"])
        score = torch.where(
            aux["slot_valid"], aux["gumbel"] + aux["slot_logits"] + self._gumbel_sigma(q, N), NEG_INF
        )
        return score, q, N

    def _forced_root_slot(self, tree: Tree, aux, m_considered: int) -> torch.Tensor:
        """Sequential halving: the least-visited root slot among the
        ``m_considered`` best by score, the score breaking ties (it spans
        far less than 1e5, so the keys cannot collide)."""
        score, _, N = self._gumbel_score(tree, aux)
        kth = score.topk(min(m_considered, score.shape[1]), dim=-1).values[:, -1:]
        pick = torch.where(score >= kth, -N.to(torch.float32) * 1e5 + score, NEG_INF)
        return pick.argmax(-1)

    def _schedule(self) -> list:
        cfg = self.config
        m0 = max(2, min(cfg.gumbel_considered, cfg.max_children))
        return _sh_considered_schedule(cfg.num_simulations, m0)

    # -------------------- public API --------------------

    @torch.inference_mode()
    def search(
        self,
        root_state: EnvState,
        root_legal: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        add_noise: bool = True,
    ) -> SearchResult:
        """Run ``num_simulations`` simulations from a batch of roots.

        ``root_legal``: ``bool[B, A]``. ``generator`` draws the root noise:
        Dirichlet under PUCT (when ``add_noise`` and ``dirichlet_eps > 0``),
        the Gumbels under Gumbel (when ``add_noise``).
        """
        with span("mcts/search"):
            cfg = self.config
            use_gumbel = cfg.root_selection == "gumbel"
            if generator is None and add_noise and (use_gumbel or cfg.dirichlet_eps > 0):
                raise ValueError("root noise needs a generator")
            logits, root_nn_value = self.evaluate(self.env.observe(root_state))
            priors, root_fb = _masked_priors_fb(logits.float(), root_legal)
            if not use_gumbel and add_noise and cfg.dirichlet_eps > 0:
                n_legal = root_legal.sum(-1, keepdim=True).clamp(min=1).to(torch.float32)
                if cfg.dirichlet_alpha_scale is not None:
                    alpha_b = cfg.dirichlet_alpha_scale / n_legal
                else:
                    alpha_b = torch.full_like(n_legal, cfg.dirichlet_alpha)
                # Masked-out actions get a tiny alpha, as the JAX search does.
                alpha = torch.where(root_legal, alpha_b, 1e-3)
                noise = _dirichlet(alpha, generator) * root_legal
                noise = noise / noise.sum(-1, keepdim=True).clamp(min=1e-30)
                priors = (1 - cfg.dirichlet_eps) * priors + cfg.dirichlet_eps * noise
                priors = priors * root_legal

            tree = self._empty_tree(root_state, priors)
            aux = None
            if use_gumbel:
                slot_valid = tree.child_action[:, 0] >= 0
                slot_logits = torch.where(
                    slot_valid, torch.log(tree.child_prior[:, 0].clamp(min=1e-30)), NEG_INF
                )
                aux = dict(
                    root_nn_value=root_nn_value.float(),
                    slot_valid=slot_valid,
                    slot_logits=slot_logits,
                    gumbel=(
                        _gumbel(slot_logits.shape, generator, slot_logits.device)
                        if add_noise
                        else torch.zeros_like(slot_logits)
                    ),
                )
                schedule = self._schedule()
            fb_count = root_fb.to(torch.int32)
            ex_count = torch.ones_like(fb_count)
            for sim in range(0, cfg.num_simulations, cfg.leaves_per_wave):
                forced = self._forced_root_slot(tree, aux, schedule[sim]) if use_gumbel else None
                with span("mcts/wave"):
                    fb, ex = self._wave(tree, sim, forced)
                fb_count += fb
                ex_count += ex
            return self._finalize(tree, root_legal, fb_count, ex_count, aux)

    def _finalize(self, tree, root_legal, fb_count, ex_count, aux=None) -> SearchResult:
        """Policy, value and move at the root: the visit-count policy and
        mean value (``src/mcts.py:40-41``), or under Gumbel the improved
        policy and the halving winner with its completed Q."""
        B, A = root_legal.shape
        root_counts = tree.child_N[:, 0].to(torch.float32)
        root_actions = tree.child_action[:, 0]
        valid = root_actions >= 0
        slot_action = root_actions.clamp(min=0).long()

        def to_actions(slot_weight):
            probs = torch.zeros((B, A), dtype=torch.float32, device=root_legal.device)
            probs.scatter_add_(1, slot_action, torch.where(valid, slot_weight, 0.0))
            return probs / probs.sum(-1, keepdim=True).clamp(min=1e-30)

        root_visits = tree.child_N[:, 0].sum(-1).to(torch.int32)
        if aux is None:
            probs = to_actions(root_counts)
            best_action = probs.argmax(-1)
            # Summed slot by slot in index order, as XLA reduces it, so that
            # the value equals the JAX search's bit for bit.
            w = torch.where(valid, tree.child_W[:, 0], 0.0)
            root_W = torch.zeros_like(w[:, 0])
            for k in range(w.shape[1]):
                root_W = root_W + w[:, k]
            root_value = root_W / root_visits.to(torch.float32).clamp(min=1.0)
        else:
            # The winner is the best score among the visited candidates; the
            # improved policy is softmax(logits + sigma(completed Q)) over the
            # root slots. The root value is the winner's completed Q, not the
            # visit mean: halving spends early visits on candidates it then
            # refutes, which biases the mean low.
            score, q, N = self._gumbel_score(tree, aux)
            slot_valid = aux["slot_valid"]
            visited_any = (N > 0).any(-1, keepdim=True)
            win_score = torch.where(visited_any, torch.where(N > 0, score, NEG_INF), score)
            win_slot = win_score.argmax(-1, keepdim=True)
            best_action = slot_action.gather(1, win_slot)[:, 0]
            sigma = self._gumbel_sigma(q, N)
            imp = torch.softmax(
                torch.where(slot_valid, aux["slot_logits"] + sigma, NEG_INF), dim=-1
            ) * slot_valid
            probs = to_actions(imp)
            root_value = q.gather(1, win_slot)[:, 0]
        return SearchResult(
            action_probs=probs,
            root_value=root_value,
            root_visits=root_visits,
            best_action=best_action.to(torch.int32),
            prior_fallback_rate=fb_count.to(torch.float32) / ex_count.clamp(min=1).to(torch.float32),
            tree=tree,
        )


def select_actions(
    probs: torch.Tensor,
    legal: torch.Tensor,
    temperature: torch.Tensor,
    generator: torch.Generator,
) -> torch.Tensor:
    """Sample actions from the visit-count policy with temperature.

    ``temperature == 0``: argmax with a uniform random tie-break
    (``src/mcts.py:43-48``); otherwise sample from ``probs ** (1 / temp)``
    renormalized (``src/mcts.py:50-53``), by the Gumbel-max trick.
    """
    B, A = probs.shape
    dev = probs.device
    is_max = (probs >= probs.max(-1, keepdim=True).values) & legal
    tie = torch.rand((B, A), generator=generator, device=dev)
    greedy = (is_max * (1.0 + tie)).argmax(-1)
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=dev).expand(B)
    t = temperature.clamp(min=1e-6)[:, None]
    logits = torch.where(probs > 0, torch.log(probs.clamp(min=1e-30)) / t, NEG_INF)
    u = torch.rand((B, A), generator=generator, device=dev).clamp(min=torch.finfo(torch.float32).tiny)
    sampled = (logits - torch.log(-torch.log(u))).argmax(-1)
    return torch.where(temperature <= 0, greedy, sampled).to(torch.int32)
