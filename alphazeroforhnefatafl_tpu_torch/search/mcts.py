"""Batched array-tree MCTS in PyTorch.

The counterpart of ``alphazeroforhnefatafl_tpu/search/mcts.py`` for
``root_selection="puct"`` with ``leaves_per_wave=1``: the exact serial PUCT
search. A batch of B trees advances in lockstep, one leaf per tree per
simulation wave, with one env step and one network forward over all B
leaves per wave.

Semantics kept from the reference (``src/mcts.py``): PUCT
``u = Q + cpuct * P * sqrt(Ns + EPS) / (1 + Nsa)`` with ``Q = 0`` on unvisited
edges; legal-masked, renormalized priors with a uniform fallback; negamax
values backed up as running sums; visit-count action probabilities. Each
node keeps its ``max_children`` highest-prior actions (ties in index order,
as ``lax.top_k``), and the tree is a tree, not a transposition table.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..core.env import EnvState, TaflEnv

EPS = 1e-8  # src/mcts.py:6
NEG_INF = -1e30


@dataclass(frozen=True)
class MCTSConfig:
    """The fields and defaults of the JAX ``MCTSConfig``.

    The port runs ``root_selection="puct"`` with ``leaves_per_wave=1`` and
    exact top-k; the search raises on other values of those fields. The
    TPU layout knobs (``topk_recall``, ``traverse_unroll``, ``backup``,
    ``node_read``) have one form here and are accepted for compatibility.
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
    action_probs: torch.Tensor  # f32[B, A] visit-count policy
    root_value: torch.Tensor  # f32[B] mean root value (mover perspective)
    root_visits: torch.Tensor  # i32[B]
    best_action: torch.Tensor  # i32[B]
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


class MCTS:
    """Batched MCTS bound to an env and an evaluation function.

    ``evaluate(obs f32[B, N, N, C]) -> (logits f32[B, A], value f32[B])``.
    """

    def __init__(self, env: TaflEnv, evaluate: Callable, config: MCTSConfig, device=None):
        if config.root_selection != "puct":
            raise NotImplementedError("the port searches with root_selection='puct' only")
        if config.leaves_per_wave != 1:
            raise NotImplementedError("the port searches with leaves_per_wave=1 only")
        if config.topk not in ("auto", "exact"):
            raise NotImplementedError("the port's top-k is exact")
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

    def _select_slot(self, tree: Tree, rows: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
        """PUCT argmax over each game's node's edge slots (``src/mcts.py:109-121``)."""
        N = tree.child_N[rows, node]
        W = tree.child_W[rows, node]
        P = tree.child_prior[rows, node]
        Ns = N.sum(-1).to(torch.float32)  # Ns == sum of edge visits
        Q = torch.where(N > 0, W / N.clamp(min=1), 0.0)
        u = Q + self.config.cpuct * P * torch.sqrt(Ns + EPS)[:, None] / (1.0 + N)
        u = torch.where(tree.child_action[rows, node] >= 0, u, NEG_INF)
        return u.argmax(-1)

    def _traverse(self, tree: Tree):
        """Walk every tree from its root to a leaf edge (no env step).

        Returns a dict: ``node`` (where the walk stopped), ``depth``, the
        recorded ``path_nodes``/``path_slots`` ``[B, D]``, ``leaf_parent``/
        ``leaf_slot`` of the unmaterialized edge reached, and
        ``at_node_leaf``: the walk stopped at an unexpanded, terminal or
        depth-capped node instead.
        """
        B = tree.expanded.shape[0]
        D = self.config.max_depth
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
        for _ in range(D):
            is_leaf = ~tree.expanded[rows, node] | tree.terminal[rows, node]
            slot = self._select_slot(tree, rows, node)
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
            if bool(done.all()):
                break
        return dict(
            node=node, depth=depth, path_nodes=path_nodes, path_slots=path_slots,
            leaf_parent=leaf_parent, leaf_slot=leaf_slot, at_node_leaf=at_node_leaf,
        )

    def _write_slot(self, buf: torch.Tensor, idx: int, val: torch.Tensor, mask: torch.Tensor):
        """``buf[:, idx] = val`` where ``mask``, per game."""
        cur = buf[:, idx]
        buf[:, idx] = torch.where(mask.reshape(mask.shape + (1,) * (val.dim() - 1)), val, cur)

    def _wave(self, tree: Tree, new_idx: int):
        """One simulation wave; returns (fell_back, consumed) ``bool[B]``."""
        cfg = self.config
        B = tree.expanded.shape[0]
        K = cfg.max_children
        rows = torch.arange(B, device=tree.expanded.device)
        t = self._traverse(tree)
        at_node_leaf = t["at_node_leaf"]
        make_new = ~at_node_leaf

        # The leaf edge's parent state (or the stopped-at node's own state,
        # whose step output is discarded) and the leaf action.
        read_node = torch.where(at_node_leaf, t["node"], t["leaf_parent"])
        parent = tree.state.map(lambda x: x[rows, read_node])
        actions = tree.child_action[rows, t["leaf_parent"], t["leaf_slot"]].clamp(min=0)
        child, info = self.env.step_many(parent, actions)

        # Materialize the stepped children in slot new_idx.
        for f in dataclasses.fields(child):
            self._write_slot(getattr(tree.state, f.name), new_idx, getattr(child, f.name), make_new)
        self._write_slot(tree.terminal, new_idx, child.terminated, make_new)
        self._write_slot(tree.terminal_value, new_idx, terminal_value(child), make_new)
        link = tree.child_node[rows, t["leaf_parent"], t["leaf_slot"]]
        tree.child_node[rows, t["leaf_parent"], t["leaf_slot"]] = torch.where(
            make_new, new_idx, link
        ).to(torch.int32)
        leaf = torch.where(at_node_leaf, t["node"], new_idx)

        # Evaluate the leaves: the fresh child, or the stored node.
        leaf_state = child.replace(
            board=torch.where(make_new[:, None, None], child.board, parent.board),
            side_to_play=torch.where(make_new, child.side_to_play, parent.side_to_play),
            reps=torch.where(make_new[:, None], child.reps, parent.reps),
        )
        logits, value = self.evaluate(self.env.observe(leaf_state))
        priors, fell_back = _masked_priors_fb(logits.float(), info.legal_mask)
        consumed = make_new & ~child.terminated

        # Expand fresh non-terminal leaves with their top-K priors.
        leaf_terminal = tree.terminal[rows, leaf]
        leaf_tv = tree.terminal_value[rows, leaf]
        expand = make_new & ~leaf_terminal
        top_p, top_a = _top_k(priors, K)
        has_mass = top_p > 0
        self._write_slot(tree.expanded, new_idx, torch.ones_like(expand), expand)
        self._write_slot(tree.child_action, new_idx,
                         torch.where(has_mass, top_a, -1).to(torch.int32), expand)
        self._write_slot(tree.child_prior, new_idx, torch.where(has_mass, top_p, 0.0), expand)

        # Negamax backup (src/mcts.py:125-136): path position j receives
        # v * (-1)^(depth - j). Off-path entries add 0 at slot (0, 0).
        v = torch.where(leaf_terminal, leaf_tv, value.float())
        depth = t["depth"]
        j = torch.arange(cfg.max_depth, device=v.device)[None, :]
        on_path = j < depth[:, None]
        sign_v = torch.where((depth[:, None] - j) % 2 == 1, -v[:, None], v[:, None]) * on_path
        flat = t["path_nodes"].clamp(min=0) * K + t["path_slots"].clamp(min=0)
        tree.child_W.view(B, -1).scatter_add_(1, flat, sign_v)
        tree.child_N.view(B, -1).scatter_add_(1, flat, on_path.to(torch.int32))
        return fell_back, consumed

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

        ``root_legal``: ``bool[B, A]``. ``generator`` draws the Dirichlet
        root noise (needed when ``add_noise`` and ``dirichlet_eps > 0``).
        """
        cfg = self.config
        logits, _ = self.evaluate(self.env.observe(root_state))
        priors, root_fb = _masked_priors_fb(logits.float(), root_legal)
        if add_noise and cfg.dirichlet_eps > 0:
            if generator is None:
                raise ValueError("root noise needs a generator")
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
        fb_count = root_fb.to(torch.int32)
        ex_count = torch.ones_like(fb_count)
        for wave in range(cfg.num_simulations):
            fell_back, consumed = self._wave(tree, wave + 1)
            fb_count += (fell_back & consumed).to(torch.int32)
            ex_count += consumed.to(torch.int32)
        return self._finalize(tree, root_legal, fb_count, ex_count)

    def _finalize(self, tree, root_legal, fb_count, ex_count) -> SearchResult:
        """Visit-count policy and mean value at the root (``src/mcts.py:40-41``)."""
        B, A = root_legal.shape
        root_counts = tree.child_N[:, 0].to(torch.float32)
        root_actions = tree.child_action[:, 0]
        valid = root_actions >= 0
        probs = torch.zeros((B, A), dtype=torch.float32, device=root_legal.device)
        probs.scatter_add_(1, root_actions.clamp(min=0).long(), torch.where(valid, root_counts, 0.0))
        probs = probs / probs.sum(-1, keepdim=True).clamp(min=1e-30)
        root_visits = tree.child_N[:, 0].sum(-1).to(torch.int32)
        # Summed slot by slot in index order, as XLA reduces it, so that the
        # value equals the JAX search's bit for bit.
        w = torch.where(valid, tree.child_W[:, 0], 0.0)
        root_W = torch.zeros_like(w[:, 0])
        for k in range(w.shape[1]):
            root_W = root_W + w[:, k]
        root_value = root_W / root_visits.to(torch.float32).clamp(min=1.0)
        return SearchResult(
            action_probs=probs,
            root_value=root_value,
            root_visits=root_visits,
            best_action=probs.argmax(-1).to(torch.int32),
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
