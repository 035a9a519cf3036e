"""Self-play at steady state with the squeeze-excitation residual net: the
window, the traffic and the check of ``kinds/selfplay.py``, with this
configuration's net, reference and FLOPs count.

The program's net is ``make_network(..., norm="batch", se_ratio=r)`` in
inference mode, loaded with the weights and running statistics of
``reference/se_net.py``'s ``make_weights``; the check
(``reference/selfplay_check.py``) evaluates ``reference/se_net.py``, and
the control runs it with an fp8 trunk. The FLOPs of an evaluation are
``se_arith.net_flops_per_eval``. The traced moves also count the SE
kernel's rows and launches (``se_block.batches``), for
``se_block_roofline``.

``kinds/selfplay.py`` and ``reference/selfplay_check.py`` are loaded here
as private copies whose module names are rebound to this net, so a process
that also runs the GroupNorm cells' kind keeps theirs.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

import harness
import se_arith
from reference import se_net

BENCH = Path(__file__).resolve().parent.parent


def _copy(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


check = _copy("reference._selfplay_check_se", BENCH / "reference" / "selfplay_check.py")
check.N = se_net
base = _copy("kinds._selfplay_se_base", BENCH / "kinds" / "selfplay.py")
base.ref_net = se_net
base.selfplay_check = check


def derive(record: dict) -> dict:
    """``kinds/selfplay.py``'s sizes, and the SE unit's ratio."""
    cfg = _derive(record)
    cfg["net"]["se_ratio"] = record["se_ratio"]
    return cfg


def build(cfg: dict, seed: int, device, control: bool = False):
    """The program under test with the benchmark's weights and running
    statistics, in inference mode; with ``control`` the search evaluates
    with the reference net with an fp8 trunk in its place."""
    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.models.network import make_network
    from alphazeroforhnefatafl_tpu_torch.train.selfplay import SelfPlayActor, SelfPlayConfig

    net_cfg, sp = cfg["net"], cfg["selfplay"]
    env = make_env(cfg["preset"], device)
    shapes = se_net.param_shapes(env.n, net_cfg["channels"], net_cfg["blocks"],
                                 net_cfg["value_hidden"], net_cfg["se_ratio"])
    weights = se_net.make_weights(shapes, harness.sub_seed(seed, "weights"), device)
    net = make_network(env.n, channels=net_cfg["channels"], blocks=net_cfg["blocks"],
                       norm=net_cfg["norm"], se_ratio=net_cfg["se_ratio"],
                       dtype=getattr(torch, net_cfg["trunk_dtype"]))
    missing, unexpected = net.load_state_dict(weights, strict=False)
    # The norms' counts of batches seen are the program's own; every other
    # tensor comes from the reference's weights.
    if unexpected or any(not k.endswith(".num_batches_tracked") for k in missing):
        raise RuntimeError(f"the net's state and the reference's differ: missing {missing}, "
                           f"unexpected {unexpected}")
    net = net.to(device).eval()
    evaluator = base.Evaluator(base.fp8_reference(weights, net_cfg["blocks"]) if control
                               else net)
    spcfg = SelfPlayConfig(batch_size=sp["batch_size"], temp_threshold=sp["temp_threshold"],
                           max_game_len=sp["max_game_len"], policy_k=sp["policy_k"])
    actor = SelfPlayActor(env, evaluator, base.mcts_config(cfg), spcfg, device)
    return env, weights, evaluator, actor, spcfg


def traced_moves(win, traffic, device, step_arrays, batched_legal_mask) -> dict:
    """``kinds/selfplay.py``'s traced moves, with the SE kernel's rows and
    launches over them."""
    from alphazeroforhnefatafl_tpu_torch.ops.se_block import se_block as se

    launches, batches = se.launches, dict(se.batches)
    out = _traced_moves(win, traffic, device, step_arrays, batched_legal_mask)
    out["kernel_rows"]["se_block"] = sum(b * (c - batches.get(b, 0))
                                         for b, c in se.batches.items())
    out["kernel_launches"] = {"se_block": se.launches - launches}
    return out


_derive, _traced_moves = base.derive, base._traced_moves
base.derive, base.build, base._traced_moves = derive, build, traced_moves


def run(ctx: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        control: bool = False) -> dict:
    """One run of the cell; ``kinds/selfplay.py``'s, with this net's FLOPs."""
    out = base.run(ctx, seed, seconds, trace, device, t_start, control=control)
    r, net = out["run"], out["run"]["config"]["net"]
    r["flops_per_eval"] = se_arith.net_flops_per_eval(
        r["n"], 6, net["channels"], net["blocks"], net["value_hidden"], net["se_ratio"])
    return out
