"""The squeeze-excitation net's cell: its kind runs a cut cell end to end on
the CPU and comes out correct (the fp8 control does not), the reference
net is the program's in float32, the frozen FLOPs count, and the readers of
its two per-layer metrics on a made-up trace; on the card, a short run of
``selfplay.se20x256`` through the command."""

import copy
import json
import math
import subprocess
import sys

import harness
import numpy as np
import pytest
import se_arith
import torch

from reference import game as G
from reference import se_net as S

SEED = 2**31 + 2222
CELL = "selfplay.se20x256"


def tiny_se_cell(channels=32, blocks=1, batch=16, sims=8, children=8):
    """The SE cell with its net, batch, search and checks cut down."""
    ctx = harness.load_cell(CELL)
    cfg = copy.deepcopy(ctx["config"])
    cfg.update(channels=channels, blocks=blocks, selfplay_batch=batch, replay_capacity=4096,
               sims=sims, children=children)
    traffic = dict(ctx["traffic"])
    traffic.update(check_rows=batch // 2, tree_rows=2, start_ply_max=40, trace_seconds=0.1)
    ctx["config"], ctx["traffic"] = cfg, traffic
    return ctx


def test_the_cell_loads_its_own_kind():
    ctx = harness.load_cell(CELL)
    assert ctx["runner"].__name__ == "kinds.selfplay_se"
    assert ctx["config"]["norm"] == "batch" and ctx["config"]["se_ratio"] == 8
    assert {m["name"] for m in ctx["per_layer"]} >= {"se_block_roofline.selfplay",
                                                      "forward_issue_ms.selfplay"}


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_a_cut_run_is_correct(trace):
    import run

    r = run.measure(tiny_se_cell(), SEED, 0.0, trace, "cpu", 0.0)
    out = r["out"]
    assert r["correct"], (out["checks"], out["check_extra"]["notes"])
    assert out["check_extra"]["roots_checked"] >= 2
    assert out["run"]["flops_per_eval"] == se_arith.net_flops_per_eval(11, 6, 32, 1, 128, 8)
    if trace:
        # The net's span is in the trace; no card, so no kernel to read.
        assert r["metrics"]["forward_issue_ms.selfplay"]["value"] > 0
        assert "se_block_roofline.selfplay" not in r["metrics"]
        assert out["run"]["trace"]["kernel_launches"] == {"se_block": 0}
    else:
        assert {"selfplay_positions_per_device_s", "setup_s"} <= set(r["metrics"])


def test_the_control_fails_at_the_cells_width():
    """The fp8 control in the program's place comes out not correct under
    the cell's comparison, on a number that the program at the same widths
    holds (the cell's 20 blocks of 256 channels cut to 4 of 64)."""
    import run

    ctx = tiny_se_cell(channels=64, blocks=4)
    program = run.measure(ctx, SEED, 0.0, False, "cpu", 0.0)
    control = run.measure(ctx, SEED, 0.0, False, "cpu", 0.0, control=True)
    assert program["correct"], program["out"]["checks"]
    assert not control["correct"], control["out"]["checks"]
    failed = [k for k, c in control["out"]["checks"].items() if c["value"] > c["limit"]]
    assert set(failed) <= {"logit_gap", "prior_gap", "value_gap_ratio", "backup_gap_ratio"}


def test_the_reference_net_is_the_programs_in_float32():
    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.models.network import make_network

    env = make_env("copenhagen", "cpu")
    w = S.make_weights(S.param_shapes(11, 32, 2, 128, 8), 5, "cpu")
    net = make_network(11, channels=32, blocks=2, norm="batch", se_ratio=8,
                       dtype=torch.float32)
    missing, unexpected = net.load_state_dict(w, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    net.eval()
    R = G.Rules("copenhagen")
    rng = np.random.default_rng(0)
    s, states = R.opening(), []
    for _ in range(30):
        states.append(s)
        s = R.play(s, int(rng.choice(R.legal(s))))
    boards = np.stack([s.board for s in states])
    sides = np.array([int(s.side_to_play) for s in states])
    reps = np.array([G.mover_reps(s) for s in states])
    st = env.reset_batch(len(states)).replace(
        board=torch.as_tensor(boards), side_to_play=torch.as_tensor(sides, dtype=torch.int32),
        reps=torch.as_tensor(np.stack([[s.repetitions.attacker_reps, s.repetitions.defender_reps]
                                       for s in states]), dtype=torch.int32))
    with torch.no_grad():
        lo, va = net(env.observe(st))
    rlo, rva = S.evaluate(w, 2, boards, sides, reps)
    assert np.abs(lo.double().numpy() - rlo).max() < 1e-4
    assert np.abs(va.double().numpy() - rva).max() < 1e-5


def test_flops_of_the_se_evaluation():
    # 40 trunk convs and the policy 3x3 at 142,737,408 each, the SE units
    # 983,040 in all, the stem, the 1x1 convs and the dense layers 6,567,168.
    assert se_arith.net_flops_per_eval(11, 6, 256, 20, 128, 8) == 5_859_783_936.0


def test_se_block_bytes():
    # 185,856 a row (y and the skip read, out written, bf16 at 256 x 121);
    # 104,576 a launch (the norm's 4 x 256 and the SE unit's 100,480).
    assert se_arith.se_block_bytes(1, 0, 11, 256, 8) == 185_856
    assert se_arith.se_block_bytes(0, 1, 11, 256, 8) == 104_576
    assert se_arith.se_block_bytes(1024, 20, 11, 256, 8) == 1024 * 185_856 + 20 * 104_576


def _run(host=(), device=(), rows=0, launches=0):
    return {"n": 11, "peak": harness.peaks("NVIDIA H100 80GB HBM3"),
            "config": {"net": {"channels": 256, "se_ratio": 8}},
            "trace": {"window": (0.0, 1000.0), "host": list(host), "device": list(device),
                      "kernel_rows": {"step": 0, "mask": 0, "se_block": rows},
                      "kernel_launches": {"se_block": launches}}}


def test_the_roofline_reader():
    device = [("void (anonymous namespace)::tafl_se_block_kernel<8>(...)", "kernel", 0.0, 30.0),
              ("void (anonymous namespace)::tafl_se_block_kernel<8>(...)", "kernel", 40.0, 70.0),
              ("void (anonymous namespace)::tafl_bn_relu_kernel<8>(...)", "kernel", 70.0, 90.0),
              ("conv_fprop", "kernel", 90.0, 300.0)]
    got = harness.metric_reader("se_block_roofline.selfplay")(
        _run(device=device, rows=2048, launches=2))
    want = 100 * (2048 * 185_856 + 2 * 104_576) / 3.35e12 / 60e-6
    assert got == pytest.approx(want)
    assert harness.metric_reader("se_block_roofline.selfplay")(_run(device=device)) is None
    assert harness.metric_reader("se_block_roofline.selfplay")({"trace": None, "peak": None}) is None


def test_the_forward_issue_reader():
    host = [("bench/traced", 0.0, 1000.0), ("net/forward", 10.0, 30.0),
            ("net/forward", 100.0, 140.0), ("net/forward", 990.0, 1010.0)]
    got = harness.metric_reader("forward_issue_ms.selfplay")(_run(host=host))
    assert got == pytest.approx((20.0 + 40.0) / 2 / 1e3)
    assert harness.metric_reader("forward_issue_ms.selfplay")(_run(host=host[:1])) is None
    assert harness.metric_reader("forward_issue_ms.selfplay")({"trace": None}) is None


@pytest.mark.card
def test_a_short_run_of_the_se_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed", str(2**31 + 98),
         "--seconds", "2", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    metrics = line["metrics"]
    assert 0 < metrics["se_block_roofline.selfplay"]["value"] <= 100
    assert metrics["forward_issue_ms.selfplay"]["value"] > 0
    assert math.isfinite(metrics["mfu.selfplay"]["value"])
