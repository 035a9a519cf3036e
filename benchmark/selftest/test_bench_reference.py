"""The plain references against the program at a tiny size on the CPU: a
whole run of a cut self-play cell comes out correct, and the float32
reference net equals the program's net computed in float32."""

import numpy as np
import pytest
import torch

from conftest import CONFIGS, tiny_cell
from reference import game as G
from reference import net as N

SEED = 2**31 + 77


@pytest.mark.parametrize("config", CONFIGS)
def test_a_cut_run_is_correct(config):
    import run

    ctx = tiny_cell(config)
    r = run.measure(ctx, SEED, 0.5, False, "cpu", 0.0)
    out = r["out"]
    assert r["correct"], (out["checks"], out["check_extra"]["notes"])
    assert out["check_extra"]["roots_checked"] >= 2
    assert {"selfplay_positions_per_device_s", "setup_s"} <= set(r["metrics"])


def test_the_traced_run_reads_its_spans():
    import run

    r = run.measure(tiny_cell(), SEED, 0.2, True, "cpu", 0.0)
    assert r["correct"]
    assert r["metrics"]["move_overhead_ms.selfplay"]["value"] > 0
    assert r["metrics"]["search_ms_per_wave.selfplay"]["value"] > 0
    assert r["metrics"]["positions_per_s.selfplay"]["value"] > 0
    # No card: no device events, so nothing to read for the device metrics.
    assert "idle_share.selfplay" not in r["metrics"]


def test_the_window_counts_whole_moves():
    """The window ends with the first move to end after --seconds."""
    import run

    ctx = tiny_cell()
    seconds = 1.0
    r = run.measure(ctx, SEED, seconds, False, "cpu", 0.0)
    spans = r["out"]["run"]["spans"]["move"]
    t0 = spans[0][0]
    assert spans[-1][1] - t0 >= seconds
    assert spans[-2][1] - t0 < seconds
    assert r["out"]["positions"] == len(spans) * ctx["config"]["selfplay_batch"]


def test_the_reference_net_is_the_programs_in_float32():
    from alphazeroforhnefatafl_tpu_torch.core.env import make_env
    from alphazeroforhnefatafl_tpu_torch.models.network import make_network

    env = make_env("copenhagen", "cpu")
    w = N.make_weights(N.param_shapes(11, 16, 2, 32), 5, "cpu")
    net = make_network(11, channels=16, blocks=2, dtype=torch.float32)
    net.value_fc = torch.nn.Linear(8 * 121, 32)
    net.value_out = torch.nn.Linear(32, 1)
    net.load_state_dict(w, strict=True)
    R = G.Rules("copenhagen")
    rng = np.random.default_rng(0)
    S, states = R.opening(), []
    for _ in range(30):
        states.append(S)
        legal = R.legal(S)
        S = R.play(S, int(rng.choice(legal)))
    boards = np.stack([s.board for s in states])
    sides = np.array([int(s.side_to_play) for s in states])
    reps = np.array([G.mover_reps(s) for s in states])
    st = env.reset_batch(len(states)).replace(
        board=torch.as_tensor(boards), side_to_play=torch.as_tensor(sides, dtype=torch.int32),
        reps=torch.as_tensor(np.stack([[s.repetitions.attacker_reps, s.repetitions.defender_reps]
                                       for s in states]), dtype=torch.int32))
    with torch.no_grad():
        lo, va = net(env.observe(st))
    rlo, rva = N.evaluate(w, 2, boards, sides, reps)
    assert np.abs(lo.double().numpy() - rlo).max() < 1e-4
    assert np.abs(va.double().numpy() - rva).max() < 1e-5


def test_the_rules_reference_legal_moves_are_the_programs_kernel_1():
    from alphazeroforhnefatafl_tpu_torch.core.env import make_env

    env = make_env("copenhagen", "cpu")
    R = G.Rules("copenhagen")
    rng = np.random.default_rng(1)
    S = R.opening()
    for ply in range(60):
        st = env.reset_batch(1).replace(
            board=torch.as_tensor(S.board[None]),
            side_to_play=torch.tensor([int(S.side_to_play)], dtype=torch.int32))
        assert np.array_equal(env.legal_mask_many(st)[0].numpy(), R.legal_mask(S)), ply
        S = R.play(S, int(rng.choice(R.legal(S))))
        if not S.ongoing:
            S = R.opening()


@pytest.mark.parametrize("config", CONFIGS)
def test_the_control_fails_at_the_cells_widths(config):
    """The fp8 control, as the search's evaluate in the program's place,
    comes out not correct under the cell's own comparison, on a number
    that the program at the same widths holds."""
    import run

    ctx = tiny_cell(config, blocks=6)
    program = run.measure(ctx, SEED, 0.0, False, "cpu", 0.0)
    control = run.measure(ctx, SEED, 0.0, False, "cpu", 0.0, control=True)
    assert program["correct"], program["out"]["checks"]
    assert not control["correct"], control["out"]["checks"]
    failed = [k for k, c in control["out"]["checks"].items() if c["value"] > c["limit"]]
    assert set(failed) <= {"logit_gap", "prior_gap", "value_gap_ratio", "backup_gap_ratio"}
