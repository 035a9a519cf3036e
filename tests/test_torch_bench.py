"""The port's bench and profiling helpers against the JAX package's.

``net_flops_per_eval`` is the same count; the rollout, fed the very noise
JAX's rollout draws (its key schedule replayed here), gives the same states,
masks and checksums as the root ``bench.build_rollout`` on the CPU;
``cli bench --cpu`` prints one line with every key, and ``device_trace``
writes a trace that names an ``annotate`` region. Every comparison is
exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from alphazeroforhnefatafl_tpu.core import env as jenv
from alphazeroforhnefatafl_tpu_torch import bench as tbench
from alphazeroforhnefatafl_tpu_torch import cli
from alphazeroforhnefatafl_tpu_torch.core import env as tenv
from alphazeroforhnefatafl_tpu_torch.utils import profiling as tprofiling
from tests.test_env_golden import random_dense_board
from tests.test_torch_env import STATE_FIELDS, assert_same, to_torch
from tests.test_torch_learner import single_thread  # noqa: F401 (autouse fixture)

#: Every key of the JAX bench's accelerator line, and the port's own.
JAX_KEYS = (
    "metric", "value", "unit", "vs_baseline", "mean_value", "timing",
    "env_state_bytes_per_game", "mcts_sims_per_s", "mcts_sims_per_s_mean", "mcts_config",
    "mcts_sims_per_s_800", "mcts_sims_per_s_800_mean", "mcts_config_800",
    "net_flops_per_eval", "mfu_128", "mfu_800", "chip_peak_tflops_bf16",
)
PORT_KEYS = ("card", "power_limit_w", "mcts_sims_per_s_serial", "device")


@pytest.mark.parametrize(
    "n, channels, blocks",
    [(11, 64, 6), (7, 32, 3), (21, 64, 6)],
    ids=["copenhagen-64x6", "brandubh-32x3", "21x21-64x6"],
)
def test_net_flops_per_eval_matches_jax(n, channels, blocks):
    got = tbench.net_flops_per_eval(n, 6, channels, blocks)
    assert got == jbench.net_flops_per_eval(n, 6, channels, blocks)
    assert got == tbench.net_flops_per_eval(n, 6, channels, blocks, value_hidden=128)


_JAX_ROLLOUT = {}


def jax_rollout(env, batch, chunk):
    """``bench.build_rollout`` on the plain ``vmap(env.step)`` path, built
    (and so compiled) once per test process."""
    key = (env, batch, chunk)
    if key not in _JAX_ROLLOUT:
        _JAX_ROLLOUT[key] = (
            jbench.build_rollout(env, batch, chunk, use_kernel=False),
            jax.jit(jax.vmap(env.legal_mask)),
        )
    return _JAX_ROLLOUT[key]


@pytest.mark.parametrize("start", ["opening", "dense"])
def test_rollout_matches_the_jax_rollout(start):
    """Copenhagen, 8 games, two rollouts of 6 steps. From the opening no
    game ends so soon; from dense random boards some do, so the auto-reset
    of the state and of the mask is compared too."""
    B, chunk = 8, 6
    jax_env, torch_env = jenv.make_env("copenhagen"), tenv.make_env("copenhagen", "cpu")
    rollout_j, mask_j = jax_rollout(jax_env, B, chunk)
    jstate = jax_env.reset_batch(B)
    if start == "dense":
        rng = np.random.RandomState(1)  # a seed whose games end within 12 plies
        jstate = jstate.replace(
            board=jnp.asarray(np.stack([random_dense_board(rng, jax_env.n) for _ in range(B)])),
            side_to_play=jnp.asarray(rng.randint(0, 2, B), jnp.int32),
        )
    jmask = mask_j(jstate)
    tstate = to_torch(jstate)
    tmask = torch_env.legal_mask_many(tstate)
    assert np.array_equal(np.asarray(jmask), tmask.numpy())

    rollout_t = tbench.make_rollout(torch_env, B, chunk)
    rng = jax.random.PRNGKey(0)
    replay_rng = rng  # the key schedule of build_rollout's policy_step
    finished = 0
    for r in range(2):
        noise = []
        for _ in range(chunk):
            replay_rng, k = jax.random.split(replay_rng)
            noise.append(np.asarray(jax.random.uniform(k, (B, torch_env.num_actions), dtype=jnp.float32)))
        jstate, jmask, rng, jsum = rollout_j(jstate, jmask, rng)
        tstate, tmask, tsum = rollout_t(tstate, tmask, noise=torch.from_numpy(np.stack(noise)))
        assert_same(jstate, tstate, STATE_FIELDS, f"{start} rollout {r}")
        assert np.array_equal(np.asarray(jmask), tmask.numpy()), f"{start} rollout {r} mask"
        assert int(jsum) == int(tsum), f"{start} rollout {r} checksum"
        finished += int(tsum) - int(tstate.turn.sum())
    assert (finished > 0) == (start == "dense")


def test_rollout_draws_from_its_generator():
    """Without injected noise the policy's draws come from the generator:
    the same seed gives the same games, another seed others."""
    env = tenv.make_env("brandubh", "cpu")
    rollout = tbench.make_rollout(env, 4, 5)

    def play(seed):
        state = env.reset_batch(4)
        state, mask, checksum = rollout(state, env.legal_mask_many(state),
                                        torch.Generator().manual_seed(seed))
        return state.board, int(checksum)

    (b0, c0), (b1, c1), (b2, _) = play(0), play(0), play(1)
    assert torch.equal(b0, b1) and c0 == c1
    assert not torch.equal(b0, b2)


def test_cli_bench_cpu_prints_one_line_with_every_key(capsys):
    cli.main(["bench", "--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    missing = [k for k in JAX_KEYS + PORT_KEYS if k not in rec]
    assert not missing, missing
    assert rec["metric"] == "env_steps_per_sec_per_chip_11x11" and rec["unit"] == "steps/s"
    assert rec["timing"] == "best_of_2_windows_x2_rollouts_sync_per_window"
    assert rec["value"] > 0 and rec["mean_value"] > 0 and rec["mcts_sims_per_s"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / tbench.TARGET_STEPS_PER_S, 3)
    assert rec["mcts_config"] == "b16_s16_k16"
    assert rec["net_flops_per_eval"] == jbench.net_flops_per_eval(11, 6, 64, 6)
    # The port's EnvState holds the JAX one's fields in the same dtypes.
    jstate = jenv.make_env("copenhagen").reset_batch(1)
    assert rec["env_state_bytes_per_game"] == float(
        sum(x.dtype.itemsize * x.size for x in jax.tree_util.tree_leaves(jstate))
    )
    # A CPU run names no card and fills in no device figure.
    assert rec["device"] == "cpu"
    for k in ("card", "power_limit_w", "mfu_128", "mfu_800", "chip_peak_tflops_bf16",
              "mcts_sims_per_s_800", "mcts_sims_per_s_serial"):
        assert rec[k] is None, k


def test_device_trace_names_an_annotated_region(tmp_path):
    with tprofiling.device_trace(str(tmp_path)):
        with tprofiling.annotate("bench/annotated_region"):
            torch.ones(64).cumsum(0)
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "bench/annotated_region" in names
