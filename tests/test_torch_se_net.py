"""The squeeze-excitation residual net (``PolicyValueNet`` with
``norm="batch"``) on the CPU, against its plain float32 reference
(``models/se_reference.py``), on seeded random weights with running
statistics away from 0 and 1.

- The forward in inference mode (running statistics) and in training mode
  (the batch's, the running ones moved towards them), at 2 blocks of 32
  channels (ratio 8) on 7x7 and 11x11: within 1e-4, float32 summed in
  another order.
- The learner's loss and every gradient against the reference's autograd.
- The two modes differ, the loop and the arena evaluate in inference mode,
  the learner steps in training mode, ranks end a step with equal running
  statistics, and a checkpoint keeps them.
- The kernels of ``csrc/se_block.cu`` under the host simulation
  (``csrc/sim/simt_host.h``), at 256 channels on 11x11 among others, within
  1 bf16 ulp of exact math rounded once outside float32's cancellation
  allowance (``ops.se_block.ulps_from_exact``), with a gate that saturates
  and one that does not.
"""

import ctypes
import os
import shutil
import subprocess

import pytest
import torch
import torch.distributed as dist

from alphazeroforhnefatafl_tpu_torch.core.env import make_env
from alphazeroforhnefatafl_tpu_torch.models import network as tnetwork
from alphazeroforhnefatafl_tpu_torch.models import se_reference as ref
from alphazeroforhnefatafl_tpu_torch.models.network import (
    PolicyValueNet, architecture, init_params, make_network,
)
from alphazeroforhnefatafl_tpu_torch.ops import _build
from alphazeroforhnefatafl_tpu_torch.ops import se_block as se_op
from alphazeroforhnefatafl_tpu_torch.parallel import launch
from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTSConfig
from alphazeroforhnefatafl_tpu_torch.train import learner as tlearner
from alphazeroforhnefatafl_tpu_torch.train.arena import play_match
from alphazeroforhnefatafl_tpu_torch.train.checkpoint import CheckpointManager
from alphazeroforhnefatafl_tpu_torch.train.loop import LoopConfig, run_loop
from alphazeroforhnefatafl_tpu_torch.train.selfplay import SelfPlayConfig
from alphazeroforhnefatafl_tpu_torch.utils.metrics import MetricsLogger

C, BLOCKS, RATIO = 32, 2, 8
TOL = dict(atol=1e-4, rtol=1e-4)


def randomize(net: PolicyValueNet, seed: int) -> PolicyValueNet:
    """Random weights with every norm's affine and running statistics away
    from 1 and 0, and nonzero biases, so that each counts."""
    g = torch.Generator().manual_seed(seed)
    init_params(net, g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.6, 1.4, generator=g)
                m.bias.uniform_(-0.3, 0.3, generator=g)
                m.running_mean.uniform_(-0.3, 0.3, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
            elif isinstance(m, torch.nn.Linear):
                m.bias.uniform_(-0.2, 0.2, generator=g)
    return net


def se_net(n=11, seed=0, dtype=torch.float32, channels=C, blocks=BLOCKS):
    net = make_network(n, channels=channels, blocks=blocks, norm="batch", se_ratio=RATIO,
                       dtype=dtype)
    return randomize(net, seed)


def observations(n, B, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(B, n, n, 6, generator=g) < 0.3).float()


def weights(net, grad=False):
    """The net's state as the reference's dict, parameters as leaves."""
    params = dict(net.named_parameters())
    return {k: (v.detach().clone().requires_grad_(grad and k in params))
            for k, v in net.state_dict().items()}


def batch(n, B, seed):
    g = torch.Generator().manual_seed(seed)
    A = n * n * 4 * (n - 1)
    legal = torch.rand(B, A, generator=g) < 0.1
    legal[:, 0] = True
    target = torch.rand(B, A, generator=g) * legal
    return tlearner.Batch(obs=observations(n, B, seed + 1),
                          policy_target=target / target.sum(1, keepdim=True),
                          value_target=torch.rand(B, generator=g) * 2 - 1, legal_mask=legal)


# The net against the reference.


@pytest.mark.parametrize("training", [False, True], ids=["inference", "training"])
@pytest.mark.parametrize("n", [7, 11])
def test_the_net_is_the_reference(n, training):
    net = se_net(n, seed=n).train(training)
    obs = observations(n, 6, seed=n + 1)
    w = weights(net)
    stats = {}
    want = ref.forward(w, obs, BLOCKS, training=training, stats=stats)
    with torch.no_grad():
        got = net(obs)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, **TOL)
    # Training mode moves every running statistic a tenth of the way to
    # the batch's (the variance unbiased); inference mode leaves them.
    for name, module in net.named_modules():
        if isinstance(module, torch.nn.BatchNorm2d):
            old_mean, old_var = w[name + ".running_mean"], w[name + ".running_var"]
            if training:
                mean, var = stats[name]
                old_mean, old_var = 0.9 * old_mean + 0.1 * mean, 0.9 * old_var + 0.1 * var
            torch.testing.assert_close(module.running_mean, old_mean, **TOL)
            torch.testing.assert_close(module.running_var, old_var, **TOL)


def test_training_and_inference_modes_differ():
    net = se_net(seed=3)
    obs = observations(11, 4, seed=4)
    with torch.no_grad():
        evaluated = net.eval()(obs)
        trained = net.train()(obs)
    assert (evaluated[0] - trained[0]).abs().max() > 1e-2


def test_the_learner_step_is_the_references():
    """The learner's loss (training mode) and its gradients, against the
    reference's autograd on the same state."""
    net = se_net(seed=5).train()
    b = batch(11, 6, seed=6)
    w = weights(net, grad=True)
    want = ref.loss(w, b.obs, b.policy_target, b.value_target, b.legal_mask, BLOCKS)
    want.backward()
    loss, metrics = tlearner.loss_fn(net, b)
    loss.backward()
    torch.testing.assert_close(loss, want.detach(), **TOL)
    for name, p in net.named_parameters():
        torch.testing.assert_close(p.grad, w[name].grad, atol=1e-5, rtol=1e-4, msg=name)


def test_the_train_step_runs_in_training_mode():
    """The net is built in inference mode; the step trains (the running
    statistics move) and leaves it in inference mode."""
    net = se_net(seed=7)
    assert not net.training
    state = tlearner.TrainState(net, *tlearner.make_optimizer(net.parameters()))
    before = net.blocks[0].bn1.running_var.clone()
    tlearner.make_train_step(state)(batch(11, 4, seed=8))
    assert not net.training
    assert not torch.equal(net.blocks[0].bn1.running_var, before)


# Construction.


@pytest.mark.parametrize("norm, se_ratio, channels", [
    ("batch", 0, 32), ("group", 8, 32), ("none", 4, 32), ("batch", 3, 32), ("bogus", 0, 32),
])
def test_unbuilt_combinations_raise(norm, se_ratio, channels):
    with pytest.raises(ValueError):
        make_network(7, channels=channels, blocks=1, norm=norm, se_ratio=se_ratio)


@pytest.mark.parametrize("norm, se_ratio", [("batch", 8), ("group", 0), ("none", 0)])
def test_every_net_is_built_in_inference_mode(norm, se_ratio):
    net = make_network(7, channels=32, blocks=1, norm=norm, se_ratio=se_ratio)
    assert not any(m.training for m in net.modules())


def test_the_state_dict_names_the_architecture():
    net = make_network(7, channels=32, blocks=2, norm="batch", se_ratio=8)
    keys = list(net.state_dict())
    assert keys[:6] == ["stem.weight", "stem_bn.weight", "stem_bn.bias", "stem_bn.running_mean",
                        "stem_bn.running_var", "stem_bn.num_batches_tracked"]
    assert "blocks.1.se_fc2.weight" in keys and net.blocks[1].se_fc2.weight.shape == (64, 4)
    for cfg in (dict(channels=32, blocks=2, norm="batch", se_ratio=8),
                dict(channels=16, blocks=3, norm="group", se_ratio=0),
                dict(channels=8, blocks=1, norm="none", se_ratio=0)):
        assert architecture(make_network(7, **cfg).state_dict()) == cfg


# The sites' dispatch (models/network.py ``bn_act`` and ``se_act``).

SERVED = dict(device_type="cuda", dtype=torch.bfloat16, channels_last=True, grad=False,
              training=False, channels=256, positions=121)


@pytest.mark.parametrize("change, applies", [
    ({}, True),
    *[({"channels": c}, True) for c in (32, 64, 128)],
    ({"positions": 128}, True),
    ({"positions": 129}, False),
    ({"device_type": "cpu"}, False),
    ({"dtype": torch.float32}, False),
    ({"channels_last": False}, False),
    ({"grad": True}, False),
    ({"training": True}, False),
    ({"channels": 96}, False),
    ({"channels": 512}, False),
])
def test_the_kernels_apply_only_where_served(change, applies):
    assert se_op.se_block_applies(**{**SERVED, **change}) is applies


def test_sites_hand_the_kernels_the_block(monkeypatch):
    """Where the kernels apply, a forward of B blocks makes B SE calls, each
    with the block's input as skip, and B + 2 norm calls (the stem, the
    first norm of each block, the policy head); on the CPU's chain the
    result is the same."""
    calls = {"se": [], "bn": 0}

    def se(y, skip, *args):
        calls["se"].append(skip.shape == y.shape)
        return se_op.se_block_plain(y, skip, *args)

    def bn(y, *args):
        calls["bn"] += 1
        return se_op.bn_relu_plain(y, *args)

    net = se_net(seed=9, dtype=torch.bfloat16, blocks=3).eval()
    obs = observations(11, 3, seed=10)
    with torch.inference_mode():
        want = net(obs)
        monkeypatch.setattr(tnetwork, "se_block_applies", lambda *facts: True)
        monkeypatch.setattr(tnetwork, "se_block", se)
        monkeypatch.setattr(tnetwork, "bn_relu", bn)
        got = net(obs)
    assert calls == {"se": [True] * 3, "bn": 5}
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_a_forward_is_one_span():
    from torch.profiler import ProfilerActivity, profile

    net = se_net(seed=11).eval()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            net(observations(11, 2, seed=12))
            net(observations(11, 2, seed=13))
    spans = [e for e in prof.events() if e.name == "net/forward"]
    assert len(spans) == 2


# The normal path: the loop, the arena, the ranks, checkpoints.


def test_the_loop_and_the_arena_evaluate_in_inference_mode(monkeypatch, tmp_path):
    """Every forward without grad (self-play, the arena, either net) runs in
    inference mode; every forward with grad (the learner's) in training
    mode; the incumbent never trains."""
    seen = []
    forward = PolicyValueNet.forward

    def record(self, obs):
        seen.append((torch.is_grad_enabled(), self.training))
        return forward(self, obs)

    monkeypatch.setattr(PolicyValueNet, "forward", record)
    env = make_env("brandubh", "cpu")
    cfg = LoopConfig(preset="brandubh", iterations=2, games_per_iteration=2,
                     train_steps_per_iteration=2, train_batch_size=8, min_replay_size=8,
                     channels=16, blocks=1, norm="batch", se_ratio=8, arena_games=2,
                     arena_sims=2, arena_max_game_len=4, arena_every=1,
                     checkpoint_dir=str(tmp_path), mcts=MCTSConfig(num_simulations=2),
                     selfplay=SelfPlayConfig(batch_size=2, max_game_len=8))
    with open(os.devnull, "w") as quiet:
        state = run_loop(env, cfg, log=MetricsLogger(stream=quiet))
    assert (False, False) in seen and (True, True) in seen
    assert set(seen) <= {(False, False), (True, True)}
    assert not state.net.training
    # The arena on nets as they are built, and on one a step has trained.
    a, b = se_net(7, seed=1, channels=16, blocks=1), se_net(7, seed=2, channels=16, blocks=1)
    step_b = tlearner.make_train_step(tlearner.TrainState(b, *tlearner.make_optimizer(
        b.parameters())))
    step_b(batch(7, 4, seed=3))
    seen.clear()
    play_match(make_env("brandubh", "cpu"), a, b, MCTSConfig(num_simulations=2),
               num_games=2, max_game_len=2)
    assert seen and set(seen) == {(False, False)}


def test_a_checkpoint_keeps_the_running_statistics(tmp_path):
    env = make_env("brandubh", "cpu")
    net = se_net(env.n, seed=13, channels=16, blocks=1)
    state = tlearner.TrainState(net, *tlearner.make_optimizer(net.parameters()))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state, None, torch.Generator())
    fresh = make_network(env.n, channels=16, blocks=1, norm="batch", se_ratio=8)
    fresh_state = tlearner.TrainState(fresh, *tlearner.make_optimizer(fresh.parameters()))
    mgr.restore(fresh_state, None)
    for k, v in net.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    other = make_network(env.n, channels=16, blocks=1)
    with pytest.raises(ValueError, match="norm=batch se_ratio=8.*norm=group se_ratio=0"):
        mgr.restore(tlearner.TrainState(other, *tlearner.make_optimizer(other.parameters())),
                    None)


def rank_step(rank, work):
    """One float32 train step of the SE net on this rank's half of a global
    batch of 8, over gloo; saves the net's state."""
    torch.set_num_threads(1)
    launch.initialize_distributed(f"file://{work}/store", 2, rank, device="cpu")
    try:
        net = se_net(7, seed=14, channels=16, blocks=1)
        state = tlearner.TrainState(net, *tlearner.make_optimizer(net.parameters()))
        b = batch(7, 8, seed=15)
        rows = launch.local_batch_slice(8)
        half = tlearner.Batch(**{k: getattr(b, k)[rows] for k in vars(b)})
        tlearner.make_train_step(state, dist.group.WORLD)(half)
        torch.save(net.state_dict(), os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_ranks_end_a_step_with_the_mean_running_statistics(tmp_path):
    launch.spawn_ranks(rank_step, (str(tmp_path),), 2, 240.0)
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in (0, 1)]
    for k, v in got[0].items():
        assert torch.equal(v, got[1][k]), k
    # Each rank moved its statistics towards its own half; the step's
    # all-reduce left their mean.
    net = se_net(7, seed=14, channels=16, blocks=1)
    b = batch(7, 8, seed=15)
    moved = []
    for rows in (slice(0, 4), slice(4, 8)):
        stats = {}
        ref.forward(weights(net), b.obs[rows], 1, training=True, stats=stats)
        moved.append(stats["stem_bn"])
    old_mean = net.stem_bn.running_mean
    want = 0.9 * old_mean + 0.1 * (moved[0][0] + moved[1][0]) / 2
    torch.testing.assert_close(got[0]["stem_bn.running_mean"], want, **TOL)


# The kernels under the host simulation.


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' host simulation")
    out = tmp_path_factory.mktemp("sim") / "libtafl_sim.so"
    cmd = [gxx, "-std=c++17", "-O1", "-DTAFL_HOST_SIM", "-shared", "-fPIC",
           "-fsanitize=undefined", "-fno-sanitize-recover=undefined",
           f"-I{_build.CSRC_DIR}", "-x", "c++", str(_build.CSRC_DIR / "se_block.cu"),
           "-o", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tafl_se_block.argtypes = [p, p, p, p, p, p, f, p, p, p, p, i, i, i, i, i, p, p]
    lib.tafl_se_block_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.tafl_bn_relu.argtypes = [p, p, p, p, p, f, i, i, i, p, p]
    return lib


EPS = 1e-5


def se_inputs(seed, R, Cn, n, saturate=False, ratio=RATIO):
    """bf16 channels-last ``y`` and skip ``x``, the norm's vectors and the SE
    unit (``ratio``) as a trained net might hold them; ``saturate`` puts the
    gate's pre-activations at +-30, where the sigmoid is 0 or 1 in float32."""
    g = torch.Generator().manual_seed(seed)

    def nhwc():
        return torch.randn(R, n, n, Cn, generator=g).to(torch.bfloat16).permute(0, 3, 1, 2)

    y, x = nhwc(), nhwc()
    norm = [1 + 0.3 * torch.randn(Cn, generator=g), 0.3 * torch.randn(Cn, generator=g),
            0.3 * torch.randn(Cn, generator=g), torch.exp(0.5 * torch.randn(Cn, generator=g))]
    H = Cn // ratio
    w1, b1 = torch.randn(H, Cn, generator=g) / Cn ** 0.5, 0.1 * torch.randn(H, generator=g)
    w2, b2 = torch.randn(2 * Cn, H, generator=g) / H ** 0.5, 0.1 * torch.randn(2 * Cn, generator=g)
    if saturate:
        b2[:Cn] = 30.0 * torch.sign(torch.randn(Cn, generator=g))
    return y, x, norm, [w1, b1, w2, b2]


def sim_out(shape):
    R, Cn, H, W = shape
    return torch.full((R, H, W, Cn), float("nan"), dtype=torch.bfloat16).permute(0, 3, 1, 2)


def sim_se_block(lib, y, x, norm, se, sms=None):
    """The SE kernel over ``sms`` CTAs (one a row by default: the simulation
    holds one CTA an SM)."""
    R, Cn, H, W = y.shape
    out = sim_out(y.shape)
    rc = lib.tafl_se_block(y.data_ptr(), x.data_ptr(), *(t.data_ptr() for t in norm), EPS,
                           *(t.data_ptr() for t in se), se[0].shape[0], R, Cn, H * W,
                           R if sms is None else sms, out.data_ptr(), None)
    assert rc == 0 and not out.isnan().any()
    return out


def sim_bn_relu(lib, y, norm):
    R, Cn, H, W = y.shape
    out = sim_out(y.shape)
    rc = lib.tafl_bn_relu(y.data_ptr(), *(t.data_ptr() for t in norm), EPS, R, Cn, H * W,
                          out.data_ptr(), None)
    assert rc == 0 and not out.isnan().any()
    return out


@pytest.mark.parametrize("saturate", [False, True], ids=["gate", "saturated"])
def test_sim_se_block_at_the_published_width(sim, saturate):
    """256 channels on 11x11, the cell's shape (3,872 packs a row over 512
    threads, the last ones' share short): within 1 ulp of exact math rounded
    once, as is the plain chain; the saturated gate passes the norm whole or
    not at all."""
    y, x, norm, se = se_inputs(256 + saturate, 2, 256, 11, saturate)
    got = sim_se_block(sim, y, x, norm, se)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert se_op.se_block_ulps(got, y, x, *norm, EPS, *se) <= 1
    plain = se_op.se_block_plain(y, x, *norm, EPS, *se)
    assert se_op.se_block_ulps(plain, y, x, *norm, EPS, *se) <= 1


@pytest.mark.parametrize("Cn, n", [(32, 7), (64, 11), (128, 9)])
def test_sim_se_block_other_shapes(sim, Cn, n):
    y, x, norm, se = se_inputs(Cn + n, 3, Cn, n)
    got = sim_se_block(sim, y, x, norm, se)
    assert se_op.se_block_ulps(got, y, x, *norm, EPS, *se) <= 1


@pytest.mark.parametrize("Cn, n", [(256, 11), (32, 7)])
def test_sim_bn_relu(sim, Cn, n):
    y, _, norm, _ = se_inputs(Cn * n, 3, Cn, n)
    got = sim_bn_relu(sim, y, norm)
    assert se_op.bn_relu_ulps(got, y, *norm, EPS) <= 1
    assert se_op.bn_relu_ulps(se_op.bn_relu_plain(y, *norm, EPS), y, *norm, EPS) <= 1


def test_the_ulp_count_finds_a_wrong_block(sim):
    """The yardstick is tight enough to see a fault: the gate left at a
    half, or the SE unit's shift left out, is hundreds of ulps off."""
    y, x, norm, (w1, b1, w2, b2) = se_inputs(17, 2, 64, 11)
    flat_gate = torch.cat([torch.zeros_like(b2[:64]), b2[64:]])
    wrong_gate = sim_se_block(sim, y, x, norm, [w1, b1, torch.cat([0 * w2[:64], w2[64:]]),
                                                 flat_gate])
    no_shift = sim_se_block(sim, y, x, norm, [w1, b1, torch.cat([w2[:64], 0 * w2[64:]]),
                                               torch.cat([b2[:64], 0 * b2[64:]])])
    for got in (wrong_gate, no_shift):
        assert se_op.se_block_ulps(got, y, x, *norm, EPS, w1, b1, w2, b2) > 100


@pytest.mark.parametrize("R, sms, Cn, n", [(5, 2, 256, 11), (7, 3, 64, 11), (4, 1, 32, 7)])
def test_sim_se_block_several_rows_a_cta(sim, R, sms, Cn, n):
    """Fewer CTAs than rows: each CTA walks several rows through its one
    row buffer, its barrier's parity turning a row, rows not a multiple of
    the grid; the result is the one-CTA-a-row result bit for bit, within 1
    ulp of exact math."""
    y, x, norm, se = se_inputs(R * Cn + n, R, Cn, n)
    got = sim_se_block(sim, y, x, norm, se, sms=sms)
    assert torch.equal(got, sim_se_block(sim, y, x, norm, se))
    assert se_op.se_block_ulps(got, y, x, *norm, EPS, *se) <= 1


def test_sim_se_block_weights_from_global_memory(sim):
    """Ratio 4 at 256 channels on 11x11: the weights (198,912 bytes) do not
    fit beside the row buffer, so the kernel reads them from global memory,
    held to the same 1 ulp, several rows a CTA as in the resident path."""
    assert not se_op.se_block_plan(sim, 256, 64, 121)[0]
    y, x, norm, se = se_inputs(41, 3, 256, 11, ratio=4)
    got = sim_se_block(sim, y, x, norm, se, sms=2)
    assert se_op.se_block_ulps(got, y, x, *norm, EPS, *se) <= 1
    assert torch.equal(got, sim_se_block(sim, y, x, norm, se))


SMEM_BYTES = 232_448  # the most dynamic shared memory an H100 CTA may hold


def test_the_kernel_plan_serves_the_whole_domain(sim):
    """Every shape ``se_block_applies`` admits, at every hidden width, is a
    launch within a CTA's shared memory; the weights are resident at the
    cell's shape and up to 52 hidden at 256 channels on 11x11, where they
    stop fitting beside the row of y, and always at 64 channels or fewer;
    shapes outside the domain are refused."""
    for Cn in se_op.CHANNELS:
        top = se_op.max_positions(Cn)
        for hw in sorted({1, 49, 81, 121, top}):
            for hidden in range(1, Cn + 1):
                resident, smem = se_op.se_block_plan(sim, Cn, hidden, hw)
                assert 0 < smem <= SMEM_BYTES
                assert resident or Cn > 64
    assert se_op.se_block_plan(sim, 256, 32, 121) == (True, 169_744)
    assert [se_op.se_block_plan(sim, 256, h, 121)[0] for h in (52, 53)] == [True, False]
    for Cn, hidden, hw in [(96, 12, 121), (256, 0, 121), (256, 257, 121), (256, 32, 129),
                           (32, 4, 1025)]:
        with pytest.raises(ValueError):
            se_op.se_block_plan(sim, Cn, hidden, hw)


@pytest.fixture
def counters(monkeypatch):
    for name, value in (("launches", 0), ("batches", {}), ("resident_launches", 0)):
        monkeypatch.setattr(se_op.se_block, name, value)
    return se_op.se_block


@pytest.mark.parametrize("Cn, ratio, resident", [(256, 8, True), (256, 4, False),
                                                  (32, 8, True)])
def test_the_wrapper_counts_each_launch(sim, counters, Cn, ratio, resident):
    """``launch_se_block``, the card's path with the simulation's library:
    one launch a call, counted by rows, and among ``resident_launches``
    exactly where the weights fit shared memory."""
    y, x, norm, se = se_inputs(Cn + ratio, 3, Cn, 11, ratio=ratio)
    out = sim_out(y.shape)
    se_op.launch_se_block(sim, y, x, *norm, EPS, *se, out, 2, None)
    assert (counters.launches, counters.batches) == (1, {3: 1})
    assert counters.resident_launches == int(resident)
    assert se_op.se_block_ulps(out, y, x, *norm, EPS, *se) <= 1
    with pytest.raises(ValueError, match="16-byte boundary"):
        flat = torch.empty(y.numel() + 1, dtype=torch.bfloat16)[1:]
        shifted = flat.view(3, 11, 11, Cn).permute(0, 3, 1, 2).copy_(y)
        se_op.launch_se_block(sim, shifted, x, *norm, EPS, *se, out, 2, None)
    assert counters.launches == 1


def test_a_forward_launches_once_a_site(sim, counters, monkeypatch):
    """A forward of the SE net through the wrapper's launch (the simulation
    standing in for the card) makes one launch a block, each resident at
    ratio 8 and within 1 ulp of exact math."""
    def se(y, skip, *args):
        out = sim_out(y.shape)
        se_op.launch_se_block(sim, y, skip, *args, out, 2, None)
        assert se_op.se_block_ulps(out, y, skip, *args) <= 1
        return out

    net = se_net(seed=21, dtype=torch.bfloat16, blocks=3).eval()
    obs = observations(11, 3, seed=22)
    with torch.inference_mode():
        monkeypatch.setattr(tnetwork, "se_block_applies", lambda *facts: True)
        monkeypatch.setattr(tnetwork, "se_block", se)
        monkeypatch.setattr(tnetwork, "bn_relu", lambda y, *args: se_op.bn_relu_plain(y, *args))
        net(obs)
    assert (counters.launches, counters.resident_launches, counters.batches) == (3, 3, {3: 3})
