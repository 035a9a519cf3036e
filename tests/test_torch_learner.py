"""The port's batch builder, loss, schedule and train step against the JAX
learner on the same numpy inputs.

Both nets run in float32 (16 channels, 2 blocks, 7x7 Brandubh) on the same
freshly initialized Flax parameters, converted for the port. Tolerances:
the batch builder's integer outputs are exact and its float targets within
1e-7; loss metrics within 1e-5; the learning-rate schedule within 1e-9
relative of optax's formula evaluated in float64 (and within float32
rounding of optax as the JAX learner runs it); over five train steps loss
and ``grad_norm`` within 1e-4 relative and every parameter within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from alphazeroforhnefatafl_tpu.core import env as jenv
from alphazeroforhnefatafl_tpu.models.network import PolicyValueNet as FlaxNet
from alphazeroforhnefatafl_tpu.train import learner as jlearner
from alphazeroforhnefatafl_tpu.train.replay import make_batch_builder as jax_batch_builder
from alphazeroforhnefatafl_tpu_torch.core import env as tenv
from alphazeroforhnefatafl_tpu_torch.models.convert import params_from_flax
from alphazeroforhnefatafl_tpu_torch.models.network import make_network
from alphazeroforhnefatafl_tpu_torch.train import learner as tlearner
from alphazeroforhnefatafl_tpu_torch.train.replay import make_batch_builder
from tests.test_env_golden import random_dense_board

N, CHANNELS, BLOCKS = 7, 16, 2
A = N * N * 4 * (N - 1)


@pytest.fixture(autouse=True, scope="module")
def single_thread():
    """One intra-op thread while a module's tests run: at these sizes more
    threads only contend with the other test workers' (the loop tests take
    tens of times longer under six workers with a thread per core each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nets(norm="group", seed=0):
    """The Flax net with fresh parameters and the port's net on the same."""
    fnet = FlaxNet(board_size=N, channels=CHANNELS, blocks=BLOCKS, dtype=jnp.float32, norm=norm)
    params = fnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, N, N, 6), jnp.float32))
    tnet = make_network(N, channels=CHANNELS, blocks=BLOCKS, norm=norm, dtype=torch.float32)
    tnet.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return fnet, params, tnet


def sample(rng, B, K=8):
    """A replay sample as numpy arrays: dense random boards, both sides,
    repetition counts 0-2, sparse policy rows of 1-K entries padded with -1."""
    board = np.stack([random_dense_board(rng, N) for _ in range(B)]).astype(np.int8)
    side = rng.randint(0, 2, size=B).astype(np.int8)
    reps = rng.randint(0, 3, size=B).astype(np.int8)
    pidx = np.full((B, K), -1, np.int32)
    pp = np.zeros((B, K), np.float32)
    for b in range(B):
        k = rng.randint(1, K + 1)
        pidx[b, :k] = rng.choice(A, size=k, replace=False)
        pp[b, :k] = rng.dirichlet(np.ones(k))
    value = rng.choice([-1.0, 0.0, 1.0], size=B).astype(np.float32)
    return board, side, reps, pidx, pp, value


def test_batch_builder_matches_jax():
    jax_env, torch_env = jenv.make_env("brandubh"), tenv.make_env("brandubh", "cpu")
    arrays = sample(np.random.RandomState(0), 12)
    board, side, reps, pidx, pp, value = arrays
    pidx[0], pp[0] = -1, 0.0  # a row of pads only
    pidx[1, :3], pp[1, :3] = 77, (0.5, 0.25, 0.25)  # one action listed three times
    want = jax_batch_builder(jax_env)(*map(jnp.asarray, arrays))
    got = make_batch_builder(torch_env)(*arrays)

    assert got.obs.dtype == torch.float32 and got.legal_mask.dtype == torch.bool
    np.testing.assert_array_equal(got.obs.numpy(), np.asarray(want.obs))
    np.testing.assert_array_equal(got.legal_mask.numpy(), np.asarray(want.legal_mask))
    np.testing.assert_allclose(got.policy_target.numpy(), np.asarray(want.policy_target), atol=1e-7, rtol=0)
    np.testing.assert_allclose(got.value_target.numpy(), np.asarray(want.value_target), atol=1e-7, rtol=0)
    target = got.policy_target.numpy()
    assert target[0].sum() == 0 and target[1, 77] == 1.0
    np.testing.assert_allclose(target[2:].sum(1), 1.0, atol=1e-6)
    # The mover's repetition plane, and the mask of the position's own side.
    np.testing.assert_allclose(got.obs[:, 0, 0, 5].numpy(), reps / 3.0, rtol=1e-6)
    states = torch_env.reset_batch(12).replace(
        board=torch.from_numpy(board), side_to_play=torch.from_numpy(side).int()
    )
    assert torch.equal(got.legal_mask, torch_env.legal_mask_many(states))
    # Tensors (as the loop passes after augmenting) give the same batch.
    again = make_batch_builder(torch_env)(*map(torch.from_numpy, arrays))
    assert torch.equal(again.obs, got.obs) and torch.equal(again.policy_target, got.policy_target)


def batches(rng, count, B=16, value_scale=()):
    """``count`` dense training batches as numpy dicts: random planes, a
    random legal set per row, a Dirichlet target over it, uniform values."""
    out = []
    for i in range(count):
        legal = rng.rand(B, A) < 0.05
        legal[:, i] = True
        pt = np.where(legal, rng.gamma(0.5, size=(B, A)), 0.0)
        pt = (pt / pt.sum(1, keepdims=True)).astype(np.float32)
        # Row 0 puts a quarter of its weight on an illegal action: the loss
        # ignores it (it is no part of the sum), it does not blow up.
        illegal = int(np.flatnonzero(~legal[0])[0])
        pt[0] *= 0.75
        pt[0, illegal] = 0.25
        scale = value_scale[i] if i < len(value_scale) else 1.0
        out.append(dict(
            obs=rng.rand(B, N, N, 6).astype(np.float32),
            policy_target=pt,
            value_target=(rng.uniform(-1, 1, B) * scale).astype(np.float32),
            legal_mask=legal,
        ))
    return out


def as_jax(b):
    return jlearner.Batch(**{k: jnp.asarray(v) for k, v in b.items()})


def as_torch(b):
    return tlearner.Batch(**{k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("norm", ["group", "none"])
def test_loss_matches_jax(norm):
    fnet, params, tnet = nets(norm, seed=1)
    (b,) = batches(np.random.RandomState(1), 1)
    want_loss, want = jlearner.loss_fn(fnet, params, as_jax(b))
    got_loss, got = tlearner.loss_fn(tnet, as_torch(b))
    assert set(got) == set(want) == {"loss", "policy_loss", "value_loss", "value_mean"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-5, rtol=1e-5, err_msg=k)
    assert 0 < float(got["policy_loss"]) < 20
    assert got_loss.requires_grad and float(got_loss.detach()) == float(got["loss"])
    assert not any(v.requires_grad for v in got.values())


SCHEDULE_STEPS = [0, 1, 199, 200, 201, 100_000, 199_999, 200_000, 250_000]


@pytest.mark.parametrize("peak, warmup", [(2e-3, 200), (1e-2, 1), (5e-4, 2)])
def test_schedule_matches_optax(peak, warmup):
    # The schedule of the JAX learner's make_optimizer (learner.py:44-50).
    args = dict(init_value=0.0, peak_value=peak, warmup_steps=warmup,
                decay_steps=200_000, end_value=peak * 0.05)
    mine = tlearner.learning_rate_schedule(peak, warmup)
    steps = sorted(set(SCHEDULE_STEPS + [warmup - 1, warmup, warmup + 1]))
    with jax.enable_x64(True):
        exact = optax.warmup_cosine_decay_schedule(**args)
        for s in steps:
            np.testing.assert_allclose(mine(s), float(exact(s)), rtol=1e-9, atol=0, err_msg=str(s))
    as_run = optax.warmup_cosine_decay_schedule(**args)  # float32, as the JAX learner runs it
    for s in steps:
        np.testing.assert_allclose(mine(s), float(as_run(s)), rtol=2e-6, atol=peak * 1e-6, err_msg=str(s))
    assert mine(0) == 0.0 and mine(warmup) == peak
    assert mine(200_000) == mine(250_000) == pytest.approx(peak * 0.05, rel=1e-12)

    # The optimizer applies it one step late, as optax does: the rate of an
    # update is the schedule at the count before it.
    p = torch.nn.Parameter(torch.ones(3))
    opt, sched = tlearner.make_optimizer([p], learning_rate=peak, warmup_steps=warmup)
    for s in range(4):
        assert opt.param_groups[0]["lr"] == mine(s)
        p.grad = torch.ones(3)
        opt.step()
        sched.step()
    group = opt.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == ((0.9, 0.999), 1e-8, 1e-4)


def test_five_train_steps_match_jax():
    fnet, params, tnet = nets("group", seed=2)
    # Batch 2's value targets are scaled up so that its gradient norm
    # passes 1 by a wide margin whatever the net does by then.
    data = batches(np.random.RandomState(2), 5, value_scale=(1.0, 1.0, 6.0))
    opt = jlearner.make_optimizer(learning_rate=2e-3, warmup_steps=2)
    jstate = jlearner.TrainState(params=params, opt_state=opt.init(params), step=jnp.int32(0))
    jstep = jax.jit(jlearner.make_train_step(fnet, opt))
    optimizer, scheduler = tlearner.make_optimizer(tnet.parameters(), learning_rate=2e-3, warmup_steps=2)
    tstate = tlearner.TrainState(tnet, optimizer, scheduler)
    tstep = tlearner.make_train_step(tstate)
    before = {k: v.clone() for k, v in tnet.state_dict().items()}

    norms = []
    for i, b in enumerate(data):
        jstate, want = jstep(jstate, as_jax(b))
        got = tstep(as_torch(b))
        assert set(got) == set(want)
        for k in ("loss", "grad_norm", "policy_loss", "value_loss"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=0,
                                       err_msg=f"step {i} {k}")
        norms.append(float(got["grad_norm"]))
        if i == 0:
            # The first update has rate 0: nothing moves.
            for k, v in tnet.state_dict().items():
                assert torch.equal(v, before[k]), k
    assert max(norms) > 1.0, norms  # the clip was exercised
    assert tstate.step == int(jstate.step) == 5

    want_sd = params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    moved = 0.0
    for k, v in tnet.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
        moved = max(moved, float((v - before[k]).abs().max()))
    assert moved > 1e-3  # against a tolerance of 1e-5


def test_clip_scales_by_the_norm_exactly():
    """Above the bound the optimizer sees ``g / norm``, with no epsilon in
    the divisor (``clip_grad_norm_`` divides by ``norm + 1e-6``, which at a
    norm of 1.2 is 8e-7 short of 1: float32 shows that); below the bound
    the gradients are untouched."""
    lin = torch.nn.Linear(4, 1, bias=False)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = lin

        def forward(self, obs):
            return torch.zeros(obs.shape[0], 2), self.lin(obs)[:, 0]

    net = Net()
    state = tlearner.TrainState(net, *tlearner.make_optimizer(net.parameters()))
    step = tlearner.make_train_step(state)
    # The value is 2 on every row, so the gradient is 2 * (2 - target) on
    # each of the four weights and its norm 4 * |2 - target|.
    for target, want_norm in ((1.7, 1.2), (1.9, 0.4), (92.0, 360.0)):
        with torch.no_grad():
            lin.weight.fill_(0.5)
        batch = tlearner.Batch(torch.ones(2, 4), torch.tensor([[1.0, 0.0]] * 2),
                               torch.full((2,), target), torch.ones(2, 2, dtype=torch.bool))
        m = step(batch)
        given = lin.weight.grad.double()  # what the optimizer was given
        assert float(m["grad_norm"]) == pytest.approx(want_norm, rel=1e-5)  # before the clip
        if want_norm > 1:
            assert float(given.norm()) == pytest.approx(1.0, rel=2e-7)
        else:
            assert float(given.norm()) == pytest.approx(float(m["grad_norm"]), rel=2e-7)
        assert torch.allclose(given, given[0, 0].expand(1, 4)) and (float(given[0, 0]) > 0) == (target < 2)


@pytest.mark.parametrize("norm, dtype", [("group", torch.float32), ("none", torch.float32),
                                         ("group", torch.bfloat16), ("none", torch.bfloat16)])
def test_train_step_reduces_loss(norm, dtype):
    net = make_network(N, channels=8, blocks=1, norm=norm, dtype=dtype)
    state = tlearner.init_train_state(net, torch.Generator().manual_seed(0), "cpu",
                                      learning_rate=1e-2, warmup_steps=1)
    step = tlearner.make_train_step(state)
    rng = np.random.RandomState(0)
    b, a = 16, A
    legal = np.zeros((b, a), bool)
    legal[:, :10] = True
    pt = np.zeros((b, a), np.float32)
    pt[:, :10] = rng.dirichlet(np.ones(10), size=b)
    batch = tlearner.Batch(
        obs=torch.from_numpy(rng.randn(b, N, N, 6).astype(np.float32)),
        policy_target=torch.from_numpy(pt),
        value_target=torch.from_numpy(rng.uniform(-1, 1, b).astype(np.float32)),
        legal_mask=torch.from_numpy(legal),
    )
    losses = [float(step(batch)["loss"]) for _ in range(30)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert state.step == 30
    # Parameters and their gradients stay float32 under the bf16 trunk.
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in net.parameters())
