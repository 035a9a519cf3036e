"""The PyTorch net on converted Flax weights gives the JAX net's outputs.

Both nets run in float32 on freshly initialized Flax parameters. Tolerance
``atol = rtol = 1e-4``: XLA and ATen sum the convolutions in different
orders.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from alphazeroforhnefatafl_tpu.models.network import PolicyValueNet as FlaxNet
from alphazeroforhnefatafl_tpu_torch.models import network as tnetwork
from alphazeroforhnefatafl_tpu_torch.models.convert import params_from_flax
from alphazeroforhnefatafl_tpu_torch.models.network import init_params, make_network
from alphazeroforhnefatafl_tpu_torch.ops import group_norm as gn_op
from alphazeroforhnefatafl_tpu_torch.train import learner as tlearner


def _flax_params(n, norm, seed):
    net = FlaxNet(board_size=n, channels=16, blocks=2, dtype=jnp.float32, norm=norm)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, n, n, 6), jnp.float32))
    if norm == "none":
        # SkipInit starts every branch gain at 0; give them values so the
        # residual branches count in the comparison.
        inner = dict(params["params"])
        for i in range(2):
            blk = dict(inner[f"NFResBlock_{i}"])
            blk["skip_gain"] = jnp.asarray([0.5 + 0.25 * i], jnp.float32)
            inner[f"NFResBlock_{i}"] = blk
        params = {"params": inner}
    return net, params


@pytest.mark.parametrize("norm", ["group", "none"])
@pytest.mark.parametrize("n", [7, 11])
def test_converted_weights_match_flax(n, norm):
    net, params = _flax_params(n, norm, seed=n)
    rng = np.random.RandomState(n)
    obs = rng.rand(5, n, n, 6).astype(np.float32)
    want_logits, want_value = net.apply(params, jnp.asarray(obs))

    tnet = make_network(n, channels=16, blocks=2, norm=norm, dtype=torch.float32)
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    assert set(sd) == set(tnet.state_dict())
    tnet.load_state_dict(sd)
    with torch.no_grad():
        logits, value = tnet(torch.from_numpy(obs))
    assert logits.shape == (5, n * n * 4 * (n - 1)) and value.shape == (5,)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), atol=1e-4, rtol=1e-4)


def test_init_params_is_seeded_and_flax_like():
    a = init_params(make_network(7, channels=8, blocks=1), torch.Generator().manual_seed(1))
    b = init_params(make_network(7, channels=8, blocks=1), torch.Generator().manual_seed(1))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    w = a.stem.weight
    fan_in = w[0].numel()
    assert w.abs().max() <= 2 * (1.0 / fan_in) ** 0.5 / 0.8796 + 1e-6
    assert torch.all(a.policy_out.bias == 0)


def test_bf16_trunk_keeps_float32_heads():
    net = make_network(7, channels=8, blocks=1, dtype=torch.bfloat16)
    init_params(net, torch.Generator().manual_seed(0))
    logits, value = net(torch.rand(3, 7, 7, 6))
    assert logits.dtype == torch.float32 and value.dtype == torch.float32
    assert torch.isfinite(logits).all() and (value.abs() <= 1).all()


@pytest.mark.parametrize("norm", ["group", "none"])
def test_bf16_trunk_matches_flax_bf16(norm):
    """The port's bf16-trunk net against the Flax net at ``dtype=bfloat16``
    on the same converted weights. Tolerance tied to JAX's own bf16 error:
    the port's distance from JAX's bf16 output is at most twice JAX's bf16
    distance from its float32 output, for logits and value; the policy
    argmax agrees row by row."""
    n = 11
    _, params = _flax_params(n, norm, seed=5)
    obs = jnp.asarray(np.random.RandomState(5).rand(16, n, n, 6).astype(np.float32))
    f32_logits, f32_value = FlaxNet(board_size=n, channels=16, blocks=2, dtype=jnp.float32,
                                    norm=norm).apply(params, obs)
    bf_logits, bf_value = FlaxNet(board_size=n, channels=16, blocks=2, dtype=jnp.bfloat16,
                                  norm=norm).apply(params, obs)
    tnet = make_network(n, channels=16, blocks=2, norm=norm, dtype=torch.bfloat16)
    tnet.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        logits, value = tnet(torch.from_numpy(np.asarray(obs)))
    for name, got, want, ref in (("logits", logits, bf_logits, f32_logits),
                                 ("value", value, bf_value, f32_value)):
        got = got.float().numpy()
        want, ref = np.asarray(want, np.float32), np.asarray(ref, np.float32)
        jax_err = np.abs(want - ref).max()
        assert jax_err > 0, name
        assert np.abs(got - want).max() <= 2 * jax_err, name
    np.testing.assert_array_equal(logits.float().numpy().argmax(1),
                                  np.asarray(bf_logits, np.float32).argmax(1))


# The GroupNorm sites' dispatch (models/network.py ``norm_act``).

SERVED = dict(device_type="cuda", dtype=torch.bfloat16, channels_last=True, grad=False,
              groups=32, channels=64, positions=121)


@pytest.mark.parametrize("change, applies", [
    ({}, True),
    *[({"channels": c}, True) for c in (32, 128, 256)],
    ({"channels": 64, "positions": 512}, True),
    ({"channels": 256, "positions": 128}, True),
    ({"device_type": "cpu"}, False),
    ({"device_type": "meta"}, False),
    ({"dtype": torch.float32}, False),
    ({"dtype": torch.float16}, False),
    ({"channels_last": False}, False),
    ({"grad": True}, False),
    ({"groups": 16}, False),
    ({"groups": 8, "channels": 8}, False),
    *[({"channels": c}, False) for c in (16, 48, 96, 512)],
    ({"channels": 64, "positions": 513}, False),
    ({"channels": 256, "positions": 169}, False),
])
def test_kernel_applies_only_where_served(change, applies):
    """True for a CUDA bf16 channels-last activation with autograd off, 32
    groups and C in {32, 64, 128, 256} on a board that fits the kernel's
    registers; any one fact otherwise makes it false."""
    assert gn_op.kernel_applies(**{**SERVED, **change}) is applies


def test_state_dict_keys_unchanged():
    """The checkpoints' and the benchmark's keys (it loads with strict=True)."""
    net = make_network(7, channels=32, blocks=2)
    want = ["stem.weight", "stem_gn.weight", "stem_gn.bias"]
    for i in range(2):
        want += [f"blocks.{i}.{k}" for k in ("conv0.weight", "gn0.weight", "gn0.bias",
                                             "conv1.weight", "gn1.weight", "gn1.bias")]
    want += ["policy_conv.weight", "policy_gn.weight", "policy_gn.bias", "policy_out.weight",
             "policy_out.bias", "value_conv.weight", "value_conv.bias", "value_fc.weight",
             "value_fc.bias", "value_out.weight", "value_out.bias"]
    assert list(net.state_dict()) == want


def parent_forward(net, obs):
    """The GroupNorm net's forward as it was before the kernel: each site a
    float32 GroupNorm cast back, then a ReLU or the skip add and a ReLU."""
    def conv(m, x):
        b = None if m.bias is None else m.bias.to(x.dtype)
        return m._conv_forward(x, m.weight.to(x.dtype), b)

    def gn(m, x):
        return F.group_norm(x.float(), m.num_groups, m.weight, m.bias, m.eps).to(x.dtype)

    B = obs.shape[0]
    x = F.relu(gn(net.stem_gn, conv(net.stem, obs.permute(0, 3, 1, 2).to(net.dtype))))
    for blk in net.blocks:
        y = F.relu(gn(blk.gn0, conv(blk.conv0, x)))
        x = F.relu(x + gn(blk.gn1, conv(blk.conv1, y)))
    p = conv(net.policy_out, F.relu(gn(net.policy_gn, conv(net.policy_conv, x))).float())
    v = F.relu(conv(net.value_conv, x.float())).permute(0, 2, 3, 1).reshape(B, -1)
    v = net.value_out(F.relu(net.value_fc(v)))
    return p.permute(0, 2, 3, 1).reshape(B, -1), torch.tanh(v)[:, 0]


def gn_net(dtype, channels=32, blocks=2, seed=0, n=11):
    net = make_network(n, channels=channels, blocks=blocks, dtype=dtype)
    init_params(net, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # GroupNorm affine away from 1 and 0, so it counts
        for m in net.modules():
            if isinstance(m, torch.nn.GroupNorm):
                m.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(seed + 1))
                m.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(seed + 2))
    return net


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_forward_is_the_parents_chain(dtype, grad):
    """On the CPU every site takes PyTorch's chain, bit for bit the parent's,
    under ``inference_mode`` and with grad on; the kernel is not launched
    and no plain call is counted (the count is the card's)."""
    net = gn_net(dtype)
    obs = torch.rand(5, 11, 11, 6, generator=torch.Generator().manual_seed(3))
    launches, plain = gn_op.group_norm_act.launches, tnetwork.norm_act.plain_calls
    with torch.inference_mode(not grad):
        got = net(obs)
        want = parent_forward(net, obs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert gn_op.group_norm_act.launches == launches and tnetwork.norm_act.plain_calls == plain


def test_sites_hand_the_kernel_the_skip_and_the_relu(monkeypatch):
    """Where the kernel applies, a forward of 6 blocks makes 14 calls: the
    stem, two a block (the second with the block's input as skip) and the
    policy head; the ReLU that follows each site is the kernel's own."""
    calls = []

    def record(x, weight, bias, eps, skip=None):
        calls.append(skip is not None)
        return gn_op.group_norm_act_plain(x, 32, weight, bias, eps, skip)

    monkeypatch.setattr(tnetwork, "kernel_applies", lambda *facts: True)
    monkeypatch.setattr(tnetwork, "group_norm_act", record)
    net = gn_net(torch.bfloat16, blocks=6)
    obs = torch.rand(3, 11, 11, 6, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        got = net(obs)
        want = parent_forward(net, obs)
    assert calls == [False] + [False, True] * 6 + [False]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_learner_step_is_the_parents_chain(dtype):
    """The learner's forward and backward run with grad on, so every site
    takes the plain chain: two train steps give the parent's loss,
    gradients and parameters bit for bit."""
    rng = np.random.RandomState(0)
    n, b = 7, 8
    a = n * n * 4 * (n - 1)
    legal = torch.from_numpy(rng.rand(b, a) < 0.1)
    pt = torch.from_numpy(rng.rand(b, a).astype(np.float32)) * legal
    batch = tlearner.Batch(
        obs=torch.from_numpy(rng.rand(b, n, n, 6).astype(np.float32)),
        policy_target=pt / pt.sum(1, keepdim=True),
        value_target=torch.from_numpy(rng.uniform(-1, 1, b).astype(np.float32)),
        legal_mask=legal,
    )
    runs = []
    for parent in (False, True):
        net = make_network(n, channels=32, blocks=2, dtype=dtype)
        state = tlearner.init_train_state(net, torch.Generator().manual_seed(0), "cpu",
                                          learning_rate=1e-2, warmup_steps=1)
        net.load_state_dict(gn_net(dtype, n=n).state_dict())
        if parent:
            net.forward = types.MethodType(parent_forward, net)
        step = tlearner.make_train_step(state)
        losses = [step(batch)["loss"] for _ in range(2)]
        runs.append((losses, [p.grad.clone() for p in net.parameters()],
                     [p.detach().clone() for p in net.parameters()]))
    (l0, g0, p0), (l1, g1, p1) = runs
    assert all(torch.equal(x, y) for x, y in zip(l0, l1))
    assert all(torch.equal(x, y) for x, y in zip(g0, g1))
    assert all(torch.equal(x, y) for x, y in zip(p0, p1))
