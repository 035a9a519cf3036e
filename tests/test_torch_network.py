"""The PyTorch net on converted Flax weights gives the JAX net's outputs.

Both nets run in float32 on freshly initialized Flax parameters. Tolerance
``atol = rtol = 1e-4``: XLA and ATen sum the convolutions in different
orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazeroforhnefatafl_tpu.models.network import PolicyValueNet as FlaxNet
from alphazeroforhnefatafl_tpu_torch.models.convert import params_from_flax
from alphazeroforhnefatafl_tpu_torch.models.network import init_params, make_network


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
