"""The PyTorch search against the JAX search, exactly.

Both sides use the deterministic fake network of tests/test_mcts.py (integer
hash logits, tie-free for A < 9973), root noise off, 32 simulations and 32
children. Root visit counts, ``action_probs`` and ``root_value`` must be
equal, not close.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazeroforhnefatafl_tpu.core import env as jenv
from alphazeroforhnefatafl_tpu.search.mcts import MCTS as JaxMCTS
from alphazeroforhnefatafl_tpu.search.mcts import MCTSConfig as JaxConfig
from alphazeroforhnefatafl_tpu_torch.core import env as tenv
from alphazeroforhnefatafl_tpu_torch.search import mcts as tmcts
from tests.test_mcts import make_fake_evaluate
from tests.test_torch_env import to_jax


def torch_fake_evaluate(env):
    """tests/test_mcts.py's fake network, computed from the torch planes."""
    a = torch.arange(env.num_actions, dtype=torch.int64)

    def evaluate(obs):
        B = obs.shape[0]
        att = obs[..., 0].sum((1, 2)).long()
        deff = obs[..., 1].sum((1, 2)).long()
        king = obs[..., 2].reshape(B, -1).argmax(-1)
        side = obs[:, 0, 0, 4].long()
        key = att + 3 * deff + 11 * king + 7 * side
        logits = ((a[None, :] * 12345 + key[:, None] * 7919) % 9973).float() / 9973.0
        value = ((key * 131 + 29) % 201 - 100).float() / 100.0
        return logits, value

    return evaluate


def playout_positions(env, plies=(0, 5, 12), seed=3):
    """Positions along one random game per ply count, as a torch batch."""
    rng = np.random.RandomState(seed)
    picked = []
    for target in plies:
        s = env.reset()
        for _ in range(target):
            legal = env.legal_mask_many(s)[0].numpy()
            if not legal.any():
                break
            s, _ = env.step_many(s, torch.tensor([rng.choice(np.nonzero(legal)[0])]))
        picked.append(s)
    return tenv.EnvState(
        **{f: torch.cat([getattr(p, f) for p in picked]) for f in tenv.EnvState.__dataclass_fields__}
    )


CFG = dict(num_simulations=32, max_children=32, cpuct=1.5, dirichlet_eps=0.0, max_depth=64)


@pytest.mark.parametrize("preset", ["brandubh", "tablut", "copenhagen"])
def test_search_matches_jax_exactly(preset):
    torch_env, jax_env = tenv.make_env(preset, "cpu"), jenv.make_env(preset)
    states = playout_positions(torch_env)
    legal = torch_env.legal_mask_many(states)

    jm = JaxMCTS(jax_env, make_fake_evaluate(jax_env), JaxConfig(**CFG))
    want = jax.jit(lambda s, l, r: jm.search(None, s, l, r, add_noise=False))(
        to_jax(states), jnp.asarray(legal.numpy()), jax.random.PRNGKey(0)
    )
    tm = tmcts.MCTS(torch_env, torch_fake_evaluate(torch_env), tmcts.MCTSConfig(**CFG))
    got = tm.search(states, legal, add_noise=False)

    np.testing.assert_array_equal(np.asarray(want.tree.child_N[:, 0]), got.tree.child_N[:, 0].numpy())
    np.testing.assert_array_equal(np.asarray(want.tree.child_action[:, 0]), got.tree.child_action[:, 0].numpy())
    np.testing.assert_array_equal(np.asarray(want.action_probs), got.action_probs.numpy())
    np.testing.assert_array_equal(np.asarray(want.root_value), got.root_value.numpy())
    np.testing.assert_array_equal(np.asarray(want.root_visits), got.root_visits.numpy())
    np.testing.assert_array_equal(np.asarray(want.best_action), got.best_action.numpy())
    np.testing.assert_array_equal(np.asarray(want.prior_fallback_rate), got.prior_fallback_rate.numpy())


def test_masked_priors_fallback_flag():
    logits = torch.tensor([[0.0, 1.0, 2.0], [-2e30, -2e30, 0.0], [5.0, 5.0, 5.0]])
    legal = torch.tensor([[True, False, True], [True, True, False], [False, False, False]])
    p, fb = tmcts._masked_priors_fb(logits, legal)
    assert fb.tolist() == [False, True, True]
    # Normal row: softmax over the legal entries.
    e = np.exp([0.0, 2.0])
    np.testing.assert_allclose(p[0].numpy(), [e[0] / e.sum(), 0.0, e[1] / e.sum()], rtol=1e-6)
    # All legal logits underflow to zero mass: uniform over the legal set.
    assert p[1].tolist() == [0.5, 0.5, 0.0]
    assert p[2].tolist() == [0.0, 0.0, 0.0]


def test_dirichlet_sampler_mean():
    alpha = torch.tensor([0.3, 1.0, 2.0, 1e-3]).expand(20000, 4).contiguous()
    g = torch.Generator().manual_seed(0)
    x = tmcts._dirichlet(alpha, g)
    np.testing.assert_allclose(x.sum(1).numpy(), 1.0, rtol=1e-5)
    want = alpha[0] / alpha[0].sum()
    np.testing.assert_allclose(x.mean(0).numpy(), want.numpy(), atol=0.01)


def test_noise_changes_only_the_priors_and_stays_legal():
    env = tenv.make_env("brandubh", "cpu")
    states = playout_positions(env, plies=(0, 3))
    legal = env.legal_mask_many(states)
    tm = tmcts.MCTS(env, torch_fake_evaluate(env), tmcts.MCTSConfig(num_simulations=8, max_children=16))
    res = tm.search(states, legal, torch.Generator().manual_seed(1), add_noise=True)
    acts = res.tree.child_action[:, 0]
    assert all(bool(legal[b, a]) for b in range(2) for a in acts[b].tolist() if a >= 0)
    assert int(res.root_visits.sum()) == 16
    np.testing.assert_allclose(res.action_probs.sum(1).numpy(), 1.0, rtol=1e-6)
