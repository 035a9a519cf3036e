"""A run with the timed path broken underneath comes out not correct, once
for each fault a self-play cell can have. The card check is skipped; the
rest of a run is driven at a tiny size on the CPU."""

import torch

from conftest import tiny_cell

SEED = 2**31 + 4242


def _run():
    import run

    return run.measure(tiny_cell(), SEED, 0.0, False, "cpu", 0.0)


def _failed(r, name):
    c = r["out"]["checks"][name]
    return not r["correct"] and c["value"] > c["limit"]


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from alphazeroforhnefatafl_tpu_torch.core.env import TaflEnv

    real = TaflEnv.step_many

    def step_many(self, states, actions):
        _, info = real(self, states, actions)
        return states, info

    monkeypatch.setattr(TaflEnv, "step_many", step_many)
    assert _failed(_run(), "rules_mismatch")


def test_half_of_the_batch_left_out(monkeypatch):
    from alphazeroforhnefatafl_tpu_torch.core.env import TaflEnv, where_state

    real = TaflEnv.step_many

    def step_many(self, states, actions):
        new, info = real(self, states, actions)
        half = torch.arange(states.batch_size, device=actions.device) < states.batch_size // 2
        return where_state(half, new, states), info

    monkeypatch.setattr(TaflEnv, "step_many", step_many)
    assert _failed(_run(), "rules_mismatch")


def test_an_action_altered_where_it_is_chosen(monkeypatch):
    from alphazeroforhnefatafl_tpu_torch.train import selfplay

    def select_actions(probs, legal, temperature, generator):
        # The legal action the search liked least.
        return torch.where(legal, probs, 2.0).argmin(-1).to(torch.int32)

    monkeypatch.setattr(selfplay, "select_actions", select_actions)
    assert _failed(_run(), "move_mismatch")


def test_a_policy_target_altered_where_it_is_made(monkeypatch):
    from alphazeroforhnefatafl_tpu_torch.train.selfplay import SelfPlayActor

    real = SelfPlayActor.policy_target

    def policy_target(self, action_probs):
        top_a, top_p = real(self, action_probs)
        return top_a, top_p * 0.5

    monkeypatch.setattr(SelfPlayActor, "policy_target", policy_target)
    r = _run()
    assert _failed(r, "search_mismatch") or _failed(r, "move_mismatch")


def test_a_search_that_skips_its_backup(monkeypatch):
    from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTS

    real = MCTS._wave

    def wave(self, tree, sim0, forced_root_slot=None):
        w = tree.child_W.clone()
        out = real(self, tree, sim0, forced_root_slot)
        tree.child_W.copy_(w)
        return out

    monkeypatch.setattr(MCTS, "_wave", wave)
    assert _failed(_run(), "backup_gap_ratio")


def test_a_net_output_altered_where_it_is_produced(monkeypatch):
    from alphazeroforhnefatafl_tpu_torch.models.network import PolicyValueNet

    real = PolicyValueNet.forward

    def forward(self, obs):
        logits, value = real(self, obs)
        return logits + 1.0 * (torch.arange(logits.shape[1]) % 3 == 0), value

    monkeypatch.setattr(PolicyValueNet, "forward", forward)
    r = _run()
    assert _failed(r, "logit_gap") and _failed(r, "prior_gap")


def test_the_unbroken_run_is_correct():
    r = _run()
    assert r["correct"], (r["out"]["checks"], r["out"]["check_extra"]["notes"])
