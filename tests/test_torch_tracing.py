"""The program's spans (``utils.profiling.span``) in the search, the
self-play move and the replay ring.

With no profiler running a span calls nothing of the profiler; under a
``torch.profiler`` session that records the host, one search emits exactly
its spans, nested as the search runs them, with one ``mcts/level_sync`` for
each level a traversal walked (each read of ``done.all()``, counted here by
a torch function mode); the search's and the move's outputs are the same
bit for bit with the profiler on and off; and ``SelfPlayActor.move`` calls
the search through the replaceable ``self.mcts.search`` attribute. Spans
are read from the exported Chrome trace as ``user_annotation`` events, as
a trace reader finds them.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.profiler import ProfilerActivity, profile

from alphazeroforhnefatafl_tpu_torch.core.env import EnvState, make_env, where_state
from alphazeroforhnefatafl_tpu_torch.search.mcts import MCTS, MCTSConfig
from alphazeroforhnefatafl_tpu_torch.train.replay import ReplayBuffer
from alphazeroforhnefatafl_tpu_torch.train.selfplay import SelfPlayActor, SelfPlayConfig
from alphazeroforhnefatafl_tpu_torch.utils import profiling

SEARCH_SPANS = {"mcts/search", "mcts/wave", "mcts/traverse", "mcts/level_sync",
                "mcts/leaf_step", "mcts/evaluate", "mcts/expand", "mcts/backup"}
#: Each span's innermost enclosing program span.
PARENT = {"mcts/wave": "mcts/search", "mcts/traverse": "mcts/wave",
          "mcts/level_sync": "mcts/traverse", "mcts/leaf_step": "mcts/wave",
          "mcts/evaluate": "mcts/wave", "mcts/expand": "mcts/wave", "mcts/backup": "mcts/wave",
          "selfplay/root_mask": "selfplay/move", "mcts/search": "selfplay/move",
          "selfplay/tail": "selfplay/move"}

CONFIGS = {
    "puct_serial": dict(num_simulations=8, max_children=8, leaves_per_wave=1),
    "puct_two_leaves": dict(num_simulations=8, max_children=8, leaves_per_wave=2,
                            dirichlet_alpha_scale=10.0),
    "gumbel": dict(num_simulations=8, max_children=8, root_selection="gumbel"),
}
B = 6


@pytest.fixture(autouse=True, scope="module")
def single_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fake_evaluate(env):
    """A deterministic stand-in for the net, computed from the planes."""
    a = torch.arange(env.num_actions, dtype=torch.int64)

    def evaluate(obs):
        n = obs.shape[0]
        att = obs[..., 0].sum((1, 2)).long()
        deff = obs[..., 1].sum((1, 2)).long()
        king = obs[..., 2].reshape(n, -1).argmax(-1)
        key = att + 3 * deff + 11 * king + 7 * obs[:, 0, 0, 4].long()
        logits = ((a[None, :] * 12345 + key[:, None] * 7919) % 9973).float() / 9973.0
        value = ((key * 131 + 29) % 201 - 100).float() / 100.0
        return logits, value

    return evaluate


def positions(env, plies=6, seed=7):
    """B games after up to ``plies`` random legal moves, a game that ends
    on the way starting again."""
    g = torch.Generator().manual_seed(seed)
    states, fresh = env.reset_batch(B), env.reset_batch(B)
    stop = torch.randint(0, plies + 1, (B,), generator=g)
    for p in range(plies):
        legal = env.legal_mask_many(states)
        pick = torch.rand(legal.shape, generator=g).masked_fill(~legal, -1.0).argmax(-1)
        new, _ = env.step_many(states, pick)
        states = where_state(stop > p, new, states)
        states = where_state(states.terminated, fresh, states)
    return states


def setup(config="puct_two_leaves"):
    env = make_env("brandubh", "cpu")
    mcts = MCTS(env, fake_evaluate(env), MCTSConfig(**CONFIGS[config]))
    states = positions(env)
    return env, mcts, states, env.legal_mask_many(states)


class CountAll(TorchFunctionMode):
    """Counts the ``Tensor.all`` calls (the traversal's one a level), and
    keeps every torch function called while ``open_spans``' innermost span
    is ``mcts/level_sync`` and, for each ``all``, the innermost span."""

    def __init__(self, open_spans):
        super().__init__()
        self.count, self.open_spans = 0, open_spans
        self.in_sync, self.all_in = set(), []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        inner = self.open_spans[-1] if self.open_spans else None
        if func is torch.Tensor.all:
            self.count += 1
            self.all_in.append(inner)
        if inner == "mcts/level_sync":
            self.in_sync.add(func.__name__)
        return func(*args, **(kwargs or {}))


def track_open_spans(monkeypatch):
    """The names of the spans open now, innermost last."""
    open_spans, enter, exit_ = [], profiling._enter, profiling._exit

    def tracked_enter(name, *args):
        open_spans.append(name)
        return enter(name, *args)

    def tracked_exit(handle):
        open_spans.pop()
        return exit_(handle)

    monkeypatch.setattr(profiling, "_enter", tracked_enter)
    monkeypatch.setattr(profiling, "_exit", tracked_exit)
    return open_spans


def traced(fn, tmp_path):
    """``fn()`` under a profile of the host; its result and the program's
    spans as ``(name, start_ns, end_ns)``, from the Chrome trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = []
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            start = round(float(e["ts"]) * 1000)
            spans.append((e["name"], start, start + round(float(e["dur"]) * 1000)))
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def innermost_parent(spans, i):
    """The name of the smallest span that holds span ``i``, or None."""
    _, s, e = spans[i]
    holders = [h for j, h in enumerate(spans) if j != i and h[1] <= s and e <= h[2]]
    return min(holders, key=lambda h: h[2] - h[1])[0] if holders else None


def assert_nested(spans, outermost):
    for i, (name, _, _) in enumerate(spans):
        want = None if name == outermost else PARENT[name]
        assert innermost_parent(spans, i) == want, (name, spans[i])


def names(spans):
    out = {}
    for name, _, _ in spans:
        out[name] = out.get(name, 0) + 1
    return out


def assert_same(a, b):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_span_off_calls_nothing_of_the_profiler(monkeypatch):
    env, mcts, states, legal = setup()
    actor = SelfPlayActor(env, mcts.evaluate, mcts.config, SelfPlayConfig(batch_size=B), "cpu")
    calls = []

    def boom(*args, **kwargs):
        calls.append(args)
        raise AssertionError("the profiler was called with no profiler running")

    monkeypatch.setattr(profiling, "_enter", boom)
    monkeypatch.setattr(profiling, "_exit", boom)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", boom)
    assert profiling.span("mcts/wave") is profiling._OFF
    assert profiling.annotate is profiling.span
    g = torch.Generator().manual_seed(1)
    actor.move(states, torch.ones(B), g)
    replay = ReplayBuffer(env, 64, 8)
    replay.add(np.zeros((3, env.n, env.n), np.int8), np.zeros(3, np.int8), np.zeros(3, np.int8),
               np.full((3, 8), -1, np.int32), np.zeros((3, 8), np.float32),
               np.zeros(3, np.float32))
    assert calls == []
    # The patched entry is the one a span takes while a profiler runs.
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler running"):
            with profiling.span("mcts/wave"):
                pass
    assert len(calls) == 1


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_one_search_emits_its_spans_nested(config, tmp_path, monkeypatch):
    env, mcts, states, legal = setup(config)
    counter = CountAll(track_open_spans(monkeypatch))
    g = torch.Generator().manual_seed(3)

    def search():
        with counter:
            return mcts.search(states, legal, g, add_noise=True)

    _, spans = traced(search, tmp_path)
    cfg = mcts.config
    waves = cfg.num_simulations // cfg.leaves_per_wave
    assert counter.count >= cfg.num_simulations
    assert names(spans) == {
        "mcts/search": 1, "mcts/wave": waves, "mcts/traverse": cfg.num_simulations,
        "mcts/level_sync": counter.count, "mcts/leaf_step": waves, "mcts/evaluate": waves,
        "mcts/expand": waves, "mcts/backup": waves,
    }
    assert_nested(spans, "mcts/search")
    # A sync span holds the read of ``done.all()`` and nothing else.
    assert counter.all_in == ["mcts/level_sync"] * counter.count
    assert counter.in_sync <= {"all", "__bool__"}
    # Each traversal's syncs are the levels it walked, one at least.
    for name, s, e in spans:
        if name == "mcts/traverse":
            assert any(n == "mcts/level_sync" and s <= a and b <= e for n, a, b in spans)


def test_one_move_emits_its_spans_nested(tmp_path):
    env, mcts, states, legal = setup()
    actor = SelfPlayActor(env, mcts.evaluate, mcts.config, SelfPlayConfig(batch_size=B), "cpu")
    g = torch.Generator().manual_seed(4)
    _, spans = traced(lambda: actor.move(states, torch.ones(B), g), tmp_path)
    count = names(spans)
    assert set(count) == SEARCH_SPANS | {"selfplay/move", "selfplay/root_mask", "selfplay/tail"}
    assert [count[n] for n in ("selfplay/move", "selfplay/root_mask", "mcts/search",
                               "selfplay/tail")] == [1, 1, 1, 1]
    assert_nested(spans, "selfplay/move")
    # In the move's order: the root mask, the search, the tail.
    order = [n for n, _, _ in spans if n in ("selfplay/root_mask", "mcts/search", "selfplay/tail")]
    assert order == ["selfplay/root_mask", "mcts/search", "selfplay/tail"]


def test_each_replay_write_is_one_span(tmp_path):
    env = make_env("brandubh", "cpu")
    replay = ReplayBuffer(env, 8, 4)

    def add(m):
        replay.add(np.ones((m, env.n, env.n), np.int8), np.zeros(m, np.int8),
                   np.zeros(m, np.int8), np.zeros((m, 4), np.int32),
                   np.full((m, 4), 0.25, np.float32), np.ones(m, np.float32))

    _, spans = traced(lambda: [add(5), add(6)], tmp_path)
    assert names(spans) == {"replay/add": 2}
    assert replay.write == 3 and replay.size == 8 and replay.total_added == 11


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_search_is_bit_identical_with_the_profiler_on_and_off(config, tmp_path):
    env, mcts, states, legal = setup(config)

    def search():
        g = torch.Generator().manual_seed(11)
        return mcts.search(states, legal, g, add_noise=True)

    off = search()
    on, spans = traced(search, tmp_path)
    assert spans
    assert_same(off, on)


def test_move_is_bit_identical_with_the_profiler_on_and_off(tmp_path):
    env, mcts, states, legal = setup()
    actor = SelfPlayActor(env, mcts.evaluate, mcts.config, SelfPlayConfig(batch_size=B), "cpu")
    temps = (torch.arange(B) % 2).float()

    def move():
        g = torch.Generator().manual_seed(12)
        return actor.move(states, temps, g)

    off = move()
    on, spans = traced(move, tmp_path)
    assert spans
    assert len(off) == 7 and isinstance(off[0], EnvState)
    assert_same(off, on)


def test_move_searches_through_the_replaceable_attribute():
    env, mcts, states, legal = setup()
    actor = SelfPlayActor(env, mcts.evaluate, mcts.config, SelfPlayConfig(batch_size=B), "cpu")
    inner, seen = actor.mcts.search, []

    def search(root_state, root_legal, generator=None, add_noise=True):
        seen.append((root_state, root_legal, generator, add_noise))
        return inner(root_state, root_legal, generator, add_noise)

    actor.mcts.search = search
    g = torch.Generator().manual_seed(5)
    out = actor.move(states, torch.ones(B), g)
    assert len(out) == 7 and len(seen) == 1
    root_state, root_legal, generator, add_noise = seen[0]
    assert root_state is states and generator is g and add_noise is True
    assert torch.equal(root_legal, legal)
