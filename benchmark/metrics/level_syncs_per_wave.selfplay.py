"""Host syncs of the search a wave in the traced moves: the program's
``mcts/level_sync`` spans (one for each level a traversal walked, around
its read of ``done.all()``) over its ``mcts/wave`` spans, both counted in
the ``bench/traced`` region. None where the program has no such spans."""


def read(run):
    t = run["trace"]
    if t is None:
        return None
    lo, hi = t["window"]
    inside = [name for name, s, e in t.get("host", ()) if lo <= s and e <= hi]
    waves = inside.count("mcts/wave")
    if not waves:
        return None
    return inside.count("mcts/level_sync") / waves
