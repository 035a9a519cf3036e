"""Share of the search's waves that the host spent in its per-level syncs
in the traced moves: the summed durations of the program's
``mcts/level_sync`` spans over those of its ``mcts/wave`` spans, both in
the ``bench/traced`` region. The trace slows the host, so the card has
often caught up by the time a sync is read. None where the program has no
such spans."""


def read(run):
    t = run["trace"]
    if t is None:
        return None
    lo, hi = t["window"]
    waves = syncs = 0.0
    n_waves = 0
    for name, s, e in t.get("host", ()):
        if not (lo <= s and e <= hi):
            continue
        if name == "mcts/wave":
            waves += e - s
            n_waves += 1
        elif name == "mcts/level_sync":
            syncs += e - s
    if not n_waves or waves <= 0:
        return None
    return 100.0 * syncs / waves
