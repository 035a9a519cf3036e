"""Share of the card's idle time in the traced moves that falls while the
host walks the search trees: the seconds of the ``bench/traced`` region in
which no device event ran (the complement of the union of its kernels,
copies and sets, as ``harness.union_seconds`` and ``harness.breakdown``
take it) that overlap the union of the program's ``mcts/traverse`` spans,
over all of the region's idle seconds. None where the program has no such
spans, or the card never idled."""


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(run):
    t = run["trace"]
    if t is None:
        return None
    lo, hi = t["window"]
    walks = _merged((max(s, lo), min(e, hi)) for name, s, e in t.get("host", ())
                    if name == "mcts/traverse" and e > lo and s < hi)
    if not walks:
        return None
    busy = _merged((max(d[2], lo), min(d[3], hi)) for d in t["device"] if d[3] > lo and d[2] < hi)
    idle, reach = [], lo
    for s, e in busy:
        if s > reach:
            idle.append((reach, s))
        reach = max(reach, e)
    if reach < hi:
        idle.append((reach, hi))
    idle_total = sum(e - s for s, e in idle)
    if idle_total <= 0:
        return None
    overlap, i = 0.0, 0
    for s, e in idle:
        while i < len(walks) and walks[i][1] <= s:
            i += 1
        j = i
        while j < len(walks) and walks[j][0] < e:
            overlap += min(e, walks[j][1]) - max(s, walks[j][0])
            j += 1
    return 100.0 * overlap / idle_total
