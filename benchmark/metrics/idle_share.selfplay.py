"""Share of the traced moves' host window in which no operation ran on
the card: 1 less the union of the device events' intervals over it."""

import harness


def read(run):
    t = run["trace"]
    if t is None or not t["device"]:
        return None
    lo, hi = t["window"]
    busy = harness.union_seconds([(d[2], d[3]) for d in t["device"]], lo, hi)
    return 100.0 * (1.0 - busy / ((hi - lo) / 1e6))
