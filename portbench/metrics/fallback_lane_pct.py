"""Share of the treelet dispatch's lanes whose wave was sent to the
treelet walk, in %: ``fallback_lanes`` over ``dispatch_lanes`` of
``traverse.counts()`` over the traced frames.  None for a program
without these counters or a run with no dispatch."""


def read(r):
    c = r["win"].counts
    lanes = c.get("dispatch_lanes")
    if not lanes or "fallback_lanes" not in c:
        return None
    return 100.0 * c["fallback_lanes"] / lanes
