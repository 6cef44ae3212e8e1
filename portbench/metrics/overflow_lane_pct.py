"""Share of the treelet dispatch's lanes that overflowed their candidate
lists and re-ran through the wide pass, in %: ``overflow_rays`` over
``dispatch_lanes`` of ``traverse.counts()`` over the traced frames.
None for a program without ``dispatch_lanes`` or a run with no
dispatch."""


def read(r):
    c = r["win"].counts
    lanes = c.get("dispatch_lanes")
    if not lanes or "overflow_rays" not in c:
        return None
    return 100.0 * c["overflow_rays"] / lanes
