"""The port's reads of device values on the host a traced frame: the sum
of its ``host_reads.<site>`` counters (``profiling.host_read``), which
``traverse.counts()`` carries.  None for a program without them."""


def read(r):
    win = r["win"]
    reads = [v for k, v in win.counts.items() if k.startswith("host_reads.")]
    return sum(reads) / win.traced_frames if reads and win.traced_frames \
        else None
