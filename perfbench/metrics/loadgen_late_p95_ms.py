"""loadgen_late_p95_ms (ms): the 95th percentile, over the chunks of the
traced region, of how late the open-loop generator pushed a chunk after
its scheduled time.  Moves event_p95_ms."""

from harness import readers


def read(obs):
    return readers.counter(obs, "loadgen_late_p95_ms")
