"""fleet_queue_wait_p95_ms (ms): the 95th percentile of the fleet's
queue_wait histogram (enqueue to batch assembly) over its trailing
samples when the traced region closes.  Moves event_p95_ms."""

from harness import readers


def read(obs):
    return readers.counter(obs, "fleet_queue_wait_p95_ms")
