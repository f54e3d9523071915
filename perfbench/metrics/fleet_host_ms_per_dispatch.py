"""fleet_host_ms_per_dispatch (ms): the fleet engine's host time
(HostProfile's ingest, due_select, gather, retire and journal totals, with
FleetConfig.profile_host on in the traced run) over the dispatches of the
traced region.  Moves serve_windows_per_s."""

from harness import readers


def read(obs):
    return readers.counter(obs, "fleet_host_ms_per_dispatch")
