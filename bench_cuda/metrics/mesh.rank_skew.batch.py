"""How far the slowest rank's own work lies above the ranks' mean in the
traced window: each rank's traced trip seconds (`rank_trip_s`) less its
seconds in the port's `mesh.*` spans (`rank_mesh_s`), both in rank order
from the mesh driver, as (max - mean) / mean x 100.  A rank's wait for the
others lies in its collectives, so what is left is its own work.

None where the record lacks either list, or a rank recorded no `mesh.*` span
(a port without them)."""


def read(record):
    trips, spent = record.get("rank_trip_s"), record.get("rank_mesh_s")
    if not trips or not spent or len(trips) != len(spent) or None in spent:
        return None
    work = [t - s for t, s in zip(trips, spent)]
    mean = sum(work) / len(work)
    return 100.0 * (max(work) - mean) / mean if mean > 0 else None
