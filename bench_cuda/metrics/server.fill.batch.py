"""The daemon's fill in the traced window: the requests its passes were
given over the passes run, from the port's counters `server.requests` and
`server.passes` (`BatchingService`, server.py), which the served driver
puts in the record as `program_counters`.  None where the record has no
such counters (a port without them) or no pass."""


def read(record):
    counters = record.get("program_counters") or {}
    passes = counters.get("server.passes")
    if not passes or "server.requests" not in counters:
        return None
    return counters["server.requests"] / passes
