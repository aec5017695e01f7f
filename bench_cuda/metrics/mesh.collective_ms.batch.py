"""Rank 0's time in the mesh's collectives per proof in the traced window:
the total time of the port's `mesh.gather` (`gather_rows`) and
`mesh.broadcast` (`broadcast_object`) spans of parallel/mesh.py, over the
proofs proven there.  A collective's time holds its wait for the slowest
rank.

The totals are the record's `span_total_s`, where the mesh driver puts rank
0's; the harness's own process runs no rank, so nothing else is read.  None
where the record has neither span (a port without them)."""

COLLECTIVES = ("mesh.gather", "mesh.broadcast")


def read(record):
    proofs = record.get("proofs")
    totals = record.get("span_total_s", {})
    found = [totals[name] for name in COLLECTIVES if name in totals]
    return sum(found) * 1e3 / proofs if proofs and found else None
