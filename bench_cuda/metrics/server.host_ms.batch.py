"""The event loop's own host time per proof in the traced window: the total
time of the port's spans `server.decode` (a request frame parsed, its list's
length checked) and `server.encode` (the answer's frame) of server.py, from
the record's `span_total_s`, over the sessions served in the traced passes
(a session, one prove and one verify, counts as one proof).  None where the
record has neither span (a port without them) or no proof."""

SPANS = ("server.decode", "server.encode")


def read(record):
    proofs = record.get("proofs")
    totals = record.get("span_total_s") or {}
    spent = [totals[name] for name in SPANS if name in totals]
    return sum(spent) * 1e3 / proofs if proofs and spent else None
