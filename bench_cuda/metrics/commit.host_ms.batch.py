"""The committed values' host time per proof in the traced window: the total
time of the port's spans `prove.commit_V_host` (the prover's commitments
into its transcripts), `verify.commit_V` (the verifier's) and `verify.wV`
(the verifier's weights of the committed values, inside `verify.assemble`)
of models/bulletproofs.py, over the proofs proven there.  Each grows with
the number of committed values, 4 + the list's length a BlindBid proof.

A cut across the accounts, not a fifth disjoint one: `prove.commit_V_host`
and `verify.wV` lie inside `prover.host_ms.batch` (`tracing.HOST_SPANS`),
and `verify.commit_V` is the one host span that no account counts.

The totals are the record's `span_total_s` where the tracer put them, else
the port's `utils.profiling.totals()`: spans are off after the traced trips
and nothing resets them before the readers run.  None where the program has
none of the three spans."""

SPANS = ("prove.commit_V_host", "verify.commit_V", "verify.wV")


def _totals(record) -> dict:
    if "span_total_s" in record:
        return record["span_total_s"]
    try:
        from dusk_blindbidproof_tpu_torch.utils import profiling
    except ImportError:
        return {}
    return profiling.totals()


def read(record):
    proofs = record.get("proofs")
    if not proofs:
        return None
    totals = _totals(record)
    spent = [totals[name] for name in SPANS if name in totals]
    return sum(spent) * 1e3 / proofs if spent else None
