"""The host's blocking waits on the card per proof in the traced window: the
total time of the port's `device.d2h` (reads of device results) and
`device.h2d` (copies from pageable host memory, which wait for the stream to
drain) spans of models/bulletproofs.py, over the proofs proven there.

The totals are the record's `span_total_s` where the tracer put them, else
the port's `utils.profiling.totals()`: spans are off after the traced trips
and nothing resets them before the readers run.  None where the program has
neither span."""

WAITS = ("device.d2h", "device.h2d")


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
    waits = [totals[name] for name in WAITS if name in totals]
    return sum(waits) * 1e3 / proofs if waits else None
