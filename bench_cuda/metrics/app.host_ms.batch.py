"""Application-layer host time per proof in the traced window: the self time
of the port's `app.*` spans (models/blindbid.py: the batch entry points, the
circuit, the blinding draws, the witness, its packing into limbs and the
public inputs), summed, over the proofs proven there.

The self times are the record's `span_self_s` where the tracer put them,
else the port's `utils.profiling.self_times()`: spans are off after the
traced trips and nothing resets them before the readers run.  None where
the program has no `app.*` span (the chain cell, or a port without them)."""


def _self_times(record) -> dict:
    if "span_self_s" in record:
        return record["span_self_s"]
    try:
        from dusk_blindbidproof_tpu_torch.utils import profiling
    except ImportError:
        return {}
    return profiling.self_times() if hasattr(profiling, "self_times") else {}


def read(record):
    proofs = record.get("proofs")
    if not proofs:
        return None
    app = [s for name, s in _self_times(record).items() if name.startswith("app.")]
    return sum(app) * 1e3 / proofs if app else None
