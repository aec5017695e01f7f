"""Host time per proof in the traced window spent enqueueing the device's
work: the self time of the port's `prove` and `verify` spans and of its
device-phase spans (`ENQUEUE_SPANS`, models/bulletproofs.py), summed, over
the proofs proven there.  Self time leaves out the child spans: the host
phases (`tracing.HOST_SPANS`) and the blocking copies (`device.*`), so what
is left is launches, torch's own host work, and the syncs hidden inside
torch ops.

The self times are the record's `span_self_s` where the tracer put them,
else the port's `utils.profiling.self_times()`: spans are off after the
traced trips and nothing resets them before the readers run.  None where the
program has no `prove` or `verify` span."""

ENQUEUE_SPANS = ("prove", "verify", "prove.commit_V", "prove.phase_a", "prove.phase_t",
                 "prove.commit_T", "prove.phase_lr", "prove.ipa_round", "prove.ipa_fold",
                 "prove.ipa_final", "verify.decompress", "verify.device")


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
    spans = _self_times(record)
    if "prove" not in spans and "verify" not in spans:
        return None
    return sum(spans.get(name, 0.0) for name in ENQUEUE_SPANS) * 1e3 / proofs
