"""Host-only span time per proof in the traced window: the port's spans of
the transcript, the blinding draws, the compression and the verifier's
assembly (`tracing.HOST_SPANS`), summed, over the proofs proven there."""


def read(record):
    proofs = record["proofs"]
    return record["host_span_s"] * 1e3 / proofs if proofs else None
