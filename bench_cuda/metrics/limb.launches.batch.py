"""Device operations of every kind (kernels, copies, sets) in the traced
window's profiler trace, per proof proven there."""


def read(record):
    proofs = record["proofs"]
    return record["device_events"] / proofs if proofs and record["device_events"] else None
