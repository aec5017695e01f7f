"""The least time of a hand-written kernel's call, from the work its operands
define: rows multiplied, points added or doubled, items scanned.

A call is counted by what it computes, not by the kernel that computes it
today, so a later kernel change leaves the count right.  Each input byte is
read once and each output byte written once; operations are int32
operations.  The least time is the larger of bytes over the card's memory
bandwidth and operations over its int32 rate.

Peaks of one H100 SXM at 700 W: 3.35 TB/s of HBM3 (the data sheet), and
33.5 T int32 operations a second, derived and not a data-sheet figure: 132
SMs at 1.98 GHz with 64 IMAD lanes an SM and clock (half the 128 FFMA lanes
behind the sheet's 67 T float32 rate), a multiply-add counted as two
operations.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_INT32_OPS = 33.5e12
NLIMBS = 21
FE_BYTES = 4 * NLIMBS
# a 256 x 256-bit field product: 8 x 8 wide (32 x 32 -> 64) multiply-adds and
# 8 more to fold at 2^255 = 19, four int32 operations each; a square needs
# each cross product once
OPS_PER_FIELD_MUL = 4 * (8 * 8 + 8)
OPS_PER_FIELD_SQR = 4 * (8 * 9 // 2 + 8)
# extended point addition: 9 products; doubling: 4 squares and 3 products,
# and 1 product more where T of the result is needed
OPS_PER_ADD = 9 * OPS_PER_FIELD_MUL
OPS_PER_DOUBLE_XYZ = 4 * OPS_PER_FIELD_SQR + 3 * OPS_PER_FIELD_MUL
OPS_PER_DOUBLE = OPS_PER_DOUBLE_XYZ + OPS_PER_FIELD_MUL
# rows a point brings: an addition reads two points and writes one; a
# doubling reads X, Y, Z and writes a point
ADD_BYTES = (4 + 4 + 4) * FE_BYTES
DOUBLE_BYTES = (3 + 4) * FE_BYTES
# the scans: rows a scanned item brings (an affine-Niels item three), rows of
# prefixes written per item, products per step
SCAN_ITEM_ROWS = {"madd_scan": 3, "add_scan": 4, "add_total": 4}
SCAN_PREFIX_ROWS = {"madd_scan": 4, "add_scan": 4, "add_total": 0}
SCAN_FIELD_MULS = {"madd_scan": 7, "add_scan": 9, "add_total": 9}

WRAPPERS = ("mul_rows", "sqr_chain", "add", "double", "double_chain", "madd_scan",
            "add_scan", "add_total")


def _numel(x) -> int:
    n = 1
    for d in x.shape:
        n *= d
    return n


def work(wrapper: str, args) -> tuple[float, float]:
    """(bytes, int32 operations) of one call of an ops/fused.py wrapper."""
    if wrapper == "mul_rows":
        _ctx, a, b = args
        rows = _numel(a) // NLIMBS
        if a is b:
            return rows * 2 * FE_BYTES, rows * OPS_PER_FIELD_SQR
        return rows * 3 * FE_BYTES, rows * OPS_PER_FIELD_MUL
    if wrapper == "sqr_chain":
        _ctx, x, k = args
        rows = _numel(x) // NLIMBS
        return rows * 2 * FE_BYTES, rows * k * OPS_PER_FIELD_SQR
    points = _numel(args[0]) // (4 * NLIMBS)
    if wrapper == "add":
        return points * ADD_BYTES, points * OPS_PER_ADD
    if wrapper == "double":
        return points * DOUBLE_BYTES, points * OPS_PER_DOUBLE
    if wrapper == "double_chain":
        _p, windows, steps = args
        return (points * (1 + windows) * 4 * FE_BYTES,
                points * (windows - 1) * (steps * OPS_PER_DOUBLE_XYZ + OPS_PER_FIELD_MUL))
    if wrapper in SCAN_ITEM_ROWS:
        R = args[1]
        blocks = points // R
        rows = points * (SCAN_ITEM_ROWS[wrapper] + SCAN_PREFIX_ROWS[wrapper]) + blocks * 4
        return rows * FE_BYTES, points * SCAN_FIELD_MULS[wrapper] * OPS_PER_FIELD_MUL
    raise ValueError(f"no count for {wrapper}")


def least_seconds(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / PEAK_BYTES, n_ops / PEAK_INT32_OPS)
