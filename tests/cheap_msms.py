"""Stand-ins for the port's generator tables and MSMs: zero tables and the
basepoint.  B rows of BlindBid at n = 2048 on the CPU would take minutes with
the real ones (the tables of 2048 generators alone take about two); with
these the control flow, the spans, the collectives and the host work are the
real ones and the proofs do not verify."""

from __future__ import annotations

import torch

from dusk_blindbidproof_tpu_torch.ops import edwards, msm
from dusk_blindbidproof_tpu_torch.ops.limb import NLIMBS
from dusk_blindbidproof_tpu_torch.utils import curve_host as chost


def fakes() -> dict:
    """name in ops/msm.py -> its stand-in."""
    base = edwards.from_host(chost.RISTRETTO_BASEPOINT)

    def tables(gens_capacity, device):
        z = torch.zeros((1, 1, 1, 1), dtype=torch.int32, device=device)
        return z.expand(2 * gens_capacity + 2, msm.WINDOWS, 4, NLIMBS), None

    def fake_prescaled(table, digits, niels=False, d_max=msm.D_BUCKETS):
        return base.to(digits.device).expand(*digits.shape[:-2], 4, NLIMBS).clone()

    def fake_msm(points, scalars):
        return base.to(scalars.device).expand(*scalars.shape[:-2], 4, NLIMBS).clone()

    return {"pedersen_tables": tables, "pedersen_tables_niels": tables,
            "msm_prescaled": fake_prescaled, "msm": fake_msm}
