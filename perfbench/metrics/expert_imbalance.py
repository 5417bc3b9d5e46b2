"""``expert_imbalance``: how unevenly the router loads the experts over
the traced sub-window: per MoE layer the most-claimed expert's claims
over the mean claims of its experts, averaged over the MoE layers (1 is
even; the server's ``expert_claims`` counters, accumulated on the device
and read at the sub-window's ends).  Nothing where the server counts no
claims, or none were made."""

import numpy as np


def read(run):
    if run.trace is None or not run.trace_counters:
        return None
    a, b = run.trace_counters
    if "expert_claims" not in b:
        return None
    claims = np.asarray(b["expert_claims"], float) \
        - np.asarray(a["expert_claims"], float)
    if claims.size == 0 or claims.sum() <= 0:
        return None
    mean = claims.mean(axis=1)
    return float((claims.max(axis=1)[mean > 0] / mean[mean > 0]).mean())
