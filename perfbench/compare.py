"""The comparison that decides ``correct``.

Every window sent in a run is compared: the program's answer (the float
prediction ``StreamServer`` returned, a code of the configuration's
fixed-point format times ``2**-frac``) against the output code of the
plain reference that the configuration names (``"reference"``: a module
``perfbench/reference/<name>.py`` with ``predict``) for the same window
of the same stream, the reference having run each stream's windows in
order from the zero carry on the same float weights and inputs.  The
datapath is integer, so the two must agree exactly; three numbers are
compared, each with the limit 0:

* ``unanswered``: windows with no answer, or an error for an answer;
* ``mismatched``: answered windows whose code differs from the
  reference's;
* ``max_code_gap``: the widest such difference, in codes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

LIMITS = {"unanswered": 0, "mismatched": 0, "max_code_gap": 0}


def readings(y: np.ndarray, want: np.ndarray, frac: int) -> Dict[str, int]:
    """The three numbers for float answers ``y`` (NaN rows: no answer)
    against the reference's codes ``want`` of ``frac`` fractional bits."""
    answered = ~np.isnan(y).any(axis=1)
    gap = np.abs(y[answered].astype(np.float64) * 2.0 ** frac
                 - want[answered])
    return {"unanswered": int(np.count_nonzero(~answered)),
            "mismatched": int(np.count_nonzero(gap.max(axis=1) > 0))
            if len(gap) else 0,
            "max_code_gap": float(gap.max()) if gap.size else 0.0}


def check(reference, cfg: Dict, weights, stream, k, x, y,
          device="cpu") -> Dict:
    """``{name: {"value": v, "limit": l}}`` for the run's answers ``y``
    against the ``reference`` module's."""
    want, frac = reference.predict(cfg, weights, stream, k, x, device=device)
    got = readings(y, want, frac)
    return {n: {"value": got[n], "limit": LIMITS[n]} for n in LIMITS}
