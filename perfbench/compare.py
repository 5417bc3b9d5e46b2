"""The comparison that decides ``correct``.

Every window sent in a run is compared: the program's answer against
the plain reference that the configuration names (``"reference"``: a
module ``perfbench/reference/<name>.py``) for the same window of the
same stream, the reference having run each stream's windows in order
from the stream's start on the same weights and inputs.  The reference's
``predict`` returns a tuple whose first item is the answers it wants;
the numbers compared are ``readings(y, *that tuple)`` against
``LIMITS``, each with its limit, both taken from the reference module
where it defines them and from this module where it does not.
Whatever the reference reads, ``unanswered`` (windows with no answer,
or an error for an answer) is counted here and compared with the limit
0.

This module's own numbers are for a reference that returns output codes
and their fractional bits (``qlstm``): the answer is the float
prediction ``StreamServer`` returned, a code of the configuration's
fixed-point format times ``2**-frac``.  The datapath is integer, so the
two must agree exactly; besides ``unanswered``, two numbers are
compared, each with the limit 0:

* ``mismatched``: answered windows whose code differs from the
  reference's;
* ``max_code_gap``: the widest such difference, in codes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

LIMITS = {"unanswered": 0, "mismatched": 0, "max_code_gap": 0}


def unanswered(y: np.ndarray) -> int:
    """Rows of ``y`` with no answer (NaN)."""
    return int(np.count_nonzero(np.isnan(y).any(axis=1)))


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


def answers(codes: np.ndarray, frac: int) -> np.ndarray:
    """Output codes of ``frac`` fractional bits as the float answers the
    program returns (the control's, ``perfbench/control.py``)."""
    return codes * 2.0 ** -frac


def limits(reference) -> Dict:
    """``{name: limit}`` of the numbers compared for ``reference``,
    ``unanswered`` first and at 0."""
    out = {"unanswered": 0, **getattr(reference, "LIMITS", LIMITS)}
    out["unanswered"] = 0
    return out


def read(reference, y: np.ndarray, predicted) -> Dict:
    """The numbers compared, for answers ``y`` against what the
    ``reference``'s ``predict`` returned."""
    got = dict(getattr(reference, "readings", readings)(y, *predicted))
    got["unanswered"] = unanswered(y)
    return got


def check(reference, cfg: Dict, weights, stream, k, x, y,
          device="cpu") -> Dict:
    """``{name: {"value": v, "limit": l}}`` for the run's answers ``y``
    against the ``reference`` module's."""
    got = read(reference, y, reference.predict(cfg, weights, stream, k, x,
                                               device=device))
    return {n: {"value": got[n], "limit": lim}
            for n, lim in limits(reference).items()}
