"""The statistics the metric readers share."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (numpy's linear interpolation between closest
    ranks), None for no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def mean(values: Sequence[float]) -> Optional[float]:
    return float(np.mean(values)) if len(values) else None
