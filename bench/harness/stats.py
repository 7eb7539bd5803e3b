"""Statistics the metric readers share."""
from __future__ import annotations

import statistics
from typing import Optional, Sequence

import numpy as np


def p95(values: Sequence[float]) -> Optional[float]:
    """The 95th percentile (linear between order statistics), None if empty."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95)) if len(values) else None


def median(values: Sequence[float]) -> Optional[float]:
    return float(statistics.median(values)) if len(values) else None
