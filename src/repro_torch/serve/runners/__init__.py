"""Workload runners for the serving engine (the SNN runner in this slice)."""
from .snn import SNNRunner

__all__ = ["SNNRunner"]
