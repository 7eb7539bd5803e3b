"""Pluggable workload runners for the serving engine."""
from .lm import LMRunner
from .snn import SNNRunner

__all__ = ["LMRunner", "SNNRunner"]
