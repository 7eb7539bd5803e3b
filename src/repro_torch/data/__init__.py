"""Synthetic datasets, keyed by (seed, step)."""
