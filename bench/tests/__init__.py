"""CPU tests of the benchmark (collected by a bare `python -m pytest` at the root)."""
