"""Tile-shape arithmetic shared by the kernel wrappers and the planner."""
from __future__ import annotations


def round_up(x: int, multiple: int = 128) -> int:
    """Smallest multiple of `multiple` >= x (128 by default: the plan's tile)."""
    return ((x + multiple - 1) // multiple) * multiple
