"""Ambient compute-mesh context.

Model and training code ask `current_mesh()` whether to split work over a
mesh; launch code installs one for a scope with `compute_mesh(mesh)`.
Without an installed mesh everything runs on one device, which is what the
tests run under. The mesh may be either kind of `launch.mesh`; each
consumer checks which kind it needs (`dist.tensor_parallel.tp_axis`: a
process-group mesh with more than one ``'model'`` rank).

The mesh is a context variable, so code that autograd runs on its own
device thread (a checkpointed period recomputed in the backward on the
card) does not see it: the tensor-parallel blocks take their axis as an
argument instead.
"""
from __future__ import annotations

import contextlib
import contextvars

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_dist_mesh", default=None)


def current_mesh():
    """The mesh installed by the innermost `compute_mesh`, or None."""
    return _MESH.get()


@contextlib.contextmanager
def compute_mesh(mesh):
    """Install `mesh` as the ambient compute mesh for the enclosed scope."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)
