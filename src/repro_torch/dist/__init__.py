"""Distribution: mesh context, sharding rules, gradient compression.

The JAX package's dist/ in PyTorch, data-parallel half:

* ``context``     — ambient compute mesh (``compute_mesh`` / ``current_mesh``).
  It holds either kind of mesh of `launch.mesh`: an in-process `DataMesh`
  (serving: `serve.runners.snn.SNNRunner` and `models.moe.moe_apply`
  split their rows over its ``'data'`` axis) or a `ProcessMesh` over a
  ``torch.distributed`` group (training: `train.train_step` reduces
  gradients over its ``'data'`` axis). Each consumer checks which kind it
  has and ignores the other.
* ``sharding``    — the partitioning rules as pure functions over shapes
  (``param_spec`` / ``param_specs`` with divisibility repair and
  FSDP-experts mode, ``zero1_opt_specs``, ``batch_spec``, ``cache_specs``),
  returning the port's own `sharding.PartitionSpec`, and `to_placements`,
  which maps such a spec on a ``DeviceMesh`` to DTensor placements. Nothing
  applies them yet: laying tensors out over a ``'model'`` axis is the
  tensor-parallel slice's (ROADMAP, queue 1), and ``shard_cotangents``
  raises on such an axis until then.
* ``compression`` — error-feedback int8 gradient compression
  (``quantize_error_feedback``) and the quantized mean all-reduce over a
  process group (``compressed_psum``).

The reference's ``compat`` (shims for older jax) has no counterpart.
"""
from . import compression, context, sharding  # noqa: F401
