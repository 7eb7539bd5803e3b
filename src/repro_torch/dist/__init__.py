"""Distribution: mesh context, sharding rules and layouts, tensor-parallel
collectives, gradient compression.

The JAX package's dist/ in PyTorch:

* ``context``     — ambient compute mesh (``compute_mesh`` / ``current_mesh``).
  It holds either kind of mesh of `launch.mesh`: an in-process `DataMesh`
  (serving: `serve.runners.snn.SNNRunner` and `models.moe.moe_apply`
  split their rows over its ``'data'`` axis) or a `ProcessMesh` over a
  ``torch.distributed`` group (training: `train.train_step` reduces
  gradients over its ``'data'`` axis, and on a ``(data, model)`` mesh the
  model runs tensor-parallel over ``'model'``). Each consumer checks which
  kind it has and ignores the other.
* ``sharding``    — the partitioning rules as pure functions over shapes
  (``param_spec`` / ``param_specs`` with divisibility repair and
  FSDP-experts mode, ``zero1_opt_specs``, ``batch_spec``, ``cache_specs``),
  returning the port's own `sharding.PartitionSpec`; `to_placements` maps
  one onto a ``DeviceMesh`` as DTensor placements, ``place`` /
  ``placements`` lay a parameter or state tree out by them, ``gather``
  undoes it, and ``shard_cotangents`` holds each gradient to its
  parameter's layout.
* ``tensor_parallel`` — the Megatron collectives over the ``'model'`` axis
  (autograd functions, each one ``all_reduce``), the local-shard leaves the
  model computes on, and ``tp_axis``.
* ``compression`` — error-feedback int8 gradient compression
  (``quantize_error_feedback``) and the quantized mean all-reduce over a
  process group (``compressed_psum``).

The reference's ``compat`` (shims for older jax) has no counterpart.
"""
from . import compression, context, sharding, tensor_parallel  # noqa: F401
