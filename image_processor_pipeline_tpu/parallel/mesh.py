"""Device-mesh parallelism for the batch augmentation engine.

The workload is embarrassingly parallel per image (SURVEY.md §2.5): the
reference's only parallelism is a per-file process pool
(reference pipeline.py:358-433).  The device-mesh equivalent:

  - **data parallelism**: the batch axis sharded over the ``data`` mesh axis
    with shard_map — each chip augments its own sub-batch, zero collectives
    in the steady state;
  - **spatial parallelism** (the within-image analog of TP/SP): image rows
    sharded over the ``model`` mesh axis for the elementwise filter/enhance
    stages via sharding constraints — XLA inserts halo/all-gather collectives
    where an op needs cross-row context;
  - global run statistics (success counters, histogram reductions) via
    ``psum`` over the mesh — replacing the host-side Counter reduction
    (reference pipeline.py:290).

Multi-host scaling: `jax.distributed.initialize` + per-host input shards
(each host decodes the files for its addressable devices), DCN only carries
the job-level sync, ICI carries any collective traffic.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from image_processor_pipeline_tpu.models.chains import augment_chain


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data", "model"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a mesh over the first ``n_devices`` devices.

    Default shape puts everything on ``data`` (pure batch sharding) with a
    trivial ``model`` axis; pass e.g. shape=(4, 2) to shard images spatially
    across pairs of chips as well.  ``devices`` overrides the pool (e.g.
    ``jax.local_devices()`` for an in-process engine mesh — the global
    jax.devices() list starts with process 0's chips, which other
    processes cannot dispatch to).  Asking for more devices than the pool
    holds raises instead of silently truncating.
    """
    pool = list(devices) if devices is not None else jax.devices()
    if n_devices is not None and n_devices > len(pool):
        raise ValueError(
            f"requested {n_devices} devices but only {len(pool)} available"
        )
    devices = pool[: n_devices or len(pool)]
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names)


def shard_batch(fn, mesh: Mesh, axis: str = "data"):
    """shard_map a batched device function over the batch axis.

    Every array argument and result is split on its leading axis across
    ``axis``; the callable runs per-shard with no collectives (the workload
    is per-image independent).
    """
    from jax import shard_map

    spec = P(axis)
    return shard_map(
        fn, mesh=mesh, in_specs=spec, out_specs=spec
    )


def sharded_augment_step(mesh: Mesh, crop: int = 512):
    """The flagship chain as one pjit-compiled multi-chip step.

    Inputs are batch-sharded over ``data``; the post-crop image rows carry a
    ('data', None, 'model', ...) sharding constraint through the elementwise
    stages so a >1 ``model`` axis exercises spatial sharding; per-shard
    success counts are psum-reduced into a replicated global counter —
    the device-side equivalent of the reference's status Counter
    (reference pipeline.py:290).
    """
    from jax import shard_map

    def step(images, xywhn, seeds):
        out = augment_chain(images, xywhn, seeds, crop)
        out = jax.lax.with_sharding_constraint(
            out, NamedSharding(mesh, P("data", "model", None, None))
        )
        count = jnp.sum(jnp.any(out[..., 3] > 0, axis=(1, 2)).astype(jnp.int32))
        return out, count

    in_sharding = NamedSharding(mesh, P("data"))
    return jax.jit(
        step,
        in_shardings=(in_sharding, in_sharding, in_sharding),
    )
