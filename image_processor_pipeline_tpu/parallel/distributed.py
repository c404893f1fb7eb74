"""Multi-host scaling helpers (SURVEY.md §5.8 / §2.5).

The reference's parallelism ends at one host's process pool
(reference pipeline.py:358-433).  Across hosts, the equivalent is:

  - `initialize_distributed()`: jax.distributed.initialize — the coordinator
    handles job-level control; collectives ride the interconnect.
  - `host_shard()`: deterministic per-host split of a file list — each host
    decodes only the items its addressable devices will consume, mirroring
    "each worker process owns its items" from the reference's pool.
  - `global_counter()`: psum a per-host count over the mesh (the distributed
    version of the reference's status Counter, pipeline.py:290).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Sequence, TypeVar, Union

import jax

T = TypeVar("T")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the multi-host runtime (no-op when single-process).

    Must not touch jax.devices()/process_count() before initializing — that
    would initialize the XLA backend and make jax.distributed.initialize
    illegal.  The already-initialized check reads the distributed client
    state instead.
    """
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        return  # already initialized by the launcher
    if coordinator_address is None and num_processes is None:
        return  # single-host run
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def host_shard(items: Sequence[T],
               process_id: Optional[int] = None,
               process_count: Optional[int] = None) -> List[T]:
    """The contiguous slice of ``items`` this host is responsible for.

    Deterministic given the (sorted) item list, so every host agrees on the
    partition without communication.
    """
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if process_count is None else process_count
    total = len(items)
    base = total // n
    rem = total % n
    start = pid * base + min(pid, rem)
    stop = start + base + (1 if pid < rem else 0)
    return list(items[start:stop])


def merge_host_reports(
    step_name: str,
    report_dir: Union[str, Path],
    n_hosts: Optional[int] = None,
    delete_shards: bool = False,
) -> Path:
    """Merge per-host run reports (<name>.host<pid>.json, written by
    host-sharded steps) into ONE report with the reference's exact schema —
    a bare list of {inputs, outputs, status, error_message} — at the
    reference's path <report_dir>/<name>.json.

    Host p holds items p, p+n, p+2n, ... of the global pairing order
    (ProcessingStep host sharding is modulo over the original index);
    round-robin over the host lists approximates that order.  Exact order
    is NOT guaranteed: the batched engine appends entries in save-completion
    order (like the reference's as_completed harvest, reference
    pipeline.py:404-431), so the merged report is complete and
    schema-exact but positionally unordered.
    """
    import re

    report_dir = Path(report_dir)
    stem = Path(step_name).with_suffix(".json").stem
    pat = re.compile(rf"^{re.escape(stem)}\.host(\d+)\.json$")
    shard_paths = sorted(
        (p for p in report_dir.glob(f"{stem}.host*.json")
         if pat.match(p.name)),
        key=lambda p: int(pat.match(p.name).group(1)),
    )
    if n_hosts is not None and len(shard_paths) != n_hosts:
        raise FileNotFoundError(
            f"expected {n_hosts} host reports for step {step_name!r} in "
            f"{report_dir}, found {len(shard_paths)}: "
            f"{[p.name for p in shard_paths]}"
        )
    if not shard_paths:
        raise FileNotFoundError(
            f"no host reports for step {step_name!r} in {report_dir}"
        )
    shards = [json.loads(p.read_text()) for p in shard_paths]
    merged: List[dict] = []
    i = 0
    while True:
        added = False
        for shard in shards:
            if i < len(shard):
                merged.append(shard[i])
                added = True
        if not added:
            break
        i += 1
    out = report_dir / f"{stem}.json"
    out.write_text(json.dumps(merged, indent=4, ensure_ascii=False))
    if delete_shards:
        for p in shard_paths:
            p.unlink()
    return out


def global_counter(local_count: int, mesh, axis: str = "data"):
    """psum a host-local count across the mesh (replicated result).

    Works single-process (virtual mesh) and multi-process: in the
    multi-process case each host contributes its count on its first
    addressable device of the mesh and the reduction crosses DCN.
    """
    import numpy as np
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    n = mesh.shape[axis]
    if jax.process_count() > 1:
        sharding = NamedSharding(mesh, P(axis))
        local = np.zeros((jax.local_device_count(),), np.int32)
        local[0] = local_count
        arr = jax.make_array_from_process_local_data(sharding, local, (n,))
        out = jax.jit(
            jnp.sum, out_shardings=NamedSharding(mesh, P())
        )(arr)
        return int(out)

    fn = shard_map(
        lambda x: jax.lax.psum(x, axis),
        mesh=mesh,
        in_specs=P(axis),
        out_specs=P(),
    )
    arr = jnp.zeros((n,), jnp.int32).at[0].set(local_count)
    return int(fn(arr)[0])
