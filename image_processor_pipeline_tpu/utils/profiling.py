"""Tracing / profiling / metrics (SURVEY.md §5.1, §5.5).

The reference's only observability is tqdm items/sec and print lines
(reference pipeline.py:316-321, 300-302).  Here:

  - StageMetrics: structured per-stage wall-clock, item counts, items/sec,
    device vs host time split — attached to every ProcessingStep run and
    included in the JSON run report.
  - device_trace(): context manager around jax.profiler.trace for XPlane
    traces viewable in TensorBoard/Perfetto.
  - Timer: tiny scoped wall-clock helper.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional


@dataclass
class StageMetrics:
    name: str = ""
    items: int = 0
    wall_seconds: float = 0.0
    host_load_seconds: float = 0.0
    device_seconds: float = 0.0
    host_save_seconds: float = 0.0
    batches: int = 0
    compiles: int = 0
    output_collisions: int = 0
    #: device→host bytes: full-canvas size vs actually fetched after the
    #: shrink_output hook (0/0 when the transform doesn't shrink)
    d2h_bytes_full: int = 0
    d2h_bytes_fetched: int = 0
    #: items whose pixels were decoded on the device (coefficient H2D)
    device_decoded: int = 0

    @property
    def items_per_second(self) -> float:
        return self.items / self.wall_seconds if self.wall_seconds > 0 else 0.0

    def as_dict(self) -> Dict:
        return {
            "name": self.name,
            "items": self.items,
            "wall_seconds": round(self.wall_seconds, 4),
            "items_per_second": round(self.items_per_second, 2),
            "host_load_seconds": round(self.host_load_seconds, 4),
            "device_seconds": round(self.device_seconds, 4),
            "host_save_seconds": round(self.host_save_seconds, 4),
            "batches": self.batches,
            "output_collisions": self.output_collisions,
            "d2h_bytes_full": self.d2h_bytes_full,
            "d2h_bytes_fetched": self.d2h_bytes_fetched,
            "device_decoded": self.device_decoded,
        }


class Timer:
    """Scoped wall-clock accumulator: ``with timer.measure('load'): ...``"""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def measure(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[key] = self.totals.get(key, 0.0) + (
                time.perf_counter() - t0
            )


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """jax.profiler trace when ``log_dir`` is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(str(log_dir)):
        yield


#: the checkout the package runs from (pyproject.toml beside the package)
_CHECKOUT = Path(__file__).resolve().parents[2]
#: the compile cache's home when nothing else names one: one fixed
#: directory inside the checkout, so every process of this checkout finds
#: what the others compiled
DEFAULT_CACHE_DIR = _CHECKOUT / ".jax_cache"


def configure_compilation_cache() -> None:
    """Persist compiled accelerator programs across processes.

    Called once by the entry points (the CLI's ``run``, bench.py,
    chip_smoke.py, the e2e harness) before their first compile.  Sets
    DEFAULT_CACHE_DIR unless a directory is already chosen — through
    ``JAX_COMPILATION_CACHE_DIR``, which JAX reads itself, or through
    ``jax.config`` by an embedding application — or the package is
    installed outside a checkout, or JAX runs on the CPU (XLA:CPU compiles
    are cheap and its cached code is tied to the host's CPU features).
    Repeat runs then skip compilation, which matters most where the
    canvas-bucket fan-out compiles many program variants.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    if (jax.config.jax_compilation_cache_dir
            or not (_CHECKOUT / "pyproject.toml").is_file()
            or jax.default_backend() == "cpu"):
        return
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
