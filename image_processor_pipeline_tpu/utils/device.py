"""The accelerator a measurement runs on: a hard check and its label.

Every number the GPU scripts print (bench.py, chip_smoke.py) is labelled
with the card's name and power limit, and a script that finds no GPU
fails instead of timing the CPU backend.
"""

from __future__ import annotations

import subprocess


def require_gpu():
    """Return ``jax.devices()`` when JAX runs on a GPU; raise otherwise."""
    import jax

    backend = jax.default_backend()
    devices = jax.devices()
    if backend != "gpu" or devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX backend is {backend!r} "
            f"({len(devices)} x {devices[0].platform})")
    return devices


def device_label(devices) -> dict:
    """The device as JAX reports it: platform, kind and count."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def gpu_card() -> str:
    """The card's name and power limit as nvidia-smi reports them
    (one line per card), or a note saying why it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip()
