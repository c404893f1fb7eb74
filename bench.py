"""Benchmark: the 512 px crop+rotate+flip+mask+enhance chain on one GPU.

    python bench.py [--mode full_reference|shear|gather] [--steps 200]
                    [--repeats 5] [--trace DIR]

Times the jitted ``augment_chain`` on a device-resident batch (8 images of
640x640 cropped to 512x512): each step gets fresh seeds, the window ends
in ``block_until_ready``, compilation is warmed up outside it.  Prints the
card's name and power limit and the device as JAX reports it, then one
JSON line with the median rate over ``--repeats`` windows and its spread.
``--trace DIR`` also records a profiler trace of a few steps and prints
its device-kernel breakdown.  Exits non-zero when JAX finds no GPU.
"""

import argparse
import gzip
import json
import re
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))


INPUT_SIZE = 640
CROP = 512
BATCH = 8


def chain_rate(mode: str, steps: int, repeats: int):
    """Images/s of the jitted chain: a list of ``repeats`` window rates."""
    import jax

    from image_processor_pipeline_tpu.models.chains import (
        AugmentChain,
        augment_chain,
    )

    fn = jax.jit(augment_chain, static_argnums=(3, 4))
    images, xywhn, seeds = (jax.device_put(a) for a in AugmentChain(
        INPUT_SIZE).example_inputs(BATCH))
    for i in range(10):  # compile, then warm the launch path
        out = fn(images, xywhn, seeds + i * BATCH, CROP, mode)
    out.block_until_ready()
    rates = []
    for r in range(repeats):
        t0 = time.perf_counter()
        for i in range(steps):
            out = fn(images, xywhn, seeds + (r * steps + i) * BATCH,
                     CROP, mode)
        out.block_until_ready()
        rates.append(BATCH * steps / (time.perf_counter() - t0))
    return rates


def trace_chain(mode: str, steps: int, log_dir: Path) -> dict:
    """Profile ``steps`` chain calls and reduce the trace to device kernels."""
    import jax

    from image_processor_pipeline_tpu.models.chains import (
        AugmentChain,
        augment_chain,
    )

    fn = jax.jit(augment_chain, static_argnums=(3, 4))
    images, xywhn, seeds = (jax.device_put(a) for a in AugmentChain(
        INPUT_SIZE).example_inputs(BATCH))
    hlo = fn.lower(images, xywhn, seeds, CROP, mode).compile().as_text()
    fn(images, xywhn, seeds, CROP, mode).block_until_ready()
    with jax.profiler.trace(str(log_dir), create_perfetto_trace=True):
        for i in range(steps):
            out = fn(images, xywhn, seeds + i * BATCH, CROP, mode)
        out.block_until_ready()
    return kernel_breakdown(log_dir, steps, kernel_scopes(hlo))


def kernel_scopes(hlo_text: str) -> dict:
    """Kernel name -> the op_name paths of the HLO ops it fuses, read from
    the optimized HLO (a GPU kernel is named after its fusion, with the
    dots of the HLO name turned into underscores)."""
    comp_ops, calls, comp = defaultdict(set), {}, None
    for line in hlo_text.splitlines():
        head = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{$", line)
        if head:
            comp = head.group(1)
            continue
        ops = re.findall(r'op_name="([^"]+)"', line)
        if comp is not None:
            comp_ops[comp].update(ops)
        call = re.match(r"^\s*(?:ROOT )?%?([\w.\-]+) = .*?\bfusion\(.*?"
                        r"calls=%?([\w.\-]+)", line)
        if call:
            calls[call.group(1)] = (call.group(2), set(ops))
    return {name.replace(".", "_"): comp_ops[callee] | own
            for name, (callee, own) in calls.items()}


def kernel_breakdown(log_dir: Path, steps: int, scopes: dict) -> dict:
    """Device kernels per step, their time, and the share of device time
    in kernels that fuse ops of geometry._row_shift's ``shear`` scope."""
    trace, = sorted(Path(log_dir).rglob("*.trace.json.gz"))[-1:]
    events = json.loads(gzip.open(trace).read())["traceEvents"]
    device_pids = {e["pid"] for e in events if e.get("ph") == "M"
                   and e.get("name") == "process_name"
                   and e["args"].get("name", "").startswith("/device:")}
    by_name = defaultdict(lambda: [0, 0.0])
    for e in events:
        if (e.get("ph") == "X" and e.get("pid") in device_pids
                and "memcpy_details" not in e.get("args", {})):
            by_name[e["name"]][0] += 1
            by_name[e["name"]][1] += float(e.get("dur", 0.0))

    def is_shear(name):  # the scope reads "shear" or "vmap(shear)"
        return any(re.search(r"[(/]shear[)/]", op)
                   for op in scopes.get(name, ()))

    total_us = sum(us for _, us in by_name.values())
    shear_us = sum(us for n, (_, us) in by_name.items() if is_shear(n))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    return {
        "trace": str(trace),
        "kernels_per_step": sum(c for c, _ in by_name.values()) / steps,
        "distinct_kernels": len(by_name),
        "device_us_per_step": total_us / steps,
        "shear_kernels": sum(1 for n in by_name if is_shear(n)),
        "shear_share": shear_us / total_us if total_us else 0.0,
        "unattributed": sorted(n for n in by_name if n not in scopes),
        "top": [(n, c // steps, round(us / steps, 2), is_shear(n))
                for n, (c, us) in top],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="full_reference",
                    choices=("full_reference", "shear", "gather"))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--trace", type=Path, default=None,
                    help="also write a profiler trace of 10 steps here")
    args = ap.parse_args()

    from image_processor_pipeline_tpu.utils.device import (
        device_label,
        gpu_card,
        require_gpu,
    )
    from image_processor_pipeline_tpu.utils.profiling import (
        configure_compilation_cache,
    )

    devices = require_gpu()
    configure_compilation_cache()
    card = gpu_card()
    print(f"# card: {card}")
    rates = chain_rate(args.mode, args.steps, args.repeats)
    if args.trace is not None:
        print("# trace:", json.dumps(trace_chain(
            args.mode, 10, args.trace)))
    print(json.dumps({
        "metric": f"images/s, 512 px chain ({args.mode}), "
                  f"B={BATCH}, {INPUT_SIZE}->{CROP}",
        "value": statistics.median(rates),
        "min": min(rates), "max": max(rates),
        "unit": "images/sec",
        "card": card,
        "device": device_label(devices),
    }))


if __name__ == "__main__":
    main()
