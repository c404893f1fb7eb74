"""End-to-end runs of the five driver eval configs (BASELINE.json:6-12).

Synthesizes a dataset, runs each config through the public pipeline API, and
prints a per-config summary (items, statuses, wall seconds, items/sec).

Usage:
    python benchmarks/eval_configs.py [--n 64] [--root DIR] [--cpu]

--cpu forces the JAX CPU backend; default uses whatever backend is active.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def make_dataset(root: Path, n: int, seed: int = 0):
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    (root / "imgs").mkdir(parents=True, exist_ok=True)
    (root / "labels").mkdir(exist_ok=True)
    (root / "overlays").mkdir(exist_ok=True)
    for i in range(n):
        h, w = int(rng.integers(300, 700)), int(rng.integers(300, 700))
        Image.fromarray(
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ).save(root / "imgs" / f"im{i:04d}.jpg", quality=92)
        (root / "labels" / f"im{i:04d}.txt").write_text(
            f"{i % 5} 0.5 0.5 0.25 0.25\n{(i + 1) % 5} 0.4 0.6 0.1 0.1\n"
        )
    for i in range(max(4, n // 4)):
        ov = np.zeros((80, 80, 4), np.uint8)
        ov[10:70, 10:70] = [*rng.integers(0, 256, 3), 255]
        Image.fromarray(ov).save(root / "overlays" / f"ov{i:03d}.png")

    # a small video for config 5
    try:
        import cv2

        vid = root / "video"
        vid.mkdir(exist_ok=True)
        wtr = cv2.VideoWriter(
            str(vid / "clip.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10,
            (640, 480),
        )
        for i in range(min(n, 24)):
            frame = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
            wtr.write(frame)
        wtr.release()
    except ImportError:
        pass


def run_configs(root: Path, n: int):
    from image_processor_pipeline_tpu import ProcessingPipeline, ProcessingStep
    from image_processor_pipeline_tpu.transforms import (
        BorderCrop,
        ColorMaskTransparency,
        GenerateSymmetries,
        KeepLargestComponent,
        PasteOverlayOntoBackground,
        RandomRotations,
        SquareCropAroundBBox,
        copy_img_with_labels,
        frame_extraction,
    )

    results = []

    def run(config_name, build):
        pipe = ProcessingPipeline(root_dir=root)
        build(pipe)
        t0 = time.perf_counter()
        counters = pipe.run(progress=False)
        dt = time.perf_counter() - t0
        per_stage = [
            {"step": s.name, **s.metrics.as_dict(),
             "statuses": dict(c)}
            for s, c in zip(pipe.steps, counters)
        ]
        total_items = sum(sum(c.values()) for c in counters)
        results.append({
            "config": config_name,
            "wall_seconds": round(dt, 2),
            "total_items": total_items,
            "items_per_second": round(total_items / dt, 1),
            "stages": per_stage,
        })
        print(f"[{config_name}] {total_items} items in {dt:.1f}s "
              f"({total_items / dt:.1f} items/s)")

    # 1. crop_square + copy
    def cfg1(pipe):
        pipe.add_step(ProcessingStep(
            name="crop", process_function=SquareCropAroundBBox(),
            input_dirs=["imgs", "labels"], output_dirs=["c1/i", "c1/l"],
            pairing_method="zip", seed=1, workers=2))
        pipe.add_step(ProcessingStep(
            name="copy", process_function=copy_img_with_labels,
            output_dirs=["c1f/i", "c1f/l"], pairing_method="zip"))
    run("1:crop_square+copy", cfg1)

    # 2. rotations + symmetry 8-fold dihedral chain
    def cfg2(pipe):
        pipe.add_step(ProcessingStep(
            name="rot", process_function=RandomRotations(),
            input_dirs=["c1/i"], output_dirs=["c2rot"], seed=2, workers=2,
            options={"num_rotations": 3}))
        pipe.add_step(ProcessingStep(
            name="sym", process_function=GenerateSymmetries(),
            output_dirs=["c2sym"], seed=3, workers=2))
    run("2:rotations+symmetry", cfg2)

    # 3. color-mask filter stack + isolated-pixel cleanup
    def cfg3(pipe):
        pipe.add_step(ProcessingStep(
            name="mask", process_function=ColorMaskTransparency(),
            input_dirs=["imgs"], output_dirs=["c3mask"], seed=4, workers=2,
            options={"color_ranges_to_exclude_hsv":
                     [(35, 60, 60, 85, 255, 255),
                      (100, 40, 40, 140, 230, 230)]}))
        pipe.add_step(ProcessingStep(
            name="clean", process_function=KeepLargestComponent(),
            output_dirs=["c3clean"], seed=5, workers=2))
    run("3:filters+cleanup", cfg3)

    # 4. overlay compositing + border-crop fan-out
    def cfg4(pipe):
        pipe.add_step(ProcessingStep(
            name="paste", process_function=PasteOverlayOntoBackground(),
            input_dirs=["overlays", "imgs"],
            output_dirs=["c4/i", "c4/l"],
            pairing_method="modulo", seed=6, workers=2))
        pipe.add_step(ProcessingStep(
            name="recrop", process_function=BorderCrop(),
            input_dirs=["c4/i"], output_dirs=["c4crop"], seed=7, workers=2,
            fixed_input=True,
            options={"crop_margins": (0.05, 0.05, 0.05, 0.05)}))
    run("4:overlays+recadrages", cfg4)

    # 5. video frames → crop/rotate chain
    if (root / "video").exists():
        def cfg5(pipe):
            pipe.add_step(ProcessingStep(
                name="frames", process_function=frame_extraction,
                input_dirs=["video"], output_dirs=["c5frames"],
                options={"file_basename": "clip"}))
        run("5a:frame_extraction", cfg5)

        def cfg5b(pipe):
            from image_processor_pipeline_tpu.transforms.fused import (
                Enhance, Flip, FusedChain, Rotate,
            )
            pipe.add_step(ProcessingStep(
                name="augment",
                process_function=FusedChain([Rotate(), Flip(), Enhance()]),
                input_dirs=["c5frames/clip/0-raw"], output_dirs=["c5aug"],
                seed=8, workers=2))
        run("5b:video→fused chain", cfg5b)

    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--root", type=str, default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    root = Path(args.root) if args.root else Path(tempfile.mkdtemp(
        prefix="ipp_eval_"))
    print(f"dataset root: {root}")
    make_dataset(root, args.n)
    results = run_configs(root, args.n)
    # smoke-run summaries land next to the scratch dataset, not in the repo
    out = root / "eval_results.json"
    out.write_text(json.dumps(results, indent=2))
    print(f"results written to {out}")


if __name__ == "__main__":
    main()
