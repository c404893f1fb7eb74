"""End-to-end (decode → transform → encode, files in / files out) wall-clock
benchmark: OUR pipeline vs the ACTUAL reference pipeline on identical inputs.

This is the north-star measurement (BASELINE.json: >50x wall-clock on a
100k-image run).  The reference is imported unmodified from /root/reference
via dependency shims (benchmarks/ref_shim.py) and driven through ITS OWN
ProcessingPipeline orchestrator; ours runs through our public API.  Both
write real files; both run on this host.

Configs benchmarked (reference transforms that actually run — the reference
square-crop always crashes, SURVEY.md §2.7 #1/#2, so it cannot be measured):

  rotations   T2 process_rotations, 10 rotations/image     (the heavy one)
  symmetry    T3 generate_symmetries, all 4 dihedrals
  colormask   T6 process_images_with_color_masks, 2 HSV ranges
  enhance     T7 enhance_image (brightness/contrast/color)
  chain       the headline 4-stage augmentation chain: the reference runs
              rotate → flip → color-mask → enhance as four disk-materialized
              pipeline steps (its architecture, SURVEY.md §1); ours runs ONE
              FusedChain step (decode once → fused device program → encode
              once).  1 output per input on both sides.
  video       BASELINE.json eval config 5: frame extraction streaming into
              the chain — reference: extract → rotate → color-mask →
              enhance (four materializations); ours: extract → ONE
              FusedChain (two).  n counts frames; one clip per interleave
              chunk.

The JSON also records host IO rooflines (native decode / encode rates),
the per-core bound of the host half: e2e/core <= 1 / (1/decode + 1/encode).

Usage:
  python benchmarks/e2e_vs_reference.py [--n 1000] [--configs rotations,...]
      [--platform cpu|cuda] [--skip-reference] [--out PATH]

--platform cpu (default) forces the JAX CPU backend; --platform cuda runs
our leg on the GPU.  Both legs share one process, so compare ratios taken
in one run only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))
sys.path.insert(0, str(Path(__file__).parent))


def make_dataset(root: Path, n: int, seed: int = 0):
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    imgs = root / "imgs"
    imgs.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        h, w = int(rng.integers(300, 700)), int(rng.integers(300, 700))
        Image.fromarray(
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ).save(imgs / f"im{i:05d}.jpg", quality=92)
    return imgs


def make_photo_dataset(root: Path, n: int, seed: int = 5):
    """Photographic-LIKE content (smooth gradients + shapes): ~8-15% DCT
    density at q92 — the regime the sparse coefficient transport and the
    hybrid device decode are built for (the default noise dataset is ~50%
    dense and defeats both)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    imgs = root / "imgs"
    # meta marker (mirrors make_video_dataset): written AFTER generation,
    # so a changed seed/size or an interrupted run regenerates instead of
    # silently reusing a stale cache by file count alone
    meta = f"{n}:{seed}"
    meta_f = root / "imgs.meta"
    if imgs.exists():
        if meta_f.exists() and meta_f.read_text() == meta:
            return imgs  # deterministic content; skip the re-encode
        import shutil

        shutil.rmtree(imgs)
        meta_f.unlink(missing_ok=True)
    imgs.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        h, w = int(rng.integers(300, 700)), int(rng.integers(300, 700))
        gy = np.linspace(0, 255, h)[:, None]
        gx = np.linspace(0, 255, w)[None, :]
        ph = rng.uniform(0, 2 * np.pi)
        f0 = np.stack([
            np.broadcast_to(gy, (h, w)),
            np.broadcast_to(gx, (h, w)),
            127 + 120 * np.sin(2 * np.pi * (gy + gx) / 510 + ph),
        ], axis=-1)
        yy, xx = np.mgrid[0:h, 0:w]
        for _ in range(4):  # a few soft shapes
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            r = int(rng.integers(20, 90))
            m = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
            f0[m] = rng.integers(0, 256, 3)
        Image.fromarray(f0.astype(np.uint8)).save(
            imgs / f"im{i:05d}.jpg", quality=92)
    meta_f.write_text(meta)
    return imgs


def make_rgba_dataset(root: Path, n: int, seed: int = 9):
    """RGBA PNGs for the standalone cleanup config (eval config 3's second
    stage): one dominant alpha blob + isolated speckle components the CCL
    must drop, on noise RGB."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    imgs = root / "imgs"
    meta = f"rgba:{n}:{seed}"
    meta_f = root / "imgs.meta"
    if imgs.exists():
        if meta_f.exists() and meta_f.read_text() == meta:
            return imgs
        import shutil

        shutil.rmtree(imgs)
        meta_f.unlink(missing_ok=True)
    imgs.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        h, w = int(rng.integers(300, 700)), int(rng.integers(300, 700))
        arr = np.zeros((h, w, 4), np.uint8)
        arr[..., :3] = rng.integers(0, 256, (h, w, 3), np.uint8)
        # dominant blob (~1/3 of the image)
        y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
        arr[y0:y0 + h // 3, x0:x0 + w // 3, 3] = 255
        for _ in range(30):  # parasite speckles
            y, x = int(rng.integers(0, h - 4)), int(rng.integers(0, w - 4))
            s = int(rng.integers(1, 4))
            arr[y:y + s, x:x + s, 3] = 255
        Image.fromarray(arr).save(imgs / f"im{i:05d}.png")
    meta_f.write_text(meta)
    return imgs


def make_labels_dataset(root: Path, seed: int = 11):
    """YOLO labels (1-3 center-region boxes) for every image already in
    root/imgs — eval config 1 (crop_square + copy).  Center-region boxes
    guarantee a valid min(H,W)-square placement exists, so neither leg
    errors by construction."""
    import numpy as np

    rng = np.random.default_rng(seed)
    labels = root / "labels"
    imgs = sorted((root / "imgs").iterdir())
    meta = f"labels:{len(imgs)}:{seed}"
    meta_f = root / "labels.meta"
    if labels.exists():
        if meta_f.exists() and meta_f.read_text() == meta:
            return labels
        import shutil

        shutil.rmtree(labels)  # stale files from a previous larger run
        meta_f.unlink(missing_ok=True)
    labels.mkdir(parents=True, exist_ok=True)
    for p in imgs:
        lines = []
        for _ in range(int(rng.integers(1, 4))):
            cx, cy = rng.uniform(0.4, 0.6, 2)
            bw, bh = rng.uniform(0.05, 0.2, 2)
            lines.append(f"{int(rng.integers(0, 5))} {cx:.6f} {cy:.6f} "
                         f"{bw:.6f} {bh:.6f}")
        (labels / f"{p.stem}.txt").write_text("\n".join(lines) + "\n")
    meta_f.write_text(meta)
    return labels


HSV_RANGES = [(35, 60, 60, 85, 255, 255), (100, 40, 40, 140, 230, 230)]
#: eval config 4's border-crop margins (fraction top/bottom, px left/right)
BORDER_MARGINS = (0.08, 0.08, 12, 12)


def make_overlay_dataset(root: Path, n: int, seed: int = 1):
    """RGBA overlay sprites for the overlays config (backgrounds reuse
    the main imgs/ set through modulo pairing)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    ovs = root / "ovs"
    if ovs.exists():
        return ovs
    ovs.mkdir(parents=True)
    for i in range(n):
        h, w = int(rng.integers(24, 90)), int(rng.integers(24, 90))
        arr = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        Image.fromarray(arr).save(ovs / f"ov{i:05d}.png")
    return ovs


def make_video_dataset(root: Path, n_frames: int, n_clips: int = 10,
                       seed: int = 3):
    """Synthesize n_clips mp4s totalling ~n_frames of smooth moving content
    (gradients + a moving disk survive mp4 compression; noise does not)
    for the video config — BASELINE.json eval config 5: video frame
    extraction streaming into the full augmentation chain."""
    import cv2
    import numpy as np

    vids = root / "vids"
    meta = f"{n_frames}:{n_clips}:{seed}"
    # the meta marker lives OUTSIDE vids/ (every video leg enumerates that
    # dir as clips) and is written only AFTER generation completes, so an
    # interrupted run regenerates instead of validating a partial layout
    meta_f = root / "vids.meta"
    if vids.exists():
        if meta_f.exists() and meta_f.read_text() == meta:
            return vids
        import shutil

        shutil.rmtree(vids)  # stale clip layout from a previous run
        meta_f.unlink(missing_ok=True)
        for stale in root.glob("ilv*"):  # chunk roots hardlink old clips
            shutil.rmtree(stale, ignore_errors=True)
    vids.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    per = max(1, (n_frames + n_clips - 1) // n_clips)
    H, W = 480, 640
    gy = np.linspace(0, 255, H, dtype=np.uint8)[:, None]
    gx = np.linspace(0, 255, W, dtype=np.uint8)[None, :]
    yy, xx = np.mgrid[0:H, 0:W]
    for j in range(n_clips):
        w = cv2.VideoWriter(str(vids / f"clip{j:02d}.mp4"),
                            cv2.VideoWriter_fourcc(*"mp4v"), 24, (W, H))
        if not w.isOpened():
            raise RuntimeError("cv2.VideoWriter could not open an mp4v "
                               "encoder on this host")
        cy, cx = rng.integers(100, H - 100), rng.integers(100, W - 100)
        for i in range(per):
            f = np.stack([np.broadcast_to(gy, (H, W)),
                          np.broadcast_to(gx, (H, W)),
                          np.full((H, W), (7 * i + 29 * j) % 256, np.uint8)],
                         axis=-1).astype(np.uint8)
            r2 = (yy - (cy + 3 * i) % H) ** 2 + (xx - (cx + 5 * i) % W) ** 2
            f[r2 < 60 ** 2] = (40 + 9 * j, 200, 90)
            w.write(f[:, :, ::-1])
        w.release()
    meta_f.write_text(meta)
    return vids


def run_reference(config: str, root: Path, mods) -> dict:
    """Drive the reference's own orchestrator (sequential loop, workers=1 —
    this host has ONE core, so the reference's process-pool path would only
    add pickling overhead)."""
    rp = mods["pipeline"]
    config = config.replace("_photo", "")  # dataset variant, same legs
    # the _fused/_autofuse variants change only OUR leg's architecture;
    # the reference runs its own per-stage materialization either way
    config = config.replace("_fused", "").replace("_autofuse", "")
    out = root / f"ref_{config}"
    step_kw = dict(root_dir=str(root), workers=1)
    if config == "rotations":
        step = rp.ProcessingStep(
            "rot", mods["rotations"].process_rotations,
            input_dirs=["imgs"], output_dirs=[str(out)],
            pairing_method="one_input",
            options={"num_rotations": 10}, **step_kw)
    elif config == "symmetry":
        step = rp.ProcessingStep(
            "sym", mods["symmetry"].generate_symmetries,
            input_dirs=["imgs"], output_dirs=[str(out)],
            pairing_method="one_input", **step_kw)
    elif config == "colormask":
        step = rp.ProcessingStep(
            "mask", mods["filtres"].process_images_with_color_masks,
            input_dirs=["imgs"], output_dirs=[str(out)],
            pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **step_kw)
    elif config == "enhance":
        step = rp.ProcessingStep(
            "enh", mods["tranfo"].enhance_image,
            input_dirs=["imgs"], output_dirs=[str(out)],
            pairing_method="sample", **step_kw)
    elif config == "overlays":
        # reference overlays.py:24-187 — PIL LANCZOS resize + alpha paste
        # + YOLO label synthesis per (overlay, background) pair
        step = rp.ProcessingStep(
            "ovl", mods["overlays"].paste_overlay_onto_background,
            input_dirs=["ovs", "imgs"],
            output_dirs=[str(out / "imgs"), str(out / "labels")],
            pairing_method="modulo", **step_kw)
    elif config == "video":
        # BASELINE.json eval config 5: frame extraction (video.py:6-48)
        # streaming into the full chain — the reference materializes the
        # frames dir, then each chain stage re-decodes the previous
        # stage's files.  ONE clip per root (the reference's one_input
        # inventories a single flat dir, and frames land in a per-clip
        # nested dir — the interleave harness gives each chunk one clip).
        clips = sorted((root / "vids").iterdir())
        assert len(clips) == 1, "video config expects one clip per root"
        pipe = rp.ProcessingPipeline(root_dir=str(root))
        pipe.add_step(rp.ProcessingStep(
            "v_ext", mods["video"].frame_extraction,
            input_dirs=["vids"], output_dirs=[str(out) + "_frames"],
            pairing_method="one_input",
            options={"file_basename": "cls"}, **step_kw))
        frame_dirs = [str(Path(str(out) + "_frames") / clips[0].stem
                          / "0-raw")]
        pipe.add_step(rp.ProcessingStep(
            "v_rot", mods["rotations"].process_rotations,
            input_dirs=frame_dirs, output_dirs=[str(out) + "_1rot"],
            pairing_method="one_input",
            options={"num_rotations": 1, "include_original": False},
            **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "v_mask", mods["filtres"].process_images_with_color_masks,
            output_dirs=[str(out) + "_2mask"], pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "v_enh", mods["tranfo"].enhance_image,
            output_dirs=[str(out)], pairing_method="one_input",
            options={"apply_blur": False, "apply_rgb": False}, **step_kw))
        t0 = time.perf_counter()
        pipe.run()
        dt = time.perf_counter() - t0
        produced = sum(1 for _ in out.rglob("*") if _.is_file())
        return {"wall_seconds": dt, "outputs": produced}
    elif config == "cleanup":
        # eval config 3, stage 2 standalone: pixels_isolés.py:8-81
        step = rp.ProcessingStep(
            "clean", mods["pixels"].keep_largest_component,
            input_dirs=["imgs"], output_dirs=[str(out)],
            pairing_method="one_input", **step_kw)
    elif config == "cropsquare":
        # eval config 1: crop_square + copy.  The UNPATCHED reference
        # crashes on every item (SURVEY.md §2.7 #1-#3); this leg runs a
        # minimally patched copy (3 one-line crash fixes, see
        # ref_shim.load_patched_crop_square) and is recorded as such.
        if "crop_square_patched" not in mods:
            import ref_shim

            mods["crop_square_patched"] = ref_shim.load_patched_crop_square()
        cs = mods["crop_square_patched"]
        pipe = rp.ProcessingPipeline(root_dir=str(root))
        pipe.add_step(rp.ProcessingStep(
            "cs_crop", cs.process_square_crop_around_bbox,
            input_dirs=["imgs", "labels"],
            output_dirs=[str(out) + "_1i", str(out) + "_1l"],
            pairing_method="zip", **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "cs_copy", mods["copy"].copy_img_with_labels,
            output_dirs=[str(out / "imgs"), str(out / "labels")],
            pairing_method="zip", **step_kw))
        t0 = time.perf_counter()
        pipe.run()
        dt = time.perf_counter() - t0
        produced = sum(1 for _ in out.rglob("*") if _.is_file())
        return {"wall_seconds": dt, "outputs": produced,
                "note": "reference leg = 3 crash bugs patched "
                        "(ref_shim.load_patched_crop_square)"}
    elif config == "rotsym":
        # eval config 2: rotations -> symmetry, two disk-materialized steps
        pipe = rp.ProcessingPipeline(root_dir=str(root))
        pipe.add_step(rp.ProcessingStep(
            "rs_rot", mods["rotations"].process_rotations,
            input_dirs=["imgs"], output_dirs=[str(out) + "_1rot"],
            pairing_method="one_input",
            options={"num_rotations": 3, "include_original": False},
            **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "rs_sym", mods["symmetry"].generate_symmetries,
            output_dirs=[str(out)], pairing_method="one_input", **step_kw))
        t0 = time.perf_counter()
        pipe.run()
        dt = time.perf_counter() - t0
        produced = sum(1 for _ in out.rglob("*") if _.is_file())
        return {"wall_seconds": dt, "outputs": produced}
    elif config == "maskclean":
        # eval config 3: filtres_liste -> pixels_isolés, two steps
        pipe = rp.ProcessingPipeline(root_dir=str(root))
        pipe.add_step(rp.ProcessingStep(
            "mc_mask", mods["filtres"].process_images_with_color_masks,
            input_dirs=["imgs"], output_dirs=[str(out) + "_1mask"],
            pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "mc_clean", mods["pixels"].keep_largest_component,
            output_dirs=[str(out)], pairing_method="one_input", **step_kw))
        t0 = time.perf_counter()
        pipe.run()
        dt = time.perf_counter() - t0
        produced = sum(1 for _ in out.rglob("*") if _.is_file())
        return {"wall_seconds": dt, "outputs": produced}
    elif config == "rotmaskclean":
        # rotations -> color mask -> cleanup: three disk-materialized
        # steps (rotations.py:88-119 -> filtres_liste.py:41-149 ->
        # pixels_isolés.py:8-81) — the RNG-headed chain shape auto_fuse
        # collapses into ONE RotationsChain step on our side
        pipe = rp.ProcessingPipeline(root_dir=str(root))
        pipe.add_step(rp.ProcessingStep(
            "rmc_rot", mods["rotations"].process_rotations,
            input_dirs=["imgs"], output_dirs=[str(out) + "_1rot"],
            pairing_method="one_input",
            options={"num_rotations": 2}, **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "rmc_mask", mods["filtres"].process_images_with_color_masks,
            output_dirs=[str(out) + "_2mask"], pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "rmc_clean", mods["pixels"].keep_largest_component,
            output_dirs=[str(out)], pairing_method="one_input", **step_kw))
        t0 = time.perf_counter()
        pipe.run()
        dt = time.perf_counter() - t0
        produced = sum(1 for _ in out.rglob("*") if _.is_file())
        return {"wall_seconds": dt, "outputs": produced}
    elif config == "rotmaskcleansym":
        # rotations -> color mask -> cleanup -> symmetries: the dihedral
        # fan-out at the END of a rotations chain — the shape
        # RotationsChainSymmetries collapses to ONE (N+1)xS step on ours
        pipe = rp.ProcessingPipeline(root_dir=str(root))
        pipe.add_step(rp.ProcessingStep(
            "rcs_rot", mods["rotations"].process_rotations,
            input_dirs=["imgs"], output_dirs=[str(out) + "_1rot"],
            pairing_method="one_input",
            options={"num_rotations": 2}, **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "rcs_mask", mods["filtres"].process_images_with_color_masks,
            output_dirs=[str(out) + "_2mask"], pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "rcs_clean", mods["pixels"].keep_largest_component,
            output_dirs=[str(out) + "_3clean"], pairing_method="one_input",
            **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "rcs_sym", mods["symmetry"].generate_symmetries,
            output_dirs=[str(out)], pairing_method="one_input", **step_kw))
        t0 = time.perf_counter()
        pipe.run()
        dt = time.perf_counter() - t0
        produced = sum(1 for _ in out.rglob("*") if _.is_file())
        return {"wall_seconds": dt, "outputs": produced}
    elif config == "rotsymmaskclean":
        # rotations -> symmetries -> color mask -> cleanup: FOUR
        # disk-materialized stages (the deepest all-image chain the
        # reference's transforms compose) — the shape RotSymChain
        # collapses to ONE (N+1)xS fan-out step on our side
        pipe = rp.ProcessingPipeline(root_dir=str(root))
        pipe.add_step(rp.ProcessingStep(
            "rsc_rot", mods["rotations"].process_rotations,
            input_dirs=["imgs"], output_dirs=[str(out) + "_1rot"],
            pairing_method="one_input",
            options={"num_rotations": 2}, **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "rsc_sym", mods["symmetry"].generate_symmetries,
            output_dirs=[str(out) + "_2sym"], pairing_method="one_input",
            **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "rsc_mask", mods["filtres"].process_images_with_color_masks,
            output_dirs=[str(out) + "_3mask"], pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "rsc_clean", mods["pixels"].keep_largest_component,
            output_dirs=[str(out)], pairing_method="one_input", **step_kw))
        t0 = time.perf_counter()
        pipe.run()
        dt = time.perf_counter() - t0
        produced = sum(1 for _ in out.rglob("*") if _.is_file())
        return {"wall_seconds": dt, "outputs": produced}
    elif config == "maskcleansym":
        # color mask -> cleanup -> symmetries: a deterministic chain
        # ENDING in the dihedral fan-out (filtres_liste.py:41-149 ->
        # pixels_isolés.py:8-81 -> symmetry.py:92-134) — the shape
        # ChainSymmetries collapses to ONE step on our side (the chain
        # computes once; flips are zero-copy views at encode)
        pipe = rp.ProcessingPipeline(root_dir=str(root))
        pipe.add_step(rp.ProcessingStep(
            "mcs_mask", mods["filtres"].process_images_with_color_masks,
            input_dirs=["imgs"], output_dirs=[str(out) + "_1mask"],
            pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "mcs_clean", mods["pixels"].keep_largest_component,
            output_dirs=[str(out) + "_2clean"], pairing_method="one_input",
            **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "mcs_sym", mods["symmetry"].generate_symmetries,
            output_dirs=[str(out)], pairing_method="one_input", **step_kw))
        t0 = time.perf_counter()
        pipe.run()
        dt = time.perf_counter() - t0
        produced = sum(1 for _ in out.rglob("*") if _.is_file())
        return {"wall_seconds": dt, "outputs": produced}
    elif config == "symmaskclean":
        # symmetries -> color mask -> cleanup: the dihedral fan-out at
        # the HEAD of a deterministic chain (symmetry.py:92-134 ->
        # filtres_liste.py:41-149 -> pixels_isolés.py:8-81) — the shape
        # SymmetriesChain collapses to ONE draw-free fan-out step on our
        # side.  Needs the RGBA png dataset (the symmetry intermediates
        # keep the input suffix; cleanup requires alpha).
        pipe = rp.ProcessingPipeline(root_dir=str(root))
        pipe.add_step(rp.ProcessingStep(
            "smc_sym", mods["symmetry"].generate_symmetries,
            input_dirs=["imgs"], output_dirs=[str(out) + "_1sym"],
            pairing_method="one_input", **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "smc_mask", mods["filtres"].process_images_with_color_masks,
            output_dirs=[str(out) + "_2mask"], pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "smc_clean", mods["pixels"].keep_largest_component,
            output_dirs=[str(out)], pairing_method="one_input", **step_kw))
        t0 = time.perf_counter()
        pipe.run()
        dt = time.perf_counter() - t0
        produced = sum(1 for _ in out.rglob("*") if _.is_file())
        return {"wall_seconds": dt, "outputs": produced}
    elif config == "symmaskcleansym":
        # symmetries -> mask -> cleanup -> symmetries: the dihedral
        # fan-out at BOTH ends of one deterministic run (symmetry.py:
        # 92-134 bracketing filtres_liste.py:41-149 ->
        # pixels_isolés.py:8-81) — the shape SymmetriesChainSymmetries
        # collapses to ONE S1xS2 fan-out step on our side.  RGBA png
        # dataset (same contract as symmaskclean).
        pipe = rp.ProcessingPipeline(root_dir=str(root))
        pipe.add_step(rp.ProcessingStep(
            "scs_sym", mods["symmetry"].generate_symmetries,
            input_dirs=["imgs"], output_dirs=[str(out) + "_1sym"],
            pairing_method="one_input", **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "scs_mask", mods["filtres"].process_images_with_color_masks,
            output_dirs=[str(out) + "_2mask"], pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "scs_clean", mods["pixels"].keep_largest_component,
            output_dirs=[str(out) + "_3clean"], pairing_method="one_input",
            **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "scs_sym2", mods["symmetry"].generate_symmetries,
            output_dirs=[str(out)], pairing_method="one_input", **step_kw))
        t0 = time.perf_counter()
        pipe.run()
        dt = time.perf_counter() - t0
        produced = sum(1 for _ in out.rglob("*") if _.is_file())
        return {"wall_seconds": dt, "outputs": produced}
    elif config == "ovlborder":
        # eval config 4: overlays compositing -> border crop
        pipe = rp.ProcessingPipeline(root_dir=str(root))
        pipe.add_step(rp.ProcessingStep(
            "ob_ovl", mods["overlays"].paste_overlay_onto_background,
            input_dirs=["ovs", "imgs"],
            output_dirs=[str(out) + "_1i", str(out) + "_1l"],
            pairing_method="modulo", **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "ob_bc", mods["recadrages"].crop_from_border,
            input_dirs=[str(out) + "_1i"], output_dirs=[str(out)],
            pairing_method="one_input", fixed_input=True,
            options={"crop_margins": BORDER_MARGINS}, **step_kw))
        t0 = time.perf_counter()
        pipe.run()
        dt = time.perf_counter() - t0
        produced = sum(1 for _ in out.rglob("*") if _.is_file())
        return {"wall_seconds": dt, "outputs": produced}
    elif config == "chain":
        # the reference's architecture: one disk-materialized step per
        # transform, each stage re-decoding the previous stage's files
        pipe = rp.ProcessingPipeline(root_dir=str(root))
        pipe.add_step(rp.ProcessingStep(
            "c_rot", mods["rotations"].process_rotations,
            input_dirs=["imgs"], output_dirs=[str(out) + "_1rot"],
            pairing_method="one_input",
            options={"num_rotations": 1, "include_original": False},
            **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "c_sym", mods["symmetry"].generate_symmetries,
            output_dirs=[str(out) + "_2sym"], pairing_method="one_input",
            options={"choose_random": 1, "include_original": False},
            **step_kw))
        pipe.add_step(rp.ProcessingStep(
            "c_mask", mods["filtres"].process_images_with_color_masks,
            output_dirs=[str(out) + "_3mask"], pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **step_kw))
        # (no blur for the reference here — OUR fused Enhance still blurs its
        # 30% Bernoulli share, so ours does strictly more work)
        pipe.add_step(rp.ProcessingStep(
            "c_enh", mods["tranfo"].enhance_image,
            output_dirs=[str(out)], pairing_method="one_input",
            options={"apply_blur": False, "apply_rgb": False}, **step_kw))
        t0 = time.perf_counter()
        pipe.run()
        dt = time.perf_counter() - t0
        produced = sum(1 for _ in out.rglob("*") if _.is_file())
        return {"wall_seconds": dt, "outputs": produced}
    else:
        raise ValueError(config)
    pipe = rp.ProcessingPipeline(root_dir=str(root))
    pipe.add_step(step)
    t0 = time.perf_counter()
    pipe.run()
    dt = time.perf_counter() - t0
    produced = sum(1 for _ in out.rglob("*") if _.is_file())
    return {"wall_seconds": dt, "outputs": produced}


def _run_pipe(pipe, out: Path, auto_fuse=False) -> dict:
    """Time a multi-step ours pipeline; metrics from the final step
    actually run (fused runs replace their constituent steps)."""
    t0 = time.perf_counter()
    counters = pipe.run(progress=False, auto_fuse=auto_fuse)
    dt = time.perf_counter() - t0
    produced = sum(1 for _ in out.rglob("*") if _.is_file())
    return {
        "wall_seconds": dt,
        "outputs": produced,
        "statuses": dict(counters[-1]),
        "metrics": pipe.last_run_steps[-1].metrics.as_dict(),
        # per-step rows so multi-step configs account every stage's wall
        # (VERDICT r4 weak #1: recording only the final step's metrics
        # made the other stages invisible in the stored rows)
        "step_metrics": [s.metrics.as_dict() for s in pipe.last_run_steps],
        "steps_run": [s.name for s in pipe.last_run_steps],
    }


def run_ours(config: str, root: Path) -> dict:
    from image_processor_pipeline_tpu import ProcessingPipeline, ProcessingStep
    from image_processor_pipeline_tpu.transforms import (
        ColorMaskTransparency,
        EnhanceImage,
        GenerateSymmetries,
        RandomRotations,
    )

    config = config.replace("_photo", "")  # dataset variant, same legs
    out = root / f"ours_{config}"
    kw = dict(root_dir=root, workers=1, seed=0)
    if config == "rotations":
        step = ProcessingStep(
            "rot", RandomRotations(), input_dirs=["imgs"],
            output_dirs=[str(out)], pairing_method="one_input",
            options={"num_rotations": 10}, **kw)
    elif config == "symmetry":
        step = ProcessingStep(
            "sym", GenerateSymmetries(), input_dirs=["imgs"],
            output_dirs=[str(out)], pairing_method="one_input", **kw)
    elif config == "colormask":
        step = ProcessingStep(
            "mask", ColorMaskTransparency(), input_dirs=["imgs"],
            output_dirs=[str(out)], pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **kw)
    elif config == "enhance":
        step = ProcessingStep(
            "enh", EnhanceImage(), input_dirs=["imgs"],
            output_dirs=[str(out)], pairing_method="sample", **kw)
    elif config == "overlays":
        from image_processor_pipeline_tpu.transforms.overlays import (
            PasteOverlayOntoBackground,
        )

        step = ProcessingStep(
            "ovl", PasteOverlayOntoBackground(),
            input_dirs=["ovs", "imgs"],
            output_dirs=[str(out / "imgs"), str(out / "labels")],
            pairing_method="modulo", **kw)
    elif config == "cleanup":
        from image_processor_pipeline_tpu.transforms import (
            KeepLargestComponent,
        )

        step = ProcessingStep(
            "clean", KeepLargestComponent(), input_dirs=["imgs"],
            output_dirs=[str(out)], pairing_method="one_input", **kw)
    elif config == "cropsquare":
        from image_processor_pipeline_tpu.transforms.copy import (
            copy_img_with_labels,
        )
        from image_processor_pipeline_tpu.transforms.crop_square import (
            SquareCropAroundBBox,
        )

        pipe = ProcessingPipeline(root_dir=root)
        pipe.add_step(ProcessingStep(
            "cs_crop", SquareCropAroundBBox(),
            input_dirs=["imgs", "labels"],
            output_dirs=[str(out) + "_1i", str(out) + "_1l"],
            pairing_method="zip", **kw))
        pipe.add_step(ProcessingStep(
            "cs_copy", copy_img_with_labels,
            output_dirs=[str(out / "imgs"), str(out / "labels")],
            pairing_method="zip", **kw))
        return _run_pipe(pipe, out)
    elif config == "rotsym":
        pipe = ProcessingPipeline(root_dir=root)
        pipe.add_step(ProcessingStep(
            "rs_rot", RandomRotations(), input_dirs=["imgs"],
            output_dirs=[str(out) + "_1rot"], pairing_method="one_input",
            options={"num_rotations": 3, "include_original": False}, **kw))
        pipe.add_step(ProcessingStep(
            "rs_sym", GenerateSymmetries(), output_dirs=[str(out)],
            pairing_method="one_input", **kw))
        return _run_pipe(pipe, out)
    elif config == "rotsym_fused":
        # eval config 2 as ONE fan-out fused step (our architecture):
        # decode once, rotate N times, encode each rotation's symmetries
        # as zero-copy flip views — the reference's (and our 2-step
        # analog's) intermediate encodes + re-decodes disappear.  Same
        # shape auto_fuse produces for the rotsym step pair.
        from image_processor_pipeline_tpu.transforms import (
            RotationsSymmetries,
        )

        step = ProcessingStep(
            "rsf", RotationsSymmetries(), input_dirs=["imgs"],
            output_dirs=[str(out)], pairing_method="one_input",
            options={"num_rotations": 3, "rot_include_original": False},
            **kw)
    elif config == "maskclean":
        from image_processor_pipeline_tpu.transforms import (
            KeepLargestComponent,
        )

        pipe = ProcessingPipeline(root_dir=root)
        pipe.add_step(ProcessingStep(
            "mc_mask", ColorMaskTransparency(), input_dirs=["imgs"],
            output_dirs=[str(out) + "_1mask"], pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **kw))
        pipe.add_step(ProcessingStep(
            "mc_clean", KeepLargestComponent(), output_dirs=[str(out)],
            pairing_method="one_input", **kw))
        return _run_pipe(pipe, out)
    elif config == "maskclean_fused":
        # eval config 3 as ONE fused step (our architecture): colormask +
        # CCL cleanup in a single native chain call per batch — no PNG
        # materialization + re-decode between the stages
        from image_processor_pipeline_tpu.transforms.fused import (
            Cleanup,
            ColorMask,
            FusedChain,
        )

        step = ProcessingStep(
            "mcf", FusedChain([ColorMask(HSV_RANGES), Cleanup()]),
            input_dirs=["imgs"], output_dirs=[str(out)],
            pairing_method="one_input", **kw)
    elif config in ("rotmaskclean", "rotmaskclean_autofuse"):
        # the MIGRATED 3-step reference pipeline (rotations -> mask ->
        # cleanup), 1:1.  The _autofuse variant runs the SAME step list
        # under run(auto_fuse=True): the fuser collapses it into ONE
        # fan-out RotationsChain step, byte-identical (test_fuse.py) —
        # this row measures exactly what a migrated user gains by
        # flipping the flag.
        from image_processor_pipeline_tpu.transforms import (
            KeepLargestComponent,
        )

        pipe = ProcessingPipeline(root_dir=root)
        pipe.add_step(ProcessingStep(
            "rmc_rot", RandomRotations(), input_dirs=["imgs"],
            output_dirs=[str(out) + "_1rot"], pairing_method="one_input",
            options={"num_rotations": 2}, **kw))
        pipe.add_step(ProcessingStep(
            "rmc_mask", ColorMaskTransparency(),
            output_dirs=[str(out) + "_2mask"], pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **kw))
        pipe.add_step(ProcessingStep(
            "rmc_clean", KeepLargestComponent(), output_dirs=[str(out)],
            pairing_method="one_input", **kw))
        return _run_pipe(pipe, out,
                         auto_fuse=config.endswith("_autofuse"))
    elif config in ("rotmaskcleansym", "rotmaskcleansym_autofuse"):
        # the MIGRATED 4-step rot->mask->clean->sym pipeline, 1:1; the
        # _autofuse variant runs the SAME list under auto_fuse=True —
        # the fuser collapses it to ONE (N+1)xS RotationsChainSymmetries
        # step, byte-identical (test_fuse.py TestRotChainSymFusion)
        from image_processor_pipeline_tpu.transforms import (
            GenerateSymmetries,
            KeepLargestComponent,
        )

        pipe = ProcessingPipeline(root_dir=root)
        pipe.add_step(ProcessingStep(
            "rcs_rot", RandomRotations(), input_dirs=["imgs"],
            output_dirs=[str(out) + "_1rot"], pairing_method="one_input",
            options={"num_rotations": 2}, **kw))
        pipe.add_step(ProcessingStep(
            "rcs_mask", ColorMaskTransparency(),
            output_dirs=[str(out) + "_2mask"], pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **kw))
        pipe.add_step(ProcessingStep(
            "rcs_clean", KeepLargestComponent(),
            output_dirs=[str(out) + "_3clean"], pairing_method="one_input",
            **kw))
        pipe.add_step(ProcessingStep(
            "rcs_sym", GenerateSymmetries(), output_dirs=[str(out)],
            pairing_method="one_input", **kw))
        return _run_pipe(pipe, out,
                         auto_fuse=config.endswith("_autofuse"))
    elif config in ("rotsymmaskclean", "rotsymmaskclean_autofuse"):
        # the MIGRATED 4-step rot->sym->mask->clean pipeline, 1:1; the
        # _autofuse variant runs the SAME list under auto_fuse=True —
        # the fuser collapses it to ONE (N+1)xS RotSymChain step,
        # byte-identical (test_fuse.py TestRotSymChainFusion)
        from image_processor_pipeline_tpu.transforms import (
            GenerateSymmetries,
            KeepLargestComponent,
        )

        pipe = ProcessingPipeline(root_dir=root)
        pipe.add_step(ProcessingStep(
            "rsc_rot", RandomRotations(), input_dirs=["imgs"],
            output_dirs=[str(out) + "_1rot"], pairing_method="one_input",
            options={"num_rotations": 2}, **kw))
        pipe.add_step(ProcessingStep(
            "rsc_sym", GenerateSymmetries(),
            output_dirs=[str(out) + "_2sym"], pairing_method="one_input",
            **kw))
        pipe.add_step(ProcessingStep(
            "rsc_mask", ColorMaskTransparency(),
            output_dirs=[str(out) + "_3mask"], pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **kw))
        pipe.add_step(ProcessingStep(
            "rsc_clean", KeepLargestComponent(), output_dirs=[str(out)],
            pairing_method="one_input", **kw))
        return _run_pipe(pipe, out,
                         auto_fuse=config.endswith("_autofuse"))
    elif config in ("maskcleansym", "maskcleansym_autofuse"):
        # the MIGRATED 3-step mask -> cleanup -> symmetries pipeline,
        # 1:1; the _autofuse variant runs the SAME list under
        # auto_fuse=True — the fuser collapses it to ONE ChainSymmetries
        # step, byte-identical (test_fuse.py TestChainSymFusion)
        from image_processor_pipeline_tpu.transforms import (
            GenerateSymmetries,
            KeepLargestComponent,
        )

        pipe = ProcessingPipeline(root_dir=root)
        pipe.add_step(ProcessingStep(
            "mcs_mask", ColorMaskTransparency(), input_dirs=["imgs"],
            output_dirs=[str(out) + "_1mask"], pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **kw))
        pipe.add_step(ProcessingStep(
            "mcs_clean", KeepLargestComponent(),
            output_dirs=[str(out) + "_2clean"], pairing_method="one_input",
            **kw))
        pipe.add_step(ProcessingStep(
            "mcs_sym", GenerateSymmetries(), output_dirs=[str(out)],
            pairing_method="one_input", **kw))
        return _run_pipe(pipe, out,
                         auto_fuse=config.endswith("_autofuse"))
    elif config in ("symmaskclean", "symmaskclean_autofuse"):
        # the MIGRATED 3-step symmetries -> mask -> cleanup pipeline,
        # 1:1 (RGBA png dataset); the _autofuse variant runs the SAME
        # list under auto_fuse=True — the fuser collapses it to ONE
        # draw-free SymmetriesChain fan-out step, byte-identical
        # (test_fuse.py TestSymChainFusion)
        from image_processor_pipeline_tpu.transforms import (
            GenerateSymmetries,
            KeepLargestComponent,
        )

        pipe = ProcessingPipeline(root_dir=root)
        pipe.add_step(ProcessingStep(
            "smc_sym", GenerateSymmetries(), input_dirs=["imgs"],
            output_dirs=[str(out) + "_1sym"], pairing_method="one_input",
            **kw))
        pipe.add_step(ProcessingStep(
            "smc_mask", ColorMaskTransparency(),
            output_dirs=[str(out) + "_2mask"], pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **kw))
        pipe.add_step(ProcessingStep(
            "smc_clean", KeepLargestComponent(), output_dirs=[str(out)],
            pairing_method="one_input", **kw))
        return _run_pipe(pipe, out,
                         auto_fuse=config.endswith("_autofuse"))
    elif config in ("symmaskcleansym", "symmaskcleansym_autofuse"):
        # the MIGRATED 4-step sym -> mask -> cleanup -> sym pipeline,
        # 1:1 (RGBA png dataset); the _autofuse variant runs the SAME
        # list under auto_fuse=True — the fuser collapses it to ONE
        # S1xS2 SymmetriesChainSymmetries fan-out step, byte-identical
        # (test_fuse.py TestSymChainSymFusion, golden A/B in
        # test_reference_ab)
        from image_processor_pipeline_tpu.transforms import (
            GenerateSymmetries,
            KeepLargestComponent,
        )

        pipe = ProcessingPipeline(root_dir=root)
        pipe.add_step(ProcessingStep(
            "scs_sym", GenerateSymmetries(), input_dirs=["imgs"],
            output_dirs=[str(out) + "_1sym"], pairing_method="one_input",
            **kw))
        pipe.add_step(ProcessingStep(
            "scs_mask", ColorMaskTransparency(),
            output_dirs=[str(out) + "_2mask"], pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **kw))
        pipe.add_step(ProcessingStep(
            "scs_clean", KeepLargestComponent(),
            output_dirs=[str(out) + "_3clean"], pairing_method="one_input",
            **kw))
        pipe.add_step(ProcessingStep(
            "scs_sym2", GenerateSymmetries(), output_dirs=[str(out)],
            pairing_method="one_input", **kw))
        return _run_pipe(pipe, out,
                         auto_fuse=config.endswith("_autofuse"))
    elif config in ("ovlborder", "ovlborder_fused"):
        from image_processor_pipeline_tpu.transforms.overlays import (
            PasteOverlayOntoBackground,
        )
        from image_processor_pipeline_tpu.transforms.recadrages import (
            BorderCrop,
        )

        # the MIGRATED eval-config-4 pair; the _fused variant runs the
        # SAME step list under auto_fuse="rng" (the lossy .jpg
        # intermediate makes byte-tier fusion impossible by construction:
        # the fused single-encode image skips one q75 generation —
        # labels/geometry byte-identical, pixels higher-fidelity)
        pipe = ProcessingPipeline(root_dir=root)
        pipe.add_step(ProcessingStep(
            "ob_ovl", PasteOverlayOntoBackground(),
            input_dirs=["ovs", "imgs"],
            output_dirs=[str(out) + "_1i", str(out) + "_1l"],
            pairing_method="modulo", **kw))
        pipe.add_step(ProcessingStep(
            "ob_bc", BorderCrop(), input_dirs=[str(out) + "_1i"],
            output_dirs=[str(out)], pairing_method="one_input",
            fixed_input=True,
            options={"crop_margins": BORDER_MARGINS}, **kw))
        return _run_pipe(
            pipe, out,
            auto_fuse="rng" if config.endswith("_fused") else False)
    elif config == "chain":
        from image_processor_pipeline_tpu.transforms.fused import (
            ColorMask, Enhance, Flip, FusedChain, Rotate,
        )

        import jax

        # device_decode only pays when a device absorbs the IDCT/upsample
        # finish AND the content is sparse in DCT space: on the CPU backend
        # the "device" work shares the host cores and loses to
        # libjpeg-turbo's SIMD, and on THIS harness's synthetic-noise
        # dataset (~50% DCT density at q=92) every item overflows the
        # sparse capacity and pays both the sparse and dense C reads.
        # Opt in with IPP_E2E_DEVICE_DECODE=1 on real-photo datasets.
        dd = (jax.default_backend() != "cpu"
              and os.environ.get("IPP_E2E_DEVICE_DECODE") == "1")
        opts = {"device_decode": True} if dd else {}
        # .jpg output + hybrid device encode (D2H ships sparse quantized
        # coefficients instead of the RGB canvas) — A/B knobs for the
        # PCIe transport rows; IPP_E2E_JPG_OUT alone is the control
        if os.environ.get("IPP_E2E_JPG_OUT") == "1":
            opts["output_suffix"] = ".jpg"
        if os.environ.get("IPP_E2E_DEVICE_ENCODE") == "1":
            opts.update(output_suffix=".jpg", device_encode=True)
        step = ProcessingStep(
            "chain",
            FusedChain([
                Rotate(method="shear"), Flip(), ColorMask(HSV_RANGES),
                Enhance(),
            ]),
            options=opts or None,
            input_dirs=["imgs"], output_dirs=[str(out)],
            pairing_method="one_input", **kw)
    elif config == "video_autofuse":
        # eval config 5 as the MIGRATED 1:1 pipeline (extract -> rotate ->
        # mask -> enhance, four steps exactly like the reference's) run
        # under auto_fuse="rng": the fuser collapses rot->mask->enh into
        # ONE RotationsChain step (the Enhance tail is the rng-tier
        # opt-in — equally distributed, not byte-equal).  Measures what
        # a migrated user gains from the flag alone, next to the
        # hand-written FusedChain "video" row.
        from image_processor_pipeline_tpu.transforms import (
            EnhanceImage as _Enh,
            frame_extraction,
        )

        clips = sorted((root / "vids").iterdir())
        assert len(clips) == 1, "video config expects one clip per root"
        frames_dir = str(Path(str(out) + "_frames") / clips[0].stem
                         / "0-raw")
        pipe = ProcessingPipeline(root_dir=root)
        pipe.add_step(ProcessingStep(
            "v_ext", frame_extraction, input_dirs=["vids"],
            output_dirs=[str(out) + "_frames"], pairing_method="one_input",
            options={"file_basename": "cls"}, **kw))
        pipe.add_step(ProcessingStep(
            "v_rot", RandomRotations(), input_dirs=[frames_dir],
            output_dirs=[str(out) + "_1rot"], pairing_method="one_input",
            options={"num_rotations": 1, "include_original": False}, **kw))
        pipe.add_step(ProcessingStep(
            "v_mask", ColorMaskTransparency(),
            output_dirs=[str(out) + "_2mask"], pairing_method="one_input",
            options={"color_ranges_to_exclude_hsv": HSV_RANGES}, **kw))
        pipe.add_step(ProcessingStep(
            "v_enh", _Enh(), output_dirs=[str(out)],
            pairing_method="one_input", **kw))
        return _run_pipe(pipe, out, auto_fuse="rng")
    elif config == "video":
        # eval config 5, ours: frame extraction (host streaming source)
        # + ONE FusedChain step over the frames — two materializations
        # total vs the reference's four
        from image_processor_pipeline_tpu.transforms import frame_extraction
        from image_processor_pipeline_tpu.transforms.fused import (
            ColorMask, Enhance, FusedChain, Rotate,
        )

        clips = sorted((root / "vids").iterdir())
        assert len(clips) == 1, "video config expects one clip per root"
        pipe = ProcessingPipeline(root_dir=root)
        pipe.add_step(ProcessingStep(
            "v_ext", frame_extraction, input_dirs=["vids"],
            output_dirs=[str(out) + "_frames"], pairing_method="one_input",
            options={"file_basename": "cls"}, **kw))
        pipe.add_step(ProcessingStep(
            "v_chain",
            FusedChain([Rotate(method="shear"), ColorMask(HSV_RANGES),
                        Enhance()]),
            input_dirs=[str(Path(str(out) + "_frames") / clips[0].stem
                            / "0-raw")],
            output_dirs=[str(out)], pairing_method="one_input", **kw))
        t0 = time.perf_counter()
        counters = pipe.run(progress=False)
        dt = time.perf_counter() - t0
        produced = sum(1 for _ in out.rglob("*") if _.is_file())
        return {
            "wall_seconds": dt,
            "outputs": produced,
            "statuses": dict(counters[-1]),
            "metrics": pipe.steps[-1].metrics.as_dict(),
            "step_metrics": [s.metrics.as_dict() for s in pipe.steps],
            "steps_run": [s.name for s in pipe.steps],
        }
    else:
        raise ValueError(config)
    pipe = ProcessingPipeline(root_dir=root)
    pipe.add_step(step)
    t0 = time.perf_counter()
    counters = pipe.run(progress=False)
    dt = time.perf_counter() - t0
    produced = sum(1 for _ in out.rglob("*") if _.is_file())
    return {
        "wall_seconds": dt,
        "outputs": produced,
        "statuses": dict(counters[0]),
        "metrics": pipe.steps[0].metrics.as_dict(),
        "step_metrics": [pipe.steps[0].metrics.as_dict()],
    }


def measure_roofline(root: Path, n_sample: int = 200) -> dict:
    """Host IO rates on this machine: native batch decode of the dataset and
    native PNG/JPEG encode of 512px canvases.  These bound the per-core
    end-to-end rate of a host whose device work runs on an accelerator."""
    import numpy as np

    from image_processor_pipeline_tpu.io import native
    from image_processor_pipeline_tpu.io.images import probe_padded

    if not native.available():
        return {"native": False}
    paths = sorted((root / "imgs").iterdir())[:n_sample]
    # group by canvas like the engine does
    from collections import defaultdict

    groups = defaultdict(list)
    for p in paths:
        meta = probe_padded(p, "RGB")
        if meta:
            groups[meta[2]].append(p)
    t0 = time.perf_counter()
    for canvas, ps in groups.items():
        native.decode_batch(ps, canvas, 3, n_threads=os.cpu_count())
    decode_s = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (512, 512, 4), np.uint8)
    import tempfile as _tf

    with _tf.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        for i in range(64):
            native.encode_png(Path(td) / f"p{i}.png", arr)
        png_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(64):
            native.encode_jpeg(Path(td) / f"j{i}.jpg", arr[..., :3], 95)
        jpg_s = time.perf_counter() - t0
        # entropy-only write (the device_encode host half: the chip did
        # YCbCr/FDCT/quant, the host does jpeg_write_coefficients only) —
        # this is the per-core encode roofline of an accelerator host
        from image_processor_pipeline_tpu.ops import jpeg as djpeg
        import jax.numpy as jnp

        qt = djpeg.quality_qtabs(95)
        cy, cc = djpeg.encode_start(
            jnp.asarray(arr[None]), jnp.asarray([512]), jnp.asarray([512]),
            jnp.asarray(qt), cap_h=512, cap_w=512)
        cy, cc = np.asarray(cy[0]), np.asarray(cc[0])
        t0 = time.perf_counter()
        for i in range(64):
            native.write_jpeg_coefs(Path(td) / f"e{i}.jpg", cy, cc,
                                    512, 512, 95)
        ent_s = time.perf_counter() - t0
    return {
        "native": True,
        "decode_img_per_s": round(len(paths) / decode_s, 1),
        "encode_png512_img_per_s": round(64 / png_s, 1),
        "encode_jpg512_img_per_s": round(64 / jpg_s, 1),
        "entropy_write_jpg512_img_per_s": round(64 / ent_s, 1),
    }


def subset_dir(root: Path, n: int) -> Path:
    """Hardlinked first-n subset of the dataset (per-config sizes)."""
    src = root / "imgs"
    if n >= sum(1 for _ in src.iterdir()):
        return src
    sub = root / f"imgs_{n}"
    if not sub.exists():
        sub.mkdir()
        for p in sorted(src.iterdir())[:n]:
            os.link(p, sub / p.name)
    return sub


def make_interleave_chunks(cfg_root: Path, config: str, k: int) -> list:
    """Split the config's inputs into k contiguous chunk roots (hardlinked)
    plus a small warmup root.  Interleaving ours/reference per chunk makes
    both legs sample the SAME host-speed windows: this VM's effective CPU
    and memory bandwidth swing 3-10x between minutes (measured: the same
    24MB np.stack took 490ms in one window and 6.4ms in the next), so a
    single serialized A-then-B window silently hands whichever leg ran in
    the fast window an unearned ratio."""
    def slice_dir(src: Path, dst: Path, lo: int, hi: int):
        dst.mkdir(parents=True, exist_ok=True)
        for p in sorted(src.iterdir())[lo:hi]:
            if not (dst / p.name).exists():
                os.link(p, dst / p.name)

    if config.startswith("video"):
        # one clip per chunk (make_video_dataset created k clips); the
        # warmup root reuses clip 0 (its outputs land in the warm root)
        roots = []
        for j in range(k):
            r = cfg_root / f"ilv{j}"
            slice_dir(cfg_root / "vids", r / "vids", j, j + 1)
            roots.append(r)
        w = cfg_root / "ilv_warm"
        slice_dir(cfg_root / "vids", w / "vids", 0, 1)
        return [w] + roots

    imgs = sorted((cfg_root / "imgs").iterdir())
    n = len(imgs)
    warm = min(8, n)
    roots = []
    bounds = [int(round(j * n / k)) for j in range(k + 1)]
    for j in range(k):
        r = cfg_root / f"ilv{j}"
        slice_dir(cfg_root / "imgs", r / "imgs", bounds[j], bounds[j + 1])
        if config.startswith(("overlays", "ovlborder")):
            slice_dir(cfg_root / "ovs", r / "ovs", bounds[j], bounds[j + 1])
        if config == "cropsquare":  # stems match, so sorted order aligns
            slice_dir(cfg_root / "labels", r / "labels",
                      bounds[j], bounds[j + 1])
        roots.append(r)
    w = cfg_root / "ilv_warm"
    slice_dir(cfg_root / "imgs", w / "imgs", 0, warm)
    if config.startswith(("overlays", "ovlborder")):
        slice_dir(cfg_root / "ovs", w / "ovs", 0, warm)
    if config == "cropsquare":
        slice_dir(cfg_root / "labels", w / "labels", 0, warm)
    return [w] + roots


def _merge_leg(total: dict, part: dict) -> dict:
    total["wall_seconds"] = total.get("wall_seconds", 0.0) + part["wall_seconds"]
    total["outputs"] = total.get("outputs", 0) + part.get("outputs", 0)
    total.setdefault("chunk_walls", []).append(round(part["wall_seconds"], 3))
    if "statuses" in part:
        st = total.setdefault("statuses", {})
        for kk, v in part["statuses"].items():
            st[kk] = st.get(kk, 0) + v
    if "steps_run" in part:
        total["steps_run"] = part["steps_run"]
    if isinstance(part.get("step_metrics"), list):
        sm = total.setdefault("step_metrics", [])
        for i, m in enumerate(part["step_metrics"]):
            if i >= len(sm):
                sm.append({"name": m.get("name", "")})
            for kk, v in m.items():
                if isinstance(v, (int, float)) and kk != "items_per_second":
                    sm[i][kk] = round(sm[i].get(kk, 0) + v, 3)
    if isinstance(part.get("metrics"), dict):
        # sum the engine's per-phase timers across chunks so a slow leg
        # self-documents which phase (load/device/save) absorbed the time
        m = total.setdefault("metrics", {})
        for kk, v in part["metrics"].items():
            if isinstance(v, (int, float)) and kk != "items_per_second":
                m[kk] = round(m.get(kk, 0) + v, 3)
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument(
        "--configs", type=str,
        default="chain:1000,video:400,rotations:300,symmetry:1000,"
                "colormask:1000,enhance:1000,overlays:1000",
        help="comma list of config[:n_images]")
    ap.add_argument("--platform", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument(
        "--interleave", type=int, default=0, metavar="K",
        help="split each config into K chunks and alternate ours/reference "
             "per chunk (drift-fair measurement; 0 = classic serialized)")
    ap.add_argument("--skip-reference", action="store_true")
    ap.add_argument("--root", type=str, default=None)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", args.platform)
    from image_processor_pipeline_tpu.utils.profiling import (
        configure_compilation_cache,
    )

    configure_compilation_cache()

    import tempfile

    # parse "config[:n]" list
    spec = []
    for tok in args.configs.split(","):
        tok = tok.strip()
        name, _, n_s = tok.partition(":")
        spec.append((name, int(n_s) if n_s else args.n))
    n_max = max(n for _, n in spec)

    root = Path(args.root) if args.root else Path(
        tempfile.mkdtemp(prefix="ipp_e2e_"))
    print(f"dataset root: {root} ({n_max} images)")
    make_dataset(root, n_max)

    out = Path(args.out) if args.out else root / "e2e_results.json"
    # merge with an existing results file so partial reruns (one config,
    # the GPU leg) refresh their entries without dropping the others
    prior_configs = {}
    if out.exists():
        try:
            prior_configs = json.loads(out.read_text()).get("configs", {})
        except (json.JSONDecodeError, OSError):
            pass
    results = {
        "host": {"cpu_count": os.cpu_count(), "platform": args.platform},
        "roofline": measure_roofline(root),
        "configs": prior_configs,
    }
    print("host IO roofline:", results["roofline"])
    out.write_text(json.dumps(results, indent=2))

    for config, n_cfg in spec:
        if config.startswith("video"):
            # the video config has its own dataset (one clip per
            # interleave chunk, frames as the unit of n)
            cfg_root = root / f"v{n_cfg}"
            cfg_root.mkdir(exist_ok=True)
            make_video_dataset(cfg_root, n_cfg,
                               n_clips=max(1, args.interleave))
        elif config.endswith("_photo"):
            # photographic-like dataset (DCT-sparse) — same transform
            # legs as the base config
            cfg_root = root / f"p{n_cfg}"
            cfg_root.mkdir(exist_ok=True)
            make_photo_dataset(cfg_root, n_cfg)
        elif config == "cleanup" or config.startswith("symmaskclean"):
            # RGBA PNGs (the cleanup transform's input contract; the
            # sym-headed chain needs lossless RGBA head inputs)
            cfg_root = root / f"cl{n_cfg}"
            cfg_root.mkdir(exist_ok=True)
            make_rgba_dataset(cfg_root, n_cfg)
        else:
            # expose the per-config subset under the canonical "imgs" name
            # by pointing the runs at a scratch root with hardlinked inputs
            sub = subset_dir(root, n_cfg)
            cfg_root = root if sub.name == "imgs" else root / f"r{n_cfg}"
            if cfg_root != root and not cfg_root.exists():
                cfg_root.mkdir()
                (cfg_root / "imgs").symlink_to(sub)

        # start from the prior entry so a partial rerun (GPU leg, one side)
        # refreshes its field without dropping the other measurements
        if config.startswith(("overlays", "ovlborder")):
            make_overlay_dataset(cfg_root, n_cfg)
        if config == "cropsquare":
            make_labels_dataset(cfg_root)

        entry = dict(results["configs"].get(config, {}))
        entry["n_images"] = n_cfg
        ours_key = "ours_gpu" if args.platform == "cuda" else "ours"
        mods = None
        if not args.skip_reference:
            import ref_shim

            if ref_shim.reference_available():
                mods = ref_shim.load_reference(with_pipeline=True)
        if args.interleave > 1:
            warm_root, *chunk_roots = make_interleave_chunks(
                cfg_root, config, args.interleave)
            print(f"== {config} (n={n_cfg}): interleaved x"
                  f"{len(chunk_roots)} ==", flush=True)
            run_ours(config, warm_root)  # absorb jit/native warmup
            if mods is not None:
                run_reference(config, warm_root, mods)
            ours_total, ref_total = {}, {}
            for j, cr in enumerate(chunk_roots):
                _merge_leg(ours_total, run_ours(config, cr))
                if mods is not None:
                    _merge_leg(ref_total, run_reference(config, cr, mods))
                if mods is not None:
                    print(f"   chunk {j}: ours "
                          f"{ours_total['chunk_walls'][-1]:.1f}s / ref "
                          f"{ref_total['chunk_walls'][-1]:.1f}s", flush=True)
            entry[ours_key] = dict(ours_total, interleave=args.interleave)
            print(f"   {n_cfg / entry[ours_key]['wall_seconds']:.2f} img/s "
                  f"({entry[ours_key]['wall_seconds']:.1f}s)", flush=True)
            if ref_total:
                entry["reference"] = dict(
                    ref_total, interleave=args.interleave)
                print(f"   reference "
                      f"{n_cfg / entry['reference']['wall_seconds']:.2f} "
                      f"img/s ({entry['reference']['wall_seconds']:.1f}s)",
                      flush=True)
                # the host's speed swings at ~10s granularity, faster than
                # a chunk — the median of per-chunk PAIRED ratios (each
                # ours_j/ref_j pair runs back-to-back) is robust to a chunk
                # landing in a slow window, while the summed ratio is not
                ratios = sorted(
                    r / o for o, r in zip(ours_total["chunk_walls"],
                                          ref_total["chunk_walls"]))
                med = ratios[len(ratios) // 2] if len(ratios) % 2 else (
                    ratios[len(ratios) // 2 - 1]
                    + ratios[len(ratios) // 2]) / 2
                entry[f"speedup_median_chunk{'_gpu' if args.platform == 'cuda' else ''}"] = round(med, 2)
                print(f"   median paired-chunk speedup: {med:.2f}x",
                      flush=True)
        else:
            print(f"== {config} (n={n_cfg}): {ours_key} ==", flush=True)
            entry[ours_key] = run_ours(config, cfg_root)
            print(f"   {n_cfg / entry[ours_key]['wall_seconds']:.2f} img/s "
                  f"({entry[ours_key]['wall_seconds']:.1f}s)", flush=True)
            if mods is not None:
                print(f"== {config}: reference ==", flush=True)
                entry["reference"] = run_reference(config, cfg_root, mods)
                print(f"   {n_cfg / entry['reference']['wall_seconds']:.2f} "
                      f"img/s ({entry['reference']['wall_seconds']:.1f}s)",
                      flush=True)
        # per-leg speedup keys (ADVICE r2): a GPU-leg rerun must not
        # overwrite a CPU-based ratio in the merged results file.  Every
        # recorded leg's ratio is refreshed against the current reference
        # entry (measured this run or merged from a prior one).
        if "reference" in entry:
            for ok, sk in (("ours", "speedup"),
                           ("ours_gpu", "speedup_gpu")):
                if ok in entry:
                    entry[sk] = round(
                        entry["reference"]["wall_seconds"]
                        / entry[ok]["wall_seconds"], 2)
            speed_key = ("speedup_gpu"
                         if ours_key == "ours_gpu" else "speedup")
            print(f"   {speed_key}: {entry[speed_key]}x", flush=True)
        results["configs"][config] = entry
        out.write_text(json.dumps(results, indent=2))  # incremental

    print(f"results written to {out}")


if __name__ == "__main__":
    main()
