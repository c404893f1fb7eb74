"""Fused overlay compositing → border crop (eval config 4's pair).

The reference runs them as two disk-materialized stages: overlays.py:138-187
pastes and saves the composite as ``.jpg`` (PIL q75) plus a YOLO label,
then recadrages.py:13-61 re-decodes every composite and saves the
border-cropped image (cv2 q95).  This transform composes them: paste, then
SLICE the borders off the composite view, and encode exactly once.

Semantics tier (why ``auto_fuse`` only rewrites this pair under the
``"rng"`` tier, never the byte tier):

- geometry and labels are BYTE-IDENTICAL to the unfused run: the paste
  draws ride the overlays step's seed tree over the unchanged pairing
  inventory (the fuser copies the step seed), and the standalone border
  crop never touches labels;
- the final PIXELS are not byte-equal: the unfused run's composite goes
  through an intermediate JPEG q75 encode + re-decode before the crop
  re-encodes at q95 — the fused image skips that lossy generation, so
  its q95 file encodes the CLEANER pre-quantization composite.  Strictly
  higher fidelity, same distribution, different bytes.

Per-item statuses coarsen the usual way: one status per (overlay,
background) pair instead of one per stage.  The standalone border crop's
failure modes are replicated per item AFTER the label is written —
margins too large / non-JPG composite name raise, leaving the label on
disk and the image missing, exactly the unfused run's final state.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from image_processor_pipeline_tpu.transforms.overlays import (
    PasteOverlayOntoBackground,
    label_values,
)
from image_processor_pipeline_tpu.transforms.recadrages import BorderCrop
from image_processor_pipeline_tpu.io.images import encode_image
from image_processor_pipeline_tpu.utils.utils import validate_dirs


class OverlaysBorderCrop(PasteOverlayOntoBackground):
    """PasteOverlayOntoBackground ∘ BorderCrop in one step.

    The compute half (paste geometry draws, premultiplied-LANCZOS resize,
    alpha paste — device program and Pillow-exact native twin) is
    inherited unchanged; the border crop is a pure slice applied to the
    composite view at save time, before the SINGLE encode.  Options are
    the union: overlays' ``scale_min``/``scale_max``/``yolo_class_id``
    plus border crop's ``crop_margins`` (fractions < 1 of the side or
    absolute pixels — recadrages.py:7-10 semantics via
    BorderCrop._margins).

    The final image encodes cv2-anchored q95 (the standalone chain's
    LAST stage writes via cv2.imwrite — reference recadrages.py:57),
    named ``{overlay_stem}{background_suffix}``; the label is the
    overlays stage's line, untouched by the crop (the reference border
    crop never renormalizes labels)."""

    def shrink_output(self, out_dev, chunk, options):
        """The inherited hybrid JPEG shrink encodes the UNCROPPED
        composite at the overlays anchor (PIL q75) — wrong on both counts
        for the fused step (cropped content, cv2 q95), so the transport
        is always the pixel fetch here."""
        if not isinstance(out_dev.get("image"), (np.ndarray, list)):
            self.start_host_copy(out_dev)
        return out_dev

    def save_item(
        self,
        out: Dict[str, np.ndarray],
        item: Dict,
        output_dirs: Sequence[Path],
        options: Dict,
    ) -> Optional[List[Path]]:
        img_dir, lbl_dir = validate_dirs(output_dirs, 2)
        ov_path = Path(item["_args"][0])
        bg_path = Path(item["_args"][1])
        if not bool(out["ok"]):
            print(f"[ovlborder] degenerate overlay size for {ov_path.name}")
            return None
        bh, bw = (int(x) for x in item["bg_size"])
        cx, cy, wn, hn = (float(x) for x in label_values(
            out["pos"], out["new_size"], item["bg_size"]))
        cls_id = options.get("yolo_class_id", 0)

        # label first: the unfused overlays stage writes it before the
        # standalone crop can fail, so a margins error must leave it
        lbl_out = Path(lbl_dir) / f"{ov_path.stem}.txt"
        lbl_out.write_text(f"{cls_id} {cx:.6f} {cy:.6f} {wn:.6f} {hn:.6f}")

        # the standalone border crop's per-file gates, replicated on the
        # name the intermediate WOULD have had ({stem}{bg_suffix})
        img_name = f"{ov_path.stem}{bg_path.suffix}"
        if bg_path.suffix.lower() not in (".jpg", ".jpeg"):
            raise ValueError(f"file {img_name} is not a JPG")
        tp, bp, lp, rp = (
            int(x) for x in BorderCrop._margins(options, bh, bw, img_name))

        img_out = Path(img_dir) / img_name
        encode_image(out["image"][tp:bh - bp, lp:bw - rp], img_out)
        return [img_out, lbl_out]
