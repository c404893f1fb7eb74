"""Border crop and fit-crop — batched device transforms.

Behavior parity:
  - crop_from_border (reference recadrages.py:13-61): margins given as
    fractions (< 1) of the side or absolute pixels (>= 1), computed per side
    (recadrages.py:7-10); JPG-only gate; errors on over-large margins;
    output keeps the input name in output_dirs[0].
  - fit_crop (reference recadrages.py:63-82): PIL getbbox tight crop
    (whole image when empty); same-name output.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import jax

from image_processor_pipeline_tpu.transforms.base import BatchTransform
from image_processor_pipeline_tpu.ops import geometry
from image_processor_pipeline_tpu.io.images import (
    decode_image,
    encode_image,
    encode_image_pil,
)
from image_processor_pipeline_tpu.io.batching import canvas_for, pad_to_canvas


def compute_crop_px(value, total_length: int) -> int:
    """Fraction (< 1) of the side, or absolute pixels (>= 1).

    Parity: reference recadrages.py:7-10 (_compute_crop).
    """
    if value < 0:
        raise ValueError("crop margins cannot be negative")
    return int(total_length * value) if 0 <= value < 1 else int(value)


class BorderCrop(BatchTransform):
    max_batch = 32

    @staticmethod
    def _margins(options: Dict, h: int, w: int, name: str) -> np.ndarray:
        """Per-side margin pixels + validity checks — the ONE place the
        fraction-vs-pixels semantics live, shared by load_item and
        probe_item so probed and fallback items can never diverge."""
        top, bottom, left, right = options.get("crop_margins", (0, 0, 0, 0))
        tp = compute_crop_px(top, h)
        bp = compute_crop_px(bottom, h)
        lp = compute_crop_px(left, w)
        rp = compute_crop_px(right, w)
        if tp + bp >= h or lp + rp >= w:
            raise ValueError(f"crop margins too large for image {name}")
        return np.asarray([tp, bp, lp, rp], np.int32)

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        path = Path(inputs[0])
        if path.suffix.lower() not in (".jpg", ".jpeg"):
            raise ValueError(f"file {path.name} is not a JPG")
        arr = decode_image(path)
        h, w = arr.shape[:2]
        margins = self._margins(options, h, w, path.name)
        canvas = canvas_for(h, w)
        return {
            "canvas": canvas,
            "image": pad_to_canvas(arr, canvas),
            "size": np.asarray([h, w], np.int32),
            "margins": margins,
        }

    def probe_item(self, inputs: Tuple, options: Dict):
        """Metadata-only load: whole buckets decode with ONE native batch
        call.  Only band-safe 3-component JPEGs take this path (pixel-
        identical to load_item's decode); others fall back per-item."""
        from image_processor_pipeline_tpu.io import native

        path = Path(inputs[0])
        if path.suffix.lower() not in (".jpg", ".jpeg"):
            raise ValueError(f"file {path.name} is not a JPG")
        meta = native.probe_bands(path)
        if meta is None or meta[2] != 3:
            return None
        h, w, _ = meta
        margins = self._margins(options, h, w, path.name)
        canvas = canvas_for(h, w)
        return {
            "canvas": canvas,
            "size": np.asarray([h, w], np.int32),
            "margins": margins,
            "_nch": 3,
            "_decode": (str(path), "RGB", False),
        }

    def bucket_key(self, item: Dict, options: Dict) -> Tuple:
        nch = item["image"].shape[-1] if "image" in item else item["_nch"]
        return (*item["canvas"], nch)

    def device_fn(self, batch, static):
        def one(img, size, m):
            out, ch, cw = geometry.border_crop(
                img, size[0], size[1], m[0], m[1], m[2], m[3]
            )
            return {"image": out, "ch": ch, "cw": cw}

        return jax.vmap(one)(batch["image"], batch["size"], batch["margins"])

    def native_fn(self, batch, static, options, n_threads=1):
        """Host fast path: a border crop is a pure slice — zero-copy numpy
        views of the batch canvases (the native encoders consume strided
        views directly), identical to the device program by construction."""
        imgs = np.asarray(batch["image"])
        sizes = np.asarray(batch["size"])
        margins = np.asarray(batch["margins"])
        views, chs, cws = [], [], []
        for i in range(len(imgs)):
            h, w = int(sizes[i, 0]), int(sizes[i, 1])
            tp, bp, lp, rp = (int(x) for x in margins[i])
            views.append(imgs[i, tp:h - bp, lp:w - rp])
            chs.append(h - tp - bp)
            cws.append(w - lp - rp)
        return {"image": views, "ch": np.asarray(chs, np.int32),
                "cw": np.asarray(cws, np.int32)}

    def save_item(self, out, item, output_dirs, options) -> Optional[Path]:
        path = Path(item["_args"][0])
        ch, cw = int(out["ch"]), int(out["cw"])
        p = Path(output_dirs[0]) / path.name
        encode_image(out["image"][:ch, :cw], p)
        return p


def crop_to_alpha_bounding_box(image_path: Path, **options) -> np.ndarray:
    """Compute-only alpha-bbox crop (staging parity:
    reference add_saving/recadrage_transparent.py:5-58).

    Errors on non-PNG, missing alpha, or fully transparent images; returns
    the cropped ndarray without saving (the missing save step is what kept
    it in the reference's staging area).
    """
    path = Path(image_path)
    if path.suffix.lower() != ".png":
        raise ValueError(f"file {path.name} is not a PNG")
    arr = decode_image(path)
    if arr.shape[2] != 4:
        raise AttributeError(f"image {path.name} has no alpha channel")
    if not (arr[..., 3] > 0).any():
        raise ValueError(f"image {path.name} is fully transparent")
    ys, xs = np.nonzero(arr[..., 3] > 0)
    return arr[ys.min():ys.max() + 1, xs.min():xs.max() + 1]


class FitCrop(BatchTransform):
    max_batch = 32

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        path = Path(inputs[0])
        arr = decode_image(path)
        h, w = arr.shape[:2]
        canvas = canvas_for(h, w)
        return {
            "canvas": canvas,
            "image": pad_to_canvas(arr, canvas),
            "size": np.asarray([h, w], np.int32),
            "_orig": arr,
        }

    def probe_item(self, inputs: Tuple, options: Dict):
        """Metadata-only load: whole buckets decode with ONE native batch
        call.  Band-safe 3/4-component files only (pixel-identical to
        load_item's native-bands decode); others fall back per-item."""
        from image_processor_pipeline_tpu.io import native

        path = Path(inputs[0])
        meta = native.probe_bands(path)
        if meta is None or meta[2] not in (3, 4):
            return None
        h, w, kind = meta
        canvas = canvas_for(h, w)
        return {
            "canvas": canvas,
            "size": np.asarray([h, w], np.int32),
            "_nch": kind,
            "_decode": (str(path), "RGB" if kind == 3 else "RGBA", False),
        }

    def bucket_key(self, item: Dict, options: Dict) -> Tuple:
        nch = item["image"].shape[-1] if "image" in item else item["_nch"]
        return (*item["canvas"], nch)

    def device_fn(self, batch, static):
        def one(img, size):
            out, bh, bw = geometry.fit_crop(img, size[0], size[1])
            return {"image": out, "bh": bh, "bw": bw}

        return jax.vmap(one)(batch["image"], batch["size"])

    def native_fn(self, batch, static, options, n_threads=1):
        """Host fast path: the content-bbox scan is a vectorized numpy
        reduction (integer/boolean only — no float divergence risk) with
        the same Pillow>=10 alpha-only semantics as ops/geometry.py:
        content_bbox; the crop itself is a zero-copy view.  The empty-bbox
        case keeps the image UNCROPPED, like the device program."""
        imgs = np.asarray(batch["image"])
        sizes = np.asarray(batch["size"])
        views, bhs, bws = [], [], []
        for i in range(len(imgs)):
            h, w = int(sizes[i, 0]), int(sizes[i, 1])
            region = imgs[i, :h, :w]
            if imgs.shape[-1] == 4:
                nz = region[..., 3] != 0
            else:
                nz = (region != 0).any(axis=-1)
            rows = nz.any(axis=1)
            cols = nz.any(axis=0)
            if rows.any():
                y0, y1 = np.flatnonzero(rows)[[0, -1]]
                x0, x1 = np.flatnonzero(cols)[[0, -1]]
                views.append(imgs[i, y0:y1 + 1, x0:x1 + 1])
                bhs.append(int(y1 - y0 + 1))
                bws.append(int(x1 - x0 + 1))
            else:  # getbbox None -> uncropped (clamped at 0)
                bh, bw = max(h, 0), max(w, 0)
                views.append(imgs[i, :bh, :bw])
                bhs.append(bh)
                bws.append(bw)
        return {"image": views, "bh": np.asarray(bhs, np.int32),
                "bw": np.asarray(bws, np.int32)}

    def save_item(self, out, item, output_dirs, options) -> Optional[Path]:
        path = Path(item["_args"][0])
        bh, bw = int(out["bh"]), int(out["bw"])
        p = Path(output_dirs[0]) / path.name
        if bh <= 0 or bw <= 0:
            # degenerate 0-extent input: save the original decoded pixels
            # (reference recadrages.py:74-76 copies the un-recadrée image)
            h, w = (int(x) for x in item["size"])
            arr = item["_orig"] if "_orig" in item else out["image"][:h, :w]
            encode_image_pil(arr, p)
        else:
            # reference recadrages.py:80 (fit crop) saves via PIL -> q75
            encode_image_pil(out["image"][:bh, :bw], p)
        return p
