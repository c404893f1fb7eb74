"""Square crop around YOLO bboxes — batched device transform.

Behavior parity with reference crop_square.py:104-224
(process_square_crop_around_bbox):
  - crop side = min(H, W) (crop_square.py:172)
  - placement bounds: x0 ∈ [max(0, int(x_max - s)), min(int(x_min), W - s)],
    same for y (crop_square.py:179-182, int() truncation kept)
  - uniform random integer offset, inclusive bounds (crop_square.py:192-193)
  - bboxes shifted, clipped to the crop, kept only if strictly non-degenerate
    (crop_square.py:201-210; the reference's ambiguous-truth bug §2.7 #3 is
    fixed to the intended elementwise test)
  - errors when no valid placement exists (crop_square.py:185-189) or no
    bbox survives (crop_square.py:211-212)
  - outputs: <out_imgs>/<image name>, <out_labels>/<label name>
    (crop_square.py:220-222), label lines 'cls cx cy w h' 6-decimal

Device-first: the placement draw, crop (circular roll + mask), and bbox
recalibration all run inside one jitted batched program; host only decodes,
stacks, and re-encodes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple
from warnings import warn

import numpy as np
import jax
import jax.numpy as jnp

from image_processor_pipeline_tpu.transforms.base import BatchTransform
from image_processor_pipeline_tpu.ops import bbox as bbox_ops
from image_processor_pipeline_tpu.ops import geometry
from image_processor_pipeline_tpu.io.images import (
    decode_padded,
    encode_image,
    probe_padded,
)
from image_processor_pipeline_tpu.io.labels import read_yolo_labels, write_yolo_labels
from image_processor_pipeline_tpu.utils.utils import validate_dirs

MAX_BOXES = 64


def _geom_one(h, w, classes, xywhn, nbox, seed):
    """Per-item placement draw + bbox recalibration (no image math).

    Shared verbatim by the device program and the native fast path, so the
    placement/labels are bit-identical per seed on both."""
    key = jax.random.PRNGKey(seed)
    kx, ky = jax.random.split(key)

    box_mask = jax.lax.iota(jnp.int32, MAX_BOXES) < nbox
    xyxy = bbox_ops.xywhn2xyxy(xywhn, w.astype(jnp.float32), h.astype(jnp.float32))
    union = bbox_ops.union_box(xyxy, box_mask)
    x_min, y_min, x_max, y_max = union[0], union[1], union[2], union[3]

    s = jnp.minimum(h, w)
    sf = s.astype(jnp.float32)
    # int() truncation like the reference, then bound clamping
    lo_x = jnp.maximum(0, (x_max - sf).astype(jnp.int32))
    hi_x = jnp.minimum(x_min.astype(jnp.int32), w - s)
    lo_y = jnp.maximum(0, (y_max - sf).astype(jnp.int32))
    hi_y = jnp.minimum(y_min.astype(jnp.int32), h - s)
    placement_ok = (lo_x <= hi_x) & (lo_y <= hi_y) & (nbox > 0)

    # inclusive-bounds randint; guard empty ranges to keep randint happy
    x0 = jax.random.randint(kx, (), lo_x, jnp.maximum(hi_x, lo_x) + 1)
    y0 = jax.random.randint(ky, (), lo_y, jnp.maximum(hi_y, lo_y) + 1)

    shifted = bbox_ops.shift_boxes(xyxy, x0.astype(jnp.float32), y0.astype(jnp.float32))
    clipped = bbox_ops.clip_boxes(shifted, (sf, sf))
    valid = (
        (clipped[:, 0] < clipped[:, 2]) & (clipped[:, 1] < clipped[:, 3]) & box_mask
    )
    new_xywhn = bbox_ops.xyxy2xywhn(clipped, sf, sf)
    return {
        "crop_size": s,
        "x0": x0,
        "y0": y0,
        "placement_ok": placement_ok,
        "xywhn": new_xywhn,
        "classes": classes,
        "valid": valid,
    }


def _crop_one(img, h, w, classes, xywhn, nbox, seed):
    """Single-image device computation (vmapped over the batch)."""
    out = _geom_one(h, w, classes, xywhn, nbox, seed)
    out["image"] = geometry.crop(img, out["y0"], out["x0"],
                                 out["crop_size"], out["crop_size"])
    return out


class SquareCropAroundBBox(BatchTransform):
    """Batched square-crop-around-bbox (input pairing: zip of imgs+labels)."""

    def probe_item(self, inputs: Tuple, options: Dict) -> Optional[Dict[str, Any]]:
        img_path = Path(inputs[0])
        meta = probe_padded(img_path, mode="RGB")
        if meta is None:
            return None
        h, w, canvas = meta
        item = self._label_fields(inputs)
        item.update({
            "canvas": canvas,
            "size": np.asarray([h, w], np.int32),
            "_decode": (str(img_path), "RGB", False),
        })
        return item

    def _label_fields(self, inputs: Tuple) -> Dict[str, Any]:
        img_path, lbl_path = Path(inputs[0]), Path(inputs[1])
        if img_path.stem != lbl_path.stem:
            warn(
                f"[crop_square] image ({img_path.name}) and label "
                f"({lbl_path.name}) stems differ; processing anyway"
            )
        classes, xywhn = read_yolo_labels(lbl_path)
        if len(classes) > MAX_BOXES:
            warn(
                f"[crop_square] {lbl_path.name} has {len(classes)} boxes; "
                f"only the first {MAX_BOXES} constrain the crop placement"
            )
        n = min(len(classes), MAX_BOXES)
        cls_pad = np.zeros((MAX_BOXES,), np.int32)
        box_pad = np.zeros((MAX_BOXES, 4), np.float32)
        cls_pad[:n] = classes[:n]
        box_pad[:n] = xywhn[:n]
        return {"classes": cls_pad, "xywhn": box_pad, "nbox": np.int32(n)}

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        img_path = Path(inputs[0])
        buf, h, w, canvas = decode_padded(img_path, mode="RGB")
        item = self._label_fields(inputs)
        item.update({
            "canvas": canvas,
            "image": buf,
            "size": np.asarray([h, w], np.int32),
        })
        return item

    def device_fn(self, batch, static):
        return jax.vmap(_crop_one)(
            batch["image"],
            batch["size"][:, 0],
            batch["size"][:, 1],
            batch["classes"],
            batch["xywhn"],
            batch["nbox"],
            batch["seed"],
        )

    _geom_jit = None

    def native_fn(self, batch, static, options, n_threads=1):
        """Host fast path: the placement/bbox math still runs through the
        EXACT jit geometry program (_geom_one — tiny label arrays, padded
        to a power-of-two batch), while the image crop becomes a zero-copy
        numpy view instead of the device roll+mask over the full canvas.
        Byte-identical to the jit path by construction."""
        cls = type(self)
        if cls._geom_jit is None:
            cls._geom_jit = jax.jit(jax.vmap(_geom_one))
        imgs = np.asarray(batch["image"])
        n = len(imgs)
        cap = 1 << max(2, (n - 1).bit_length())

        def pad(a, fill=0):
            a = np.asarray(a)
            out = np.full((cap,) + a.shape[1:], fill, a.dtype)
            out[:n] = a
            return out

        geo = cls._geom_jit(
            pad(batch["size"][:, 0], 1), pad(batch["size"][:, 1], 1),
            pad(batch["classes"]), pad(batch["xywhn"]),
            pad(batch["nbox"]), pad(batch["seed"]),
        )
        geo = {k: np.asarray(v)[:n] for k, v in geo.items()}
        views = []
        for i in range(n):
            s = int(geo["crop_size"][i])
            y0, x0 = int(geo["y0"][i]), int(geo["x0"][i])
            if geo["placement_ok"][i]:
                views.append(imgs[i, y0:y0 + s, x0:x0 + s])
            else:  # save_item raises before reading the pixels
                views.append(imgs[i, :s, :s])
        geo["image"] = views
        return geo

    # -- hybrid device JPEG encode (D2H ships coefficients, not pixels) ----
    # Crops keep the input suffix and save at the cv2-anchored q95
    # (reference crop_square.py saves via cv2.imwrite); on all-.jpg
    # buckets the JPEG front half runs on device and only sparse
    # quantized coefficients come back.  Byte-identical to the pixel
    # path (test_transforms pins it).
    shrinks_output = True

    def shrink_output(self, out_dev, chunk, options):
        img = out_dev["image"]
        if isinstance(img, (list, np.ndarray)):
            return out_dev  # native path already host-resident (views)
        if chunk and all(
                Path(it["_args"][0]).suffix.lower() in (".jpg", ".jpeg")
                for it in chunk):
            from image_processor_pipeline_tpu.ops import jpeg as djpeg

            if djpeg.device_encode_enabled(options, self):
                out = self._shrink_encode(
                    out_dev, options,
                    n_valid=len({id(it) for it in chunk}))
                if out is not None:
                    return out
        self.start_host_copy(out_dev)
        return out_dev

    _GEO_KEYS = ("crop_size", "placement_ok", "valid", "classes", "xywhn")

    def _shrink_encode(self, out_dev, options, n_valid):
        from image_processor_pipeline_tpu.ops import jpeg as djpeg

        s_dev = out_dev["crop_size"]
        s_np = np.asarray(s_dev)  # small sync (saver-thread context)
        out = djpeg.shrink_transport(
            self, out_dev["image"], s_dev, s_dev, s_np, s_np, 95,
            options, n_valid)
        if out is None:
            return None
        out.update({k: out_dev[k] for k in self._GEO_KEYS})
        self.start_host_copy(out)
        return out

    def materialize_batch(self, out_dev, n: int):
        if "jpeg_idx" not in out_dev:
            return BatchTransform.materialize_batch(out_dev, n)
        from image_processor_pipeline_tpu.ops import jpeg as djpeg

        return djpeg.materialize_jpeg_batch(out_dev, n,
                                            per_item_keys=self._GEO_KEYS)

    def save_item(
        self,
        out: Dict[str, np.ndarray],
        item: Dict,
        output_dirs: Sequence[Path],
        options: Dict,
    ) -> Optional[List[Path]]:
        img_dir, lbl_dir = validate_dirs(output_dirs, 2)
        img_path, lbl_path = Path(item["_args"][0]), Path(item["_args"][1])
        if not bool(out["placement_ok"]):
            raise RuntimeError(
                f"no valid square-crop placement for {img_path.name}"
            )
        valid = out["valid"].astype(bool)
        if not valid.any():
            raise RuntimeError(f"no bbox survives the crop for {img_path.name}")
        s = int(out["crop_size"])
        classes = out["classes"][valid]
        xywhn = out["xywhn"][valid]
        img_out = Path(img_dir) / img_path.name
        lbl_out = Path(lbl_dir) / lbl_path.name
        if "jpeg_meta" in out:
            # device_encode transport: entropy-encode the device-quantized
            # sparse coefficients (bytes identical to the q95 pixel path)
            from image_processor_pipeline_tpu.ops.jpeg import write_sparse_item

            write_sparse_item(img_out, out, s, s)
        else:
            encode_image(out["image"][:s, :s], img_out)
        write_yolo_labels(lbl_out, classes, xywhn)
        return [img_out, lbl_out]
