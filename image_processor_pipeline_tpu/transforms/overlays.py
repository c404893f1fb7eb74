"""Overlay alpha-compositing + YOLO label synthesis — batched device transform.

Behavior parity with reference overlays.py:24-187
(paste_overlay_onto_background, the current non-deprecated variant):
  - overlay → RGBA, background → RGB (overlays.py:83-88)
  - target overlay diagonal = uniform(scale_min=0.15, scale_max=0.30) ×
    background diagonal, capped so the overlay fits at its aspect ratio
    (overlays.py:104-121); final dims via int() truncation of
    h = sqrt(d²/(ar²+1)), w = int(ar·h) (overlays.py:125-126)
  - LANCZOS resize (overlays.py:129) — here two matmuls
  - uniform random placement, inclusive randint bounds (overlays.py:133-134)
  - PIL alpha paste (overlays.py:138-139)
  - one YOLO label line for the paste bbox, class ``yolo_class_id``
    (overlays.py:141-149), computed on the host from the integer paste
    geometry (label_values); label has NO trailing newline
    (overlays.py:172-173)
  - outputs ``{overlay_stem}{background_suffix}`` and ``{overlay_stem}.txt``
    (overlays.py:165-166); partial outputs removed on save failure
    (overlays.py:182-187)
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from image_processor_pipeline_tpu.transforms.base import BatchTransform
from image_processor_pipeline_tpu.ops import compose, geometry
from image_processor_pipeline_tpu.io.images import (
    decode_padded,
    encode_image_pil,
    probe_padded,
)
from image_processor_pipeline_tpu.utils.utils import validate_dirs


def _draw_geometry(seed, ov_h, ov_w, bg_h, bg_w, scale_min, scale_max):
    """Per-item random paste geometry (sizing math of reference
    overlays.py:104-134).  Shared by the device program AND the native
    twin's draw evaluation so sizes and positions are identical whichever
    computes the pixels."""
    key = jax.random.PRNGKey(seed)
    kr, kx, ky = jax.random.split(key, 3)

    bhf = bg_h.astype(jnp.float32)
    bwf = bg_w.astype(jnp.float32)
    ohf = ov_h.astype(jnp.float32)
    owf = ov_w.astype(jnp.float32)

    bg_diag = jnp.sqrt(bwf * bwf + bhf * bhf)
    ratio = jax.random.uniform(kr, (), minval=scale_min, maxval=scale_max)
    target_diag = bg_diag * ratio

    aspect = owf / ohf
    h_max = jnp.minimum(bwf / aspect, bhf)
    max_diag = jnp.sqrt((aspect * h_max) ** 2 + h_max ** 2)
    diag = jnp.minimum(target_diag, max_diag)

    new_h = jnp.floor(jnp.sqrt(diag * diag / (aspect * aspect + 1.0)))
    new_w = jnp.floor(aspect * new_h)
    new_hi = new_h.astype(jnp.int32)
    new_wi = new_w.astype(jnp.int32)
    ok = (new_hi > 0) & (new_wi > 0)

    px = jax.random.randint(
        kx, (), 0, jnp.maximum(bg_w - new_wi, 0) + 1
    )
    py = jax.random.randint(
        ky, (), 0, jnp.maximum(bg_h - new_hi, 0) + 1
    )

    return new_hi, new_wi, py, px, ok


def label_values(pos, new_size, bg_size) -> np.ndarray:
    """The paste box as YOLO (cx, cy, w, h), from the integer geometry.

    ``ops.bbox.xyxy2xywhn``'s f32 formula, evaluated in numpy on the host:
    its sums are exact on integers and numpy's divides are correctly
    rounded, so every backend writes the same label text (XLA:GPU's f32
    divide is not correctly rounded and would move a value by an ulp,
    and a printed 6-decimal tie with it)."""
    py, px = (np.float32(v) for v in pos)
    nh, nw = (np.float32(v) for v in new_size)
    bh, bw = (np.float32(v) for v in bg_size)
    two = np.float32(2)
    return np.asarray([(px + (px + nw)) / two / bw,
                       (py + (py + nh)) / two / bh, nw / bw, nh / bh],
                      np.float32)


def _muldiv255(v, a):
    """Pillow MULDIV255: round(v*a/255) as ((v*a+128)>>8 + v*a+128)>>8."""
    t = v.astype(jnp.int32) * a.astype(jnp.int32) + 128
    return (t + (t >> 8)) >> 8


def _paste_one(ov, ov_h, ov_w, bg, bg_h, bg_w, seed,
               scale_min: float, scale_max: float):
    new_hi, new_wi, py, px, ok = _draw_geometry(
        seed, ov_h, ov_w, bg_h, bg_w, scale_min, scale_max)

    Hb, Wb = bg.shape[0], bg.shape[1]
    # PIL Image.resize on RGBA resamples PREMULTIPLIED alpha (RGBA→RGBa,
    # resample, back-convert — Image.resize's LA/RGBA wrapper).  Match:
    # exact-integer premultiply, f32 resample (PIL ±1), exact-integer
    # unpremultiply ((255*v)//a, alpha 0/255 pass through, clip 255).
    a0 = ov[..., 3:4]
    pre = jnp.concatenate([_muldiv255(ov[..., :3], a0), a0], axis=-1)
    resized = geometry.resize(
        pre.astype(ov.dtype), ov_h, ov_w, new_hi, new_wi, "lanczos",
        out_canvas=(Hb, Wb)
    )
    ra = resized[..., 3:4].astype(jnp.int32)
    rv = resized[..., :3].astype(jnp.int32)
    unp = jnp.minimum((255 * rv) // jnp.maximum(ra, 1), 255)
    rgb = jnp.where((ra == 0) | (ra == 255), rv, unp)
    resized = jnp.concatenate([rgb, ra], axis=-1).astype(ov.dtype)

    out = compose.alpha_paste(bg, bg_h, bg_w, resized, new_hi, new_wi, py, px)
    return {
        "image": out,
        "ok": ok,
        "pos": jnp.stack([py, px]),
        "new_size": jnp.stack([new_hi, new_wi]),
    }


class PasteOverlayOntoBackground(BatchTransform):
    max_batch = 16

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        ov_path, bg_path = Path(inputs[0]), Path(inputs[1])
        ov, ov_h, ov_w, ov_canvas = decode_padded(ov_path, mode="RGBA")
        bg, bg_h, bg_w, bg_canvas = decode_padded(bg_path, mode="RGB")
        if ov_h == 0:
            raise ValueError(f"overlay {ov_path.name} has invalid dimensions")
        return {
            "canvas": (*ov_canvas, *bg_canvas),
            "overlay": ov,
            "ov_size": np.asarray([ov_h, ov_w], np.int32),
            "background": bg,
            "bg_size": np.asarray([bg_h, bg_w], np.int32),
        }

    def probe_item(self, inputs: Tuple, options: Dict) -> Optional[Dict]:
        """Metadata-only load (native header probes, no pixel decode): a
        bucket of n items then decodes with exactly TWO native batch calls
        (overlay RGBA + background RGB — io/images.py:_fill_pending_multi)
        instead of 2n per-item Python-thread decodes."""
        ov_path, bg_path = Path(inputs[0]), Path(inputs[1])
        ov_meta = probe_padded(ov_path, mode="RGBA")
        bg_meta = probe_padded(bg_path, mode="RGB")
        if ov_meta is None or bg_meta is None:
            return None
        ov_h, ov_w, ov_canvas = ov_meta
        bg_h, bg_w, bg_canvas = bg_meta
        if ov_h == 0:
            raise ValueError(f"overlay {ov_path.name} has invalid dimensions")
        return {
            "canvas": (*ov_canvas, *bg_canvas),
            "ov_size": np.asarray([ov_h, ov_w], np.int32),
            "bg_size": np.asarray([bg_h, bg_w], np.int32),
            "_pending": {
                "overlay": (
                    str(ov_path), "RGBA", False, ov_canvas, ov_h, ov_w),
                "background": (
                    str(bg_path), "RGB", False, bg_canvas, bg_h, bg_w),
            },
        }

    def static_args(self, options: Dict, key: Tuple) -> Tuple:
        return (
            float(options.get("scale_min", 0.15)),
            float(options.get("scale_max", 0.30)),
        )

    def device_fn(self, batch, static):
        scale_min, scale_max = static
        return jax.vmap(
            lambda ov, ovs, bg, bgs, seed: _paste_one(
                ov, ovs[0], ovs[1], bg, bgs[0], bgs[1], seed,
                scale_min, scale_max,
            )
        )(batch["overlay"], batch["ov_size"], batch["background"],
          batch["bg_size"], batch["seed"])

    _draw_jit = None

    @classmethod
    def _native_draws(cls, seeds, ov_sizes, bg_sizes, scale_min, scale_max):
        """Evaluate the per-item jax.random paste geometry through the SAME
        traced _draw_geometry the device program uses (identical draws →
        identical sizes and positions across backends), padded to a
        power-of-two batch length to bound retraces."""
        if cls._draw_jit is None:
            cls._draw_jit = jax.jit(jax.vmap(
                lambda seed, ovs, bgs, smin, smax: _draw_geometry(
                    seed, ovs[0], ovs[1], bgs[0], bgs[1], smin, smax),
                in_axes=(0, 0, 0, None, None)))
        n = len(seeds)
        # FIXED pad length (not per-n pow2): every engine batch length maps
        # to ONE compiled draw program — per-length variants were ~1.5s of
        # retrace each, paid in the first e2e chunks after warmup
        cap = max(cls.max_batch, 1 << (n - 1).bit_length())
        pad_seeds = np.zeros(cap, np.uint32)
        pad_seeds[:n] = seeds
        pad_ov = np.ones((cap, 2), np.int32)
        pad_ov[:n] = ov_sizes
        pad_bg = np.ones((cap, 2), np.int32)
        pad_bg[:n] = bg_sizes
        outs = cls._draw_jit(pad_seeds, pad_ov, pad_bg,
                             jnp.float32(scale_min), jnp.float32(scale_max))
        return [np.asarray(o)[:n] for o in outs]

    def native_fn(self, batch, static, options, n_threads=1):
        """Native CPU twin (ops/native_cpu.py:overlay_batch): Pillow's
        premultiplied fixed-point LANCZOS resample + Paste.c blend —
        byte-identical to the reference's PIL composite (a STRONGER parity
        than the jit path's f32 resample, which is PIL ±1).  Geometry
        comes from the device program's exact draws either way."""
        from image_processor_pipeline_tpu.ops import native_cpu

        if not native_cpu.available():
            return None
        scale_min, scale_max = static
        seeds = np.asarray(batch["seed"], np.uint32)
        new_h, new_w, py, px, ok = self._native_draws(
            seeds, batch["ov_size"], batch["bg_size"], scale_min, scale_max)
        geo = np.stack(
            [new_h, new_w, py, px, ok.astype(np.int32)], axis=1)
        outs = native_cpu.overlay_batch(
            batch["overlay"], batch["ov_size"], batch["background"],
            batch["bg_size"], geo, n_threads)
        if outs is None:
            return None
        return {
            "image": outs,
            "ok": ok,
            "pos": np.stack([py, px], axis=1),
            "new_size": np.stack([new_h, new_w], axis=1),
        }

    # -- hybrid device JPEG encode (D2H ships coefficients, not pixels) ----
    # Composites are background-sized (the step's largest payload); when
    # every background in the bucket is .jpg the JPEG front half runs on
    # device at the PIL-anchored q75 (ops/jpeg.py:encode_shrink) and only
    # sparse quantized coefficients come back.  Byte-identical to the
    # pixel path (test_transforms pins it).
    shrinks_output = True
    #: per-item outputs the save needs beside the pixels
    _GEO_KEYS = ("ok", "pos", "new_size")

    def shrink_output(self, out_dev, chunk, options):
        img = out_dev["image"]
        if isinstance(img, np.ndarray):
            return out_dev  # native path already host-resident
        if chunk and all(
                Path(it["_args"][1]).suffix.lower() in (".jpg", ".jpeg")
                for it in chunk):
            from image_processor_pipeline_tpu.ops import jpeg as djpeg

            if djpeg.device_encode_enabled(options, self):
                out = self._shrink_encode(
                    out_dev, chunk, options,
                    n_valid=len({id(it) for it in chunk}))
                if out is not None:
                    return out
        self.start_host_copy(out_dev)
        return out_dev

    def _shrink_encode(self, out_dev, chunk, options, n_valid):
        from image_processor_pipeline_tpu.ops import jpeg as djpeg

        sizes = np.stack([np.asarray(it["bg_size"]) for it in chunk])
        h_np, w_np = sizes[:, 0], sizes[:, 1]
        out = djpeg.shrink_transport(
            self, out_dev["image"], jnp.asarray(h_np), jnp.asarray(w_np),
            h_np, w_np, 75,  # PIL q75 (reference overlays.py:169)
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
        ov_path = Path(item["_args"][0])
        bg_path = Path(item["_args"][1])
        if not bool(out["ok"]):
            print(f"[overlays] degenerate overlay size for {ov_path.name}")
            return None
        bh, bw = (int(x) for x in item["bg_size"])
        cx, cy, wn, hn = (float(x) for x in label_values(
            out["pos"], out["new_size"], item["bg_size"]))
        cls_id = options.get("yolo_class_id", 0)
        label_line = f"{cls_id} {cx:.6f} {cy:.6f} {wn:.6f} {hn:.6f}"

        img_out = Path(img_dir) / f"{ov_path.stem}{bg_path.suffix}"
        lbl_out = Path(lbl_dir) / f"{ov_path.stem}.txt"
        saved: List[Path] = []
        try:
            if "jpeg_meta" in out:
                # device_encode transport: entropy-encode the device-
                # quantized sparse coefficients (bytes identical)
                from image_processor_pipeline_tpu.ops.jpeg import (
                    write_sparse_item,
                )

                write_sparse_item(img_out, out, bh, bw)
            else:
                # reference overlays.py:169 saves via PIL -> JPEG q75
                encode_image_pil(out["image"][:bh, :bw], img_out)
            saved.append(img_out)
            lbl_out.write_text(label_line)
            saved.append(lbl_out)
            return saved
        except Exception as e:  # noqa: BLE001 — rollback partial outputs
            print(f"[overlays] save failed for {ov_path.name}: {e}")
            for p in saved:
                try:
                    if p.exists():
                        p.unlink()
                except OSError:
                    print(f"[overlays] could not clean up partial file {p}")
            return None
