"""Photometric enhancement — batched device transform ('sample' pairing consumer).

Behavior parity with reference tranfo.py:9-55 (enhance_image):
  - Brightness, Contrast, Color each scaled by uniform(0.7, 1.3)
  - GaussianBlur(radius=uniform(0.5, 3)) when the 30% 'apply_blur' flag is set
  - per-channel RGB gain uniform(0.75, 1.25) when 'apply_rgb' is set —
    implemented as the intended one-gain-per-channel (the reference's
    per-LUT-entry redraw at tranfo.py:48-50 is a defect, SURVEY.md §2.7 #12)
  - output: same file name into output_dirs[0]

All five stages fuse into a single XLA program over the batch.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax

from image_processor_pipeline_tpu.transforms.base import BatchTransform
from image_processor_pipeline_tpu.ops import photometric
from image_processor_pipeline_tpu.io.images import (
    decode_padded,
    encode_image_pil,
)
from image_processor_pipeline_tpu.utils.utils import validate_dirs


def _draw_factors(seed):
    """Per-item factor draws (reference tranfo.py:20-27 ranges).  Shared by
    the jit path and the native CPU path — jax.random is deterministic
    across backends and call sites, so both paths see identical float32
    factors for a given seed."""
    key = jax.random.PRNGKey(seed)
    kb, kc, kcol, kblur, krgb = jax.random.split(key, 5)
    b = jax.random.uniform(kb, (), minval=0.7, maxval=1.3)
    c = jax.random.uniform(kc, (), minval=0.7, maxval=1.3)
    col = jax.random.uniform(kcol, (), minval=0.7, maxval=1.3)
    sigma = jax.random.uniform(kblur, (), minval=0.5, maxval=3.0)
    gains = jax.random.uniform(krgb, (3,), minval=0.75, maxval=1.25)
    return b, c, col, sigma, gains


_factors_jit = None


def _factors_batch(seeds: np.ndarray) -> np.ndarray:
    """[N] uint32 seeds → [N, 7] float32 (b, c, col, sigma, g0, g1, g2).

    Seeds are padded to a power-of-two length before the jit call: engine
    buckets produce many distinct batch lengths (per-canvas tails), and a
    per-length recompile of even this tiny program costs more than the
    whole native enhance (measured 58 ms/img vs 5)."""
    global _factors_jit
    if _factors_jit is None:
        import jax.numpy as jnp

        def f(s):
            b, c, col, sig, g = jax.vmap(_draw_factors)(s)
            return jnp.concatenate([jnp.stack([b, c, col, sig], -1), g], -1)

        _factors_jit = jax.jit(f)
    n = len(seeds)
    cap = 1 << max(4, (n - 1).bit_length())
    padded = np.zeros(cap, np.uint32)
    padded[:n] = seeds
    return np.asarray(_factors_jit(padded), np.float32)[:n]


def _enhance_one(img, h, w, apply_blur, apply_rgb, seed):
    b, c, col, sigma, gains = _draw_factors(seed)
    out = photometric.enhance(
        img, h, w, b, c, col, sigma, apply_blur, gains, apply_rgb,
        blur_max_radius=photometric.box_radius_bound(3.0),
        blur_sigma_max=3.0,  # sigma is drawn in [0.5, 3.0] above
    )
    return {"image": out}


class EnhanceImage(BatchTransform):
    max_batch = 16

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        path = Path(inputs[0])
        apply_blur = bool(inputs[1]) if len(inputs) > 1 else False
        apply_rgb = bool(inputs[2]) if len(inputs) > 2 else False
        buf, h, w, canvas = decode_padded(path, mode="RGB")
        return {
            "canvas": canvas,
            "image": buf,
            "size": np.asarray([h, w], np.int32),
            "apply_blur": np.bool_(apply_blur),
            "apply_rgb": np.bool_(apply_rgb),
        }

    def probe_item(self, inputs: Tuple, options: Dict):
        from image_processor_pipeline_tpu.io.images import probe_padded

        path = Path(inputs[0])
        meta = probe_padded(path, mode="RGB")
        if meta is None:
            return None
        h, w, canvas = meta
        return {
            "canvas": canvas,
            "size": np.asarray([h, w], np.int32),
            "apply_blur": np.bool_(bool(inputs[1]) if len(inputs) > 1 else False),
            "apply_rgb": np.bool_(bool(inputs[2]) if len(inputs) > 2 else False),
            "_decode": (str(path), "RGB", False),
        }

    def device_fn(self, batch, static):
        return jax.vmap(
            lambda img, size, blur, rgb, seed: _enhance_one(
                img, size[0], size[1], blur, rgb, seed
            )
        )(batch["image"], batch["size"], batch["apply_blur"],
          batch["apply_rgb"], batch["seed"])

    def native_fn(self, batch, static, options, n_threads=1):
        """Bit-exact C++ twin (ops/native_cpu.py): PIL truncating blends,
        integer luma/mean, Pillow fixed-point box blur, rint'd gains —
        the factor draws still come from jax.random so outputs are
        byte-identical to the jit path for every seed."""
        from image_processor_pipeline_tpu.ops import native_cpu

        if not native_cpu.available():
            return None
        factors = _factors_batch(np.asarray(batch["seed"], np.uint32))
        flags = np.stack(
            [batch["apply_blur"], batch["apply_rgb"]], axis=-1
        ).astype(np.uint8)
        out = native_cpu.enhance_batch(
            batch["image"], batch["size"], factors, flags, n_threads)
        if out is None:
            return None
        return {"image": out}

    # -- hybrid device JPEG encode (D2H ships coefficients, not pixels) ----
    # Enhance writes <input stem>.jpg at the PIL-anchored q75; with
    # options={"device_encode": True} and an all-.jpg bucket the JPEG
    # front half runs on device (ops/jpeg.py:encode_shrink) and only
    # sparse quantized coefficients come back.  Byte-identical to the
    # pixel path (test_transforms pins it).
    shrinks_output = True

    def shrink_output(self, out_dev, chunk, options):
        img = out_dev["image"]
        if isinstance(img, np.ndarray):
            return out_dev  # native path already host-resident
        from image_processor_pipeline_tpu.ops import jpeg as djpeg

        if djpeg.device_encode_enabled(options, self) and chunk and all(
                Path(it["_args"][0]).suffix.lower() in (".jpg", ".jpeg")
                for it in chunk):
            out = self._shrink_encode(out_dev, chunk, options)
            if out is not None:
                return out
        self.start_host_copy(out_dev)
        return out_dev

    def _shrink_encode(self, out_dev, chunk, options):
        import jax.numpy as jnp

        from image_processor_pipeline_tpu.ops import jpeg as djpeg

        sizes = np.stack([np.asarray(it["size"]) for it in chunk])
        h_np, w_np = sizes[:, 0], sizes[:, 1]
        # hysteresis counts only the chunk's real items (pad rows are
        # duplicates and would skew the dense ratio)
        out = djpeg.shrink_transport(
            self, out_dev["image"], jnp.asarray(h_np), jnp.asarray(w_np),
            h_np, w_np, 75,  # PIL q75 (tranfo.py:53)
            options, len({id(it) for it in chunk}))
        if out is not None:
            self.start_host_copy(out)
        return out

    def materialize_batch(self, out_dev, n: int):
        if "jpeg_idx" not in out_dev:
            return BatchTransform.materialize_batch(out_dev, n)
        from image_processor_pipeline_tpu.ops import jpeg as djpeg

        return djpeg.materialize_jpeg_batch(out_dev, n)

    def save_item(
        self,
        out: Dict[str, np.ndarray],
        item: Dict,
        output_dirs: Sequence[Path],
        options: Dict,
    ) -> Optional[List[Path]]:
        target = validate_dirs(output_dirs, 1)
        path = Path(item["_args"][0])
        h, w = (int(x) for x in item["size"])
        p = Path(target) / path.name
        if "jpeg_meta" in out:
            from image_processor_pipeline_tpu.ops.jpeg import write_sparse_item

            write_sparse_item(p, out, h, w)
            return p
        # reference tranfo.py:53 saves via PIL -> JPEG quality 75
        encode_image_pil(out["image"][:h, :w], p)
        return p
