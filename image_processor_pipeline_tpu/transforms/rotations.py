"""Random rotations — batched device transform (1 → N+1 fan-out).

Behavior parity with reference rotations.py:6-133 (process_rotations):
  - load as RGBA (rotations.py:55)
  - optional original saved as ``{stem}_{original_key}.{fmt}`` (default
    ``_r000``, rotations.py:77-82)
  - ``num_rotations`` (default 10) rotations at uniform random angles in
    [angle_min=1, angle_max=359], expand=True with transparent fill,
    nearest resampling (rotations.py:88-96)
  - tight crop to the content bbox (PIL getbbox, rotations.py:99-109)
  - names ``{stem}_{rotation_key_format(prefix, i+1)}.{fmt}`` with
    rotation_key_format default ``{prefix}{index:03d}`` and prefix ``r``
    (rotations.py:14-17, 113-116); ``.jpeg`` format maps to ``.jpg``
  - returns None when nothing could be saved (rotations.py:128-130)

Device-first: all N rotations of a batch run as one jitted program —
vmap over (batch × rotations) of the inverse-map rotation kernel on an
expanded square canvas that accommodates the worst-case diagonal.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from image_processor_pipeline_tpu.transforms.base import BatchTransform
from image_processor_pipeline_tpu.ops import geometry
from image_processor_pipeline_tpu.io.images import (
    decode_padded,
    encode_image_pil,
    probe_padded,
)


def _rotate_one(img, h, w, seed, num_rotations: int,
                angle_min: float, angle_max: float, method: str,
                interpolation: str = "nearest"):
    """All rotations of one image: returns [N, H, W, 4] + sizes + angles.

    method 'nearest' follows PIL's inverse-map sampling exactly (the parity
    path, a per-pixel gather); 'shear' uses the Paeth 3-shear permutation
    (same footprint, ±1 px sampling jitter, ~20x faster) — the content is
    centered on the square diagonal canvas first so the shears rotate about
    the right point, then tight-cropped as usual.

    Empty-bbox (fully transparent input) fallback: the nearest path emits
    the reference's uncropped rotate-expand extents (nh, nw); the shear
    path — OUR approximate extension, no reference analog — emits its own
    working extent, the square diagonal canvas.  Both outputs are fully
    transparent; only the saved dimensions of an invisible image differ,
    and the native chain twin matches the device byte-for-byte.
    """
    key = jax.random.PRNGKey(seed)
    angles = jax.random.uniform(
        key, (num_rotations,), minval=angle_min, maxval=angle_max
    )
    H = img.shape[0]

    if method == "shear":
        cy = (H - h) // 2
        cx = (H - w) // 2
        centered = jnp.roll(img, (cy, cx), axis=(0, 1))

        def rot(angle):
            out = geometry.rotate_square_shear(centered, angle)
            out, bh, bw = geometry.fit_crop(out, H, H)
            return out, bh, bw
    else:
        def rot(angle):
            out, h2, w2 = geometry.rotate_expand(
                img, h, w, angle, interpolation
            )
            out, bh, bw = geometry.fit_crop(out, h2, w2)
            return out, bh, bw

    outs, bhs, bws = jax.vmap(rot)(angles)
    return {"images": outs, "heights": bhs, "widths": bws, "angles": angles}


class RandomRotations(BatchTransform):
    max_batch = 8  # N rotations per item amplify the per-item footprint

    # save_item re-encodes the decoded input as the `include_original`
    # copy (reference rotations.py:77-82), so the engine must keep host
    # pixel decoding on (device_decode would leave item["image"] unset)
    save_needs_image = True

    #: cached jitted angle-draw programs keyed by
    #: (num_rotations, angle_min, angle_max, padded_len)
    _angle_jit: Dict[Tuple, Any] = {}

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        path = Path(inputs[0])
        buf, h, w, canvas = decode_padded(path, mode="RGBA", diag=True)
        return {
            "canvas": canvas,
            "image": buf,
            "size": np.asarray([h, w], np.int32),
        }

    def probe_item(self, inputs: Tuple, options: Dict) -> Optional[Dict[str, Any]]:
        path = Path(inputs[0])
        meta = probe_padded(path, mode="RGBA", diag=True)
        if meta is None:
            return None
        h, w, canvas = meta
        return {
            "canvas": canvas,
            "size": np.asarray([h, w], np.int32),
            "_decode": (str(path), "RGBA", True),
        }

    def static_args(self, options: Dict, key: Tuple) -> Tuple:
        return (
            int(options.get("num_rotations", 10)),
            float(options.get("angle_min", 1.0)),
            float(options.get("angle_max", 359.0)),
            str(options.get("method", "nearest")),
            str(options.get("interpolation", "nearest")),
        )

    def device_fn(self, batch, static):
        num_rotations, angle_min, angle_max, method, interpolation = static
        return jax.vmap(
            lambda img, size, seed: _rotate_one(
                img, size[0], size[1], seed, num_rotations, angle_min,
                angle_max, method, interpolation,
            )
        )(batch["image"], batch["size"], batch["seed"])

    def _host_angles(self, seeds: np.ndarray, num_rotations: int,
                     angle_min: float, angle_max: float) -> np.ndarray:
        """Evaluate the device program's per-item angle draws on the host:
        the SAME jax.random.uniform(PRNGKey(seed), ...) tree _rotate_one
        traces, batched + padded to a power-of-two length so engine-bucket
        batch lengths don't each compile a fresh scalar program (the
        FusedChain._native_draws pattern)."""
        # FIXED pad length (>= max_batch): one compiled draw program for
        # every engine batch length instead of a pow2 ladder of retraces
        L = max(self.max_batch,
                1 << max(0, int(np.ceil(np.log2(max(1, len(seeds)))))))
        key_t = (num_rotations, angle_min, angle_max, L)
        fn = RandomRotations._angle_jit.get(key_t)
        if fn is None:
            def one(seed):
                return jax.random.uniform(
                    jax.random.PRNGKey(seed), (num_rotations,),
                    minval=angle_min, maxval=angle_max)

            fn = jax.jit(jax.vmap(one))
            RandomRotations._angle_jit[key_t] = fn
        padded = np.zeros((L,), np.uint32)
        padded[: len(seeds)] = seeds
        return np.asarray(fn(padded))[: len(seeds)]

    # -- hybrid device JPEG encode (D2H ships coefficients, not pixels) ----
    # The rotations device path is the engine's largest D2H payload (R
    # canvases per input); options={"device_encode": True} with
    # output_format='jpeg' runs the JPEG front half on device
    # (ops/jpeg.py:encode_shrink at the PIL-anchored q75) and fetches
    # sparse quantized coefficients; save_item entropy-encodes only.
    # Byte-identical to the pixel path (test_transforms pins it).
    shrinks_output = True

    def shrink_output(self, out_dev, chunk, options):
        imgs = out_dev["images"]
        if isinstance(imgs, np.ndarray):
            return out_dev  # native path already host-resident
        fmt = str(options.get("output_format", "png")).lower()
        if fmt in ("jpeg", "jpg"):
            from image_processor_pipeline_tpu.ops import jpeg as djpeg

            if djpeg.device_encode_enabled(options, self):
                out = self._shrink_encode(
                    out_dev, options,
                    n_valid=len({id(it) for it in chunk}))
                if out is not None:
                    return out
        self.start_host_copy(out_dev)
        return out_dev

    def _shrink_encode(self, out_dev, options, n_valid=None):
        from image_processor_pipeline_tpu.ops import jpeg as djpeg

        imgs = out_dev["images"]
        B, R = int(imgs.shape[0]), int(imgs.shape[1])
        flat = imgs.reshape((B * R,) + imgs.shape[2:])
        h_dev = out_dev["heights"].reshape(B * R)
        w_dev = out_dev["widths"].reshape(B * R)
        # small sync: the batch's compute is already queued ahead
        h_np = np.asarray(h_dev)
        w_np = np.asarray(w_dev)
        # hysteresis counts only the chunk's real items' rows (pad items
        # duplicate the tail and would skew the dense ratio); each item
        # contributes R flattened rows
        out = djpeg.shrink_transport(
            self, flat, h_dev, w_dev, h_np, w_np,
            75,  # PIL q75 (rotations.py:119)
            options, B * R if n_valid is None else n_valid * R)
        if out is None:
            return None
        out.update(jpeg_R=R, heights=h_np.reshape(B, R),
                   widths=w_np.reshape(B, R))
        self.start_host_copy(out)
        return out

    def materialize_batch(self, out_dev, n: int):
        if "jpeg_idx" not in out_dev:
            return BatchTransform.materialize_batch(out_dev, n)
        R = out_dev["jpeg_R"]
        pixels = out_dev["jpeg_pixels"]
        fetch = jax.device_get(
            {k: out_dev[k] for k in ("jpeg_idx", "jpeg_val")})
        items = []
        for i in range(n):
            lo = i * R
            it = {
                "jpeg_idx": fetch["jpeg_idx"][lo:lo + R],
                "jpeg_val": fetch["jpeg_val"][lo:lo + R],
                "jpeg_nnz": out_dev["jpeg_nnz"][lo:lo + R],
                "jpeg_meta": out_dev["jpeg_meta"],
                "jpeg_pixels": {
                    j - lo: px for j, px in pixels.items()
                    if lo <= j < lo + R},
                "heights": out_dev["heights"][i],
                "widths": out_dev["widths"][i],
            }
            items.append(it)
        return items

    def native_fn(self, batch, static, options, n_threads=1):
        """PIL-exact C++ twin (ops/native_cpu.py:rotations_batch) for the
        nearest-resampling path: Pillow's 16.16 fixed-point affine walk +
        getbbox tight crop, byte-identical to the REFERENCE's
        Image.rotate(angle, expand=True) (rotations.py:96-109) — stronger
        than the jit path's float32 formulation, which differs from PIL
        on a few floor-boundary pixels per image."""
        from image_processor_pipeline_tpu.ops import native_cpu

        num_rotations, angle_min, angle_max, method, interpolation = static
        if not native_cpu.available() or method != "nearest" \
                or interpolation != "nearest":
            return None
        seeds = np.asarray(batch["seed"], np.uint32)
        angles = self._host_angles(
            seeds, num_rotations, angle_min, angle_max)
        sizes = np.asarray(batch["size"], np.int32)
        n = len(seeds)
        mats = np.empty((n * num_rotations, 6), np.float64)
        osizes = np.empty((n * num_rotations, 2), np.int32)
        for i in range(n):
            h, w = int(sizes[i, 0]), int(sizes[i, 1])
            for j in range(num_rotations):
                a = float(angles[i, j]) % 360.0
                if a % 90.0 == 0.0:
                    # PIL serves 0/90/180/270+expand via its transpose
                    # fast path, not the affine — let the jit path (whose
                    # quarter-turn handling is PIL-probed) take the batch
                    return None
                m, nw, nh = geometry._pil_rotate_matrix(w, h, a)
                mats[i * num_rotations + j] = m
                osizes[i * num_rotations + j] = (nh, nw)
        res = native_cpu.rotations_batch(
            np.asarray(batch["image"], np.uint8), sizes, mats, osizes,
            num_rotations, n_threads)
        if res is None:
            return None
        outs, out_sizes = res
        return {
            "images": outs,
            "heights": out_sizes[..., 0],
            "widths": out_sizes[..., 1],
            "angles": angles,
        }

    def save_item(
        self,
        out: Dict[str, np.ndarray],
        item: Dict,
        output_dirs: Sequence[Path],
        options: Dict,
    ) -> Optional[List[Path]]:
        if not output_dirs:
            print("[rotations] no output dir provided")
            return None
        target = Path(output_dirs[0])
        path = Path(item["_args"][0])
        stem = path.stem

        output_format = options.get("output_format", "png")
        output_prefix = options.get("output_prefix", "r")
        original_key = options.get("original_key", "r000")
        key_format = options.get("rotation_key_format", "{prefix}{index:03d}")
        include_original = options.get("include_original", True)
        suffix = ".jpg" if output_format.lower() == "jpeg" \
            else f".{output_format.lower()}"

        saved: List[Path] = []
        if include_original:
            p = target / f"{stem}_{original_key}{suffix}"
            try:
                h, w = (int(x) for x in item["size"])
                # reference rotations.py:81 saves via PIL -> JPEG q75
                encode_image_pil(item["image"][:h, :w], p)
                saved.append(p)
            except Exception as e:  # noqa: BLE001 — continue past original
                print(f"[rotations] failed to save original {p.name}: {e}")

        jpeg_mode = "jpeg_meta" in out
        n = out["heights"].shape[0]
        for i in range(n):
            bh, bw = int(out["heights"][i]), int(out["widths"][i])
            if bh <= 0 or bw <= 0:
                print(f"[rotations] empty bbox for rotation {i + 1} of "
                      f"{path.name}; skipping")
                continue
            key = key_format.format(prefix=output_prefix, index=i + 1)
            p = target / f"{stem}_{key}{suffix}"
            try:
                if jpeg_mode and i not in out["jpeg_pixels"]:
                    # device_encode transport: entropy-encode the device-
                    # quantized sparse coefficients (bytes identical)
                    from image_processor_pipeline_tpu.ops.jpeg import (
                        write_sparse_item,
                    )

                    write_sparse_item(p, {
                        "jpeg_idx": out["jpeg_idx"][i],
                        "jpeg_val": out["jpeg_val"][i],
                        "jpeg_nnz": out["jpeg_nnz"][i],
                        "jpeg_meta": out["jpeg_meta"],
                    }, bh, bw)
                else:
                    img = (out["jpeg_pixels"][i] if jpeg_mode
                           else out["images"][i])[:bh, :bw]
                    encode_image_pil(img, p)
                saved.append(p)
            except Exception as e:  # noqa: BLE001 — per-rotation tolerance
                print(f"[rotations] failed rotation {i + 1} of {path.name}: {e}")

        if not saved:
            return None
        return saved
