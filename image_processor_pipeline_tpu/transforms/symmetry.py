"""Dihedral symmetries — batched device transform.

Behavior parity with reference symmetry.py:11-149 (generate_symmetries):
  - generators o/h/v/hv = identity / cv2.flip(1) / flip(0) / flip(-1)
    (symmetry.py:114-119)
  - extension validated against YOLO IMG_FORMATS (symmetry.py:92-94)
  - ``choose_random`` unique symmetries sampled from ``pool`` (default all
    four); ``include_original`` force-appends 'o' (symmetry.py:122-126)
  - naming ``{stem}_{sym}{input suffix}`` into output_dirs[0]
    (symmetry.py:133-134)
  - the reference's choose_random > len(pool) crash (SURVEY.md §2.7 #8) is
    fixed: warn and clamp.

Device-first: the flips present in the step's pool are computed in one jitted
batched program (a flip is bandwidth-trivial); the host saves only the
per-item sampled subset, keeping per-item randomness independent of batch
composition.  Flips outside the pool are never computed.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple
from warnings import warn

import numpy as np
import jax

from image_processor_pipeline_tpu.transforms.base import BatchTransform
from image_processor_pipeline_tpu.ops import geometry
from image_processor_pipeline_tpu.io.images import decode_image, encode_image
from image_processor_pipeline_tpu.io.batching import canvas_for, pad_to_canvas
from image_processor_pipeline_tpu.utils.utils import IMG_FORMATS

ALL_SYMS = ("o", "h", "v", "hv")


_FLIP_FNS = {
    "h": geometry.flip_h,
    "v": geometry.flip_v,
    "hv": geometry.flip_hv,
}


def _syms_one(img, h, w, which=("h", "v", "hv")):
    return {s: _FLIP_FNS[s](img, h, w) for s in which}


class GenerateSymmetries(BatchTransform):
    max_batch = 32

    def static_args(self, options: Dict, key: Tuple) -> Tuple:
        # only the flips the step's pool can ever select are computed
        pool = options.get("pool") or ALL_SYMS
        return tuple(s for s in ("h", "v", "hv") if s in set(pool))

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        path = Path(inputs[0])
        if path.suffix.lower()[1:] not in IMG_FORMATS:
            raise ValueError(
                f"{path.name} is not an accepted YOLO image format"
            )
        arr = decode_image(path)  # native bands (IMREAD_UNCHANGED parity)
        h, w = arr.shape[:2]
        canvas = canvas_for(h, w)
        return {
            "canvas": canvas,
            "image": pad_to_canvas(arr, canvas),
            "size": np.asarray([h, w], np.int32),
            "_orig": arr,
        }

    def probe_item(self, inputs: Tuple, options: Dict):
        """Metadata-only load so whole buckets decode with ONE native
        batch call.  Only band-safe files take this path (3-component
        JPEG, RGB/RGBA PNG — where the native decode is pixel- and
        band-identical to load_item's PIL native-bands decode); gray,
        palette, 16-bit and tRNS inputs return None and keep the exact
        per-item path."""
        from image_processor_pipeline_tpu.io import native

        path = Path(inputs[0])
        if path.suffix.lower()[1:] not in IMG_FORMATS:
            raise ValueError(
                f"{path.name} is not an accepted YOLO image format"
            )
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

    # save_item reads the decoded input (the 'o' symmetry writes the
    # original pixels), so the hybrid device-decode path stays off —
    # EXCEPT on all-.jpg buckets with the coefficient transport on,
    # where the 'o' copy is device-encoded too (needs_host_image below)
    # and the run becomes fully codec-to-codec: sparse coefficients in,
    # flips + FDCT on device, sparse coefficients out; pixels never
    # touch host memory.
    save_needs_image = True

    def needs_host_image(self, chunk, options) -> bool:
        from image_processor_pipeline_tpu.io import native as io_native
        from image_processor_pipeline_tpu.ops import jpeg as djpeg

        if not io_native.available():
            return True
        if not djpeg.device_encode_enabled(options, self):
            return True
        # a cap that encode_shrink must decline (>= 1/3 the pixel bytes)
        # means the transport this skip is betting on can never run —
        # keep the host decode rather than fetch full canvases back later
        if not djpeg.transport_cap_viable(
                options.get("device_encode_cap", 0.25)):
            return True
        return not all(
            Path(it["_decode"][0]).suffix.lower() in (".jpg", ".jpeg")
            for it in chunk if "_decode" in it)

    def bucket_key(self, item: Dict, options: Dict) -> Tuple:
        nch = item["image"].shape[-1] if "image" in item else item["_nch"]
        return (*item["canvas"], nch)

    def device_fn(self, batch, static):
        return jax.vmap(
            lambda img, size: _syms_one(img, size[0], size[1], static)
        )(batch["image"], batch["size"])

    def launch_batch(self, key, chunk, options, mesh=None):
        """Base dispatch, plus a zero-copy device reference to the INPUT
        batch so the shrink hook can device-encode the 'o' copy (and
        source the pixel fallback) when the host kept no image — the
        fully codec-to-codec path."""
        import jax.numpy as jnp

        arrays = self.stack_batch(chunk, options)
        static = self.static_args(options, key)
        fn = self._jitted() if mesh is None else self._jitted_sharded(mesh)
        batch = {k: jnp.asarray(v) for k, v in arrays.items()}
        out = dict(fn(self, batch, static))
        out["_input_dev"] = batch["image"]
        return out

    # -- hybrid device JPEG encode (D2H ships coefficients, not pixels) ----
    # Symmetries write up to 4 full canvases per input at the cv2-anchored
    # q95 — the widest D2H fan-out after rotations.  On .jpg runs the JPEG
    # front half runs ON DEVICE for every computed flip
    # (ops/jpeg.py:encode_shrink) and only sparse quantized coefficients
    # come back; the 'o' original keeps the ordinary host pixel encode
    # (save_item already holds the decoded input).  Byte-identical to the
    # pixel path (test_transforms pins it).
    shrinks_output = True

    def shrink_output(self, out_dev, chunk, options):
        if not out_dev:
            return out_dev  # native path computes (and fetches) nothing
        inp = out_dev.pop("_input_dev", None)
        vals = list(out_dev.values())
        if vals and isinstance(vals[0], np.ndarray):
            return out_dev  # host-resident (shouldn't carry _input_dev)
        # did the engine skip the host decode for this chunk (device
        # decode fed the batch)?  Then the input pixels exist ONLY on
        # device and the save path must be fed from there.
        host_missing = any(
            "image" not in it and "_orig" not in it and
            "_load_error" not in it for it in chunk)
        if chunk and all(
                Path(it["_args"][0]).suffix.lower() in (".jpg", ".jpeg")
                for it in chunk):
            from image_processor_pipeline_tpu.ops import jpeg as djpeg

            if djpeg.device_encode_enabled(options, self):
                out = self._shrink_encode(
                    out_dev, inp, chunk, options,
                    n_valid=len({id(it) for it in chunk}),
                    host_missing=host_missing)
                if out is not None:
                    return out
        if host_missing and inp is not None:
            # transport declined but the host never decoded: fetch the
            # input canvases so save_item's 'o' (and flip views) have a
            # pixel source — correctness over bytes saved.  Non-underscore
            # key: this copy is real D2H and must be metered.
            out_dev = dict(out_dev, input_pixels=inp)
        self.start_host_copy(out_dev)
        return out_dev

    def _shrink_encode(self, out_dev, inp, chunk, options, n_valid,
                       host_missing=False):
        import jax.numpy as jnp

        from image_processor_pipeline_tpu.io import native as io_native
        from image_processor_pipeline_tpu.ops import jpeg as djpeg

        if not io_native.available():
            return None
        sizes = np.stack([np.asarray(it["size"]) for it in chunk])
        h_np, w_np = sizes[:, 0], sizes[:, 1]
        planes = dict(out_dev)
        pool = set(options.get("pool") or ALL_SYMS)
        if inp is not None and (options.get("include_original", True)
                                or "o" in pool):
            # the 'o' copy is a re-encode of the input (reference
            # symmetry.py saves it via cv2.imwrite like the flips) — on
            # device it's just one more FDCT plane, and with the hybrid
            # decode on it closes the fully codec-to-codec path.  Skipped
            # when neither include_original nor the pool can ever select
            # 'o': its coefficients would never be read.
            planes["o"] = inp
        if not planes:
            return None
        # STACKED encode across planes (flips preserve (h, w), so planes
        # tile the same h/w vectors): a per-plane loop would pay up to 4
        # serialized jit dispatches each ending in a blocking nnz sync in
        # the saver thread.
        # Dispatches are bounded at <=64 stacked rows (B>=64 batches
        # measured to degrade in the XLA tail — CLAUDE.md perf log), so a
        # default B<=16 chunk still encodes ALL planes in one dispatch
        # and a full B=32 chunk takes two.  cv2-anchored q95 (reference
        # symmetry.py:133 saves via cv2.imwrite).
        keys = tuple(planes)
        P, B = len(keys), len(h_np)
        gsz = max(1, 64 // B)
        out = {"jpeg_syms": keys}
        n_of = 0
        for g0 in range(0, P, gsz):
            gkeys = keys[g0:g0 + gsz]
            stacked = (jnp.concatenate([planes[s] for s in gkeys], axis=0)
                       if len(gkeys) > 1 else planes[gkeys[0]])
            h_rep, w_rep = np.tile(h_np, len(gkeys)), np.tile(w_np,
                                                              len(gkeys))
            res = djpeg.encode_shrink(
                stacked, jnp.asarray(h_rep), jnp.asarray(w_rep),
                h_rep, w_rep, 95,
                cap_frac=float(options.get("device_encode_cap", 0.25)))
            if res is None:
                # decline is deterministic in (cap, canvas): no group can
                # succeed if one declines.  When the engine skipped the
                # host decode betting on the transport, the fallback
                # fetches full canvases — count the forfeited plane ROWS
                # (the same units note_overflows uses below) so a run of
                # declines trips the sticky gate and the host decode
                # resumes (needs_host_image re-checks the gate).
                if host_missing:
                    djpeg.note_declines(self, n_valid * P)
                return None
            idx, val, nnz_np, meta, pixels = res
            out["jpeg_meta"] = meta  # same (hm16, wm16, q) every group
            for k, s in enumerate(gkeys):
                lo = k * B
                out[f"jpeg_idx_{s}"] = idx[lo:lo + B]
                out[f"jpeg_val_{s}"] = val[lo:lo + B]
                out[f"jpeg_nnz_{s}"] = nnz_np[lo:lo + B]
                out[f"jpeg_pixels_{s}"] = {
                    i - lo: px for i, px in pixels.items()
                    if lo <= i < lo + B}
                n_of += sum(1 for i in pixels
                            if lo <= i < lo + B and i - lo < n_valid)
        djpeg.note_overflows(self, n_of, n_valid * P)
        self.start_host_copy(out)
        return out

    def materialize_batch(self, out_dev, n: int):
        if "jpeg_syms" not in out_dev:
            return BatchTransform.materialize_batch(out_dev, n)
        syms = out_dev["jpeg_syms"]
        fetch = jax.device_get({
            k: out_dev[k] for s in syms
            for k in (f"jpeg_idx_{s}", f"jpeg_val_{s}")})
        items = []
        for i in range(n):
            it = {"jpeg_syms": syms, "jpeg_meta": out_dev["jpeg_meta"]}
            for s in syms:
                px = out_dev[f"jpeg_pixels_{s}"]
                if i in px:
                    it[s] = px[i]  # overflow: ordinary pixel save path
                else:
                    it[f"jpeg_idx_{s}"] = fetch[f"jpeg_idx_{s}"][i]
                    it[f"jpeg_val_{s}"] = fetch[f"jpeg_val_{s}"][i]
                    it[f"jpeg_nnz_{s}"] = out_dev[f"jpeg_nnz_{s}"][i]
            items.append(it)
        return items

    def native_fn(self, batch, static, options, n_threads=1):
        """Host path: flips never materialize at all.  A dihedral flip is
        a pure permutation, so save_item encodes numpy flip VIEWS of the
        decoded image — the native encoders consume them zero-copy
        (negative row pitch for 'v', reversed-pixel row assembly for 'h',
        both for 'hv'; io/native.py:_row_strided).  Byte-identical to the
        materialized path by construction."""
        return {}

    def launch_batch_native(self, key, chunk, options, n_threads=1):
        # nothing to compute — skip stack_batch's np.stack copy too
        return {}

    def save_item(
        self,
        out: Dict[str, np.ndarray],
        item: Dict,
        output_dirs: Sequence[Path],
        options: Dict,
    ) -> Optional[List[Path]]:
        if not output_dirs:
            raise ValueError("no output dir provided")
        target = Path(output_dirs[0])
        path = Path(item["_args"][0])
        h, w = (int(x) for x in item["size"])

        pool = list(options.get("pool") or ALL_SYMS)
        invalid = [s for s in pool if s not in ALL_SYMS]
        if invalid:
            raise ValueError(f"pool contains invalid symmetries: {invalid}")
        choose_random = options.get("choose_random")
        choose_random = len(pool) if choose_random is None else choose_random
        if choose_random > len(pool):
            warn(
                f"choose_random={choose_random} exceeds pool size "
                f"{len(pool)}; clamping"
            )
            choose_random = len(pool)
        elif choose_random < 0:
            raise ValueError(f"choose_random ({choose_random}) must be >= 0")

        rng = random.Random(item["_seed"])
        selected = rng.sample(pool, choose_random)
        if options.get("include_original", True) and "o" not in set(selected):
            selected.append("o")

        def base():
            # input pixels: host decode, or the device input canvas on
            # codec-to-codec runs where the transport declined (the
            # fully-transported runs never call this)
            if "_orig" in item:
                return item["_orig"]
            if "image" in item:
                return item["image"][:h, :w]
            return np.asarray(out["input_pixels"])[:h, :w]

        _VIEW = {"h": lambda a: a[:, ::-1], "v": lambda a: a[::-1],
                 "hv": lambda a: a[::-1, ::-1]}
        jpeg_syms = out.get("jpeg_syms", ())
        saved: List[Path] = []
        for sym in selected:
            p = target / path.with_stem(f"{path.stem}_{sym}").name
            try:
                if sym in jpeg_syms:
                    if f"jpeg_idx_{sym}" in out:
                        # device_encode transport: entropy-encode the
                        # device-quantized sparse coefficients (bytes
                        # identical to the q95 pixel encode)
                        from image_processor_pipeline_tpu.ops.jpeg import (
                            write_sparse_item,
                        )

                        write_sparse_item(p, {
                            "jpeg_idx": out[f"jpeg_idx_{sym}"],
                            "jpeg_val": out[f"jpeg_val_{sym}"],
                            "jpeg_nnz": out[f"jpeg_nnz_{sym}"],
                            "jpeg_meta": out["jpeg_meta"],
                        }, h, w)
                        saved.append(p)
                        continue
                    arr = out[sym]  # transport overflow: pixel crop
                elif sym == "o":
                    arr = base()
                elif sym in out:  # jit path materialized the flip on device
                    arr = out[sym][:h, :w]
                else:  # native path: zero-copy flip view (see native_fn)
                    arr = _VIEW[sym](base())
                encode_image(arr, p)
                saved.append(p)
            except Exception as e:  # noqa: BLE001 — per-sym tolerance
                warn(f"failed to save symmetry {sym!r} for {path.name}: {e}")
        return saved
