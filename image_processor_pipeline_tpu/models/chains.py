"""Fused augmentation chains — the framework's "models".

Where the reference runs each transform as a separate pipeline stage with a
disk round-trip between stages (reference pipeline.py:538, 564-566), a chain
compiles the whole transform sequence into ONE jit-compiled XLA program over
an HBM-resident uint8 NHWC batch: decode once, augment N ways, encode once.

The flagship `augment_chain` is the driver's benchmark target
(BASELINE.json:2 — "images/sec/chip on 512px crop+rotate+flip+filter
chain"):

  512-crop around the bbox → random-angle rotation → random dihedral flip →
  HSV color-mask filter → photometric enhance (brightness/contrast/color +
  per-channel gain)

All stages are elementwise/gather ops XLA fuses into a handful of kernels;
the per-item RNG is counter-based (fold_in of a base key with the item
index), so results are independent of batching and device placement.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from image_processor_pipeline_tpu.ops import bbox as bbox_ops
from image_processor_pipeline_tpu.ops import color as color_ops
from image_processor_pipeline_tpu.ops import geometry, photometric

CROP = 512

# A fixed two-range HSV exclusion stack for the benchmark filter stage
# (values in the cv2 scale, as a user of the reference would configure).
_FILTER_LOWERS = ((35.0, 60.0, 60.0), (100.0, 40.0, 40.0))
_FILTER_UPPERS = ((85.0, 255.0, 255.0), (140.0, 230.0, 230.0))
_FILTER_ZONES = ((0, 0, 0, 0), (16, 16, 8, 8))


def _crop_params(shape, xywhn, seed, crop: int = CROP):
    """Random bbox-containing crop placement (T1 logic at fixed size).
    Returns (y0, x0, rotation angle) for one image."""
    H, W = shape[0], shape[1]
    key = jax.random.PRNGKey(seed)
    k_crop_x, k_crop_y, k_rot = jax.random.split(key, 3)

    hf = jnp.float32(H)
    wf = jnp.float32(W)
    xyxy = bbox_ops.xywhn2xyxy(xywhn, wf, hf)
    s = jnp.int32(crop)
    lo_x = jnp.maximum(0, xyxy[2].astype(jnp.int32) - s)
    hi_x = jnp.maximum(lo_x, jnp.minimum(xyxy[0].astype(jnp.int32), W - s))
    lo_y = jnp.maximum(0, xyxy[3].astype(jnp.int32) - s)
    hi_y = jnp.maximum(lo_y, jnp.minimum(xyxy[1].astype(jnp.int32), H - s))
    x0 = jax.random.randint(k_crop_x, (), lo_x, hi_x + 1)
    y0 = jax.random.randint(k_crop_y, (), lo_y, hi_y + 1)
    angle = jax.random.uniform(k_rot, (), minval=1.0, maxval=359.0)
    return y0, x0, angle


def _crop_one(img, xywhn, seed, crop: int = CROP):
    """Random bbox-containing crop of one image (T1 logic at fixed size).
    Returns ([crop, crop, 3] u8, rotation angle for the next stage)."""
    y0, x0, angle = _crop_params(img.shape, xywhn, seed, crop)
    out = jax.lax.dynamic_slice(img, (y0, x0, 0), (crop, crop, img.shape[2]))
    return out, angle


def _flip_and_params(seed):
    """Per-item user-flip index + enhance parameter draws (same key layout
    as _finish_one so all chain modes draw identical randomness)."""
    key = jax.random.PRNGKey(seed)
    _, _, _, k_flip, k_enh = jax.random.split(key, 5)
    idx = jax.random.randint(k_flip, (), 0, 4)
    kb, kc, kcol, krgb = jax.random.split(k_enh, 4)
    prm = jnp.concatenate([
        jnp.stack([
            jax.random.uniform(kb, (), minval=0.7, maxval=1.3),
            jax.random.uniform(kc, (), minval=0.7, maxval=1.3),
            jax.random.uniform(kcol, (), minval=0.7, maxval=1.3),
        ]),
        jax.random.uniform(krgb, (3,), minval=0.75, maxval=1.25),
    ])
    return idx, prm


def _finish_one(img, seed, crop: int = CROP):
    """Post-rotation stages of the fused chain on one image."""
    key = jax.random.PRNGKey(seed)
    _, _, _, k_flip, k_enh = jax.random.split(key, 5)

    # --- random dihedral flip ---------------------------------------------
    # two flip-where passes instead of a vmapped lax.switch computing all
    # 4 branches (idx bit 0 = x-flip, bit 1 = y-flip; same index→flip map
    # as the switch it replaces)
    flip_idx = jax.random.randint(k_flip, (), 0, 4)
    img = jnp.where((flip_idx & 1).astype(bool), jnp.flip(img, axis=1), img)
    img = jnp.where((flip_idx & 2).astype(bool), jnp.flip(img, axis=0), img)

    # --- HSV color-mask filter (T6) ---------------------------------------
    alpha = color_ops.color_mask_alpha(
        img, crop, crop,
        jnp.asarray(_FILTER_LOWERS, jnp.float32),
        jnp.asarray(_FILTER_UPPERS, jnp.float32),
        jnp.asarray(_FILTER_ZONES, jnp.int32),
    )

    # --- photometric enhance (T7, without the blur branch) ----------------
    kb, kc, kcol, krgb = jax.random.split(k_enh, 4)
    img = photometric.brightness(
        img, jax.random.uniform(kb, (), minval=0.7, maxval=1.3))
    img = photometric.contrast(
        img, jax.random.uniform(kc, (), minval=0.7, maxval=1.3))
    img = photometric.color_balance(
        img, jax.random.uniform(kcol, (), minval=0.7, maxval=1.3))
    img = photometric.channel_gains(
        img, jax.random.uniform(krgb, (3,), minval=0.75, maxval=1.25))

    return jnp.concatenate([img, alpha[..., None]], axis=-1)


def augment_full_reference(images, y0, x0, angles, enh_params, flips,
                           crop: int = CROP):
    """The chain in flip-first order: crop → user dihedral flip →
    rotate_square_shear → HSV mask → enhance, all per item.

    images: [B, H, W, 3|4] u8 (only RGB is read); y0/x0: [B] crop offsets;
    angles: [B] degrees; enh_params: [B, 6] (brightness, contrast, color,
    gain r/g/b); flips: [B] int32 (bit 0 = x-flip, bit 1 = y-flip).
    Returns [B, crop, crop, 4] u8 RGBA (alpha = color mask).
    """
    lowers = jnp.asarray(_FILTER_LOWERS, jnp.float32)
    uppers = jnp.asarray(_FILTER_UPPERS, jnp.float32)
    zones = jnp.asarray(_FILTER_ZONES, jnp.int32)

    def one(img, yy, xx, angle, prm, f):
        img = jax.lax.dynamic_slice(img, (yy, xx, 0), (crop, crop, 3))
        img = jnp.where((f & 1).astype(bool), jnp.flip(img, axis=1), img)
        img = jnp.where((f & 2).astype(bool), jnp.flip(img, axis=0), img)
        img = geometry.rotate_square_shear(img, angle)
        alpha = color_ops.color_mask_alpha(img, crop, crop, lowers, uppers,
                                           zones)
        img = photometric.brightness(img, prm[0])
        img = photometric.contrast(img, prm[1])
        img = photometric.color_balance(img, prm[2])
        img = photometric.channel_gains(img, prm[3:6])
        return jnp.concatenate([img, alpha[..., None]], axis=-1)

    return jax.vmap(one)(images, y0.astype(jnp.int32), x0.astype(jnp.int32),
                         angles, enh_params, flips.astype(jnp.int32))


ROTATION_MODES = ("shear", "gather", "full_reference")


def augment_chain(images, xywhn, seeds, crop: int = CROP,
                  rotation: str = "shear"):
    """Batched fused chain: [B, H, W, 3] u8 → [B, crop, crop, 4] u8 (RGBA).

    ``rotation``: 'shear' (bit-decomposed 3-shear, crop → rotate → flip),
    'gather' (direct nearest inverse map) or 'full_reference' (the same
    3-shear in flip-first order, augment_full_reference).  All modes draw
    identical per-item randomness; the two orders give equally
    distributed augmentations.
    """
    if rotation not in ROTATION_MODES:
        raise ValueError(f"unknown rotation mode {rotation!r}; "
                         f"expected one of {ROTATION_MODES}")
    if rotation == "full_reference":
        y0, x0, angles = jax.vmap(
            lambda im, bb, sd: _crop_params(im.shape, bb, sd, crop)
        )(images, xywhn, seeds)
        flips, prms = jax.vmap(_flip_and_params)(seeds)
        return augment_full_reference(images, y0, x0, angles, prms, flips,
                                      crop=crop)

    cropped, angles = jax.vmap(functools.partial(_crop_one, crop=crop))(
        images, xywhn, seeds
    )
    if rotation == "shear":
        rotated = jax.vmap(geometry.rotate_square_shear)(cropped, angles)
    else:
        rotated = jax.vmap(
            lambda im, a: geometry.rotate_fixed(im, crop, crop, a)
        )(cropped, angles)
    return jax.vmap(functools.partial(_finish_one, crop=crop))(rotated, seeds)


class AugmentChain:
    """Jit-compiled flagship chain with a stable callable interface."""

    def __init__(self, input_size: int = 640):
        if input_size < CROP:
            raise ValueError(f"input_size must be >= {CROP}")
        self.input_size = input_size
        self._fn = jax.jit(augment_chain, static_argnums=(3, 4))

    def __call__(self, images, xywhn, seeds):
        return self._fn(images, xywhn, seeds)

    def example_inputs(self, batch: int = 8):
        import numpy as np

        rng = np.random.default_rng(0)
        images = rng.integers(
            0, 256, size=(batch, self.input_size, self.input_size, 3),
            dtype=np.uint8,
        )
        xywhn = np.tile(
            np.asarray([0.5, 0.5, 0.2, 0.2], np.float32), (batch, 1)
        )
        seeds = np.arange(batch, dtype=np.uint32)
        return images, xywhn, seeds
