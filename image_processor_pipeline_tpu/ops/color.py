"""Color-space ops: RGB→HSV (OpenCV uint8 conventions), multi-range HSV
masking with rectangular zones, and mask→alpha conversion.

Parity targets: reference filtres_liste.py:41-149 (cv2.cvtColor BGR2HSV +
cv2.inRange stacks + zone masks + inverted mask as alpha channel) and
atomize/gaine_jaune.py:10-44 (single-range chroma key).

The reference reads BGR with cv2; internally we are RGB everywhere — the HSV
math below is the standard (R, G, B) formulation, which is exactly what
cv2.cvtColor(BGR2HSV) computes on its channel-reversed view, so masks agree.

All pure elementwise math — XLA fuses the whole filter stack into one pass
over device memory.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp


def rgb_to_hsv_u8(img):
    """uint8 RGB [..., 3] → uint8 HSV, BIT-EXACT vs cv2's 8U conversion
    (H∈[0,180), S,V∈[0,255]) over the entire 24-bit RGB space.

    cv2's 8U path is fixed point, not true division (imgproc color_hsv,
    hsv_shift=12): it precomputes sdiv_table[v] = cvRound(255·4096/v) and
    hdiv_table180[d] = cvRound(180·4096/(6d)), then descales round-half-up:
        S = (diff · sdiv_table[V] + 2048) >> 12
        H = (h_num · hdiv_table[diff] + 2048) >> 12,  +180 if negative
    with h_num = G-B | B-R+2·diff | R-G+4·diff by sector (V==R priority).
    A plain float `rint(255·diff/V)` formulation disagrees on ~3.4% of RGB
    triples (S off by one at descale boundaries, H off across the 0/180
    wrap), so we replicate the integer math exactly.

    The table entries are computed on the fly as rint(1044480/v) and
    rint(122880/d): exact ties x.5 never occur (2·1044480 = 2¹³·255 and
    2·122880 = 2¹⁴·15 have no odd divisor ≤ 255·(2k+1) form with v ≤ 255),
    and the nearest half-integer boundary is ≥ 1/(2v) away while f32
    division error is ≤ ~0.07/v — so any ≤4-ulp divide rounds identically
    to cv2's double-precision cvRound (verified against cv2 exhaustively
    over all 2²⁴ triples).
    """
    r = img[..., 0].astype(jnp.int32)
    g = img[..., 1].astype(jnp.int32)
    b = img[..., 2].astype(jnp.int32)
    v = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    diff = v - mn
    # diff == 0 forces S = 2048>>12 = 0 and h_num = 0, so the v=0 / diff=0
    # table entries never matter — max(.,1) only guards the divide.
    sdiv = jnp.rint(1044480.0 / jnp.maximum(v, 1).astype(jnp.float32))
    s8 = (diff * sdiv.astype(jnp.int32) + 2048) >> 12
    hnum = jnp.where(
        v == r, g - b,
        jnp.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    hdiv = jnp.rint(122880.0 / jnp.maximum(diff, 1).astype(jnp.float32))
    h8 = (hnum * hdiv.astype(jnp.int32) + 2048) >> 12
    h8 = jnp.where(h8 < 0, h8 + 180, h8)
    return jnp.stack([h8, s8, v], axis=-1).astype(jnp.uint8)


def in_range(hsv, lower: Sequence[float], upper: Sequence[float]):
    """cv2.inRange: bool mask where lower <= hsv <= upper channelwise.

    Bounds may be floats (the reference's GIMP rescale produces unrounded
    *2.55 values, filtres_liste.py:32-37).  cv2.inRange saturate-casts the
    scalar bound array to the src dtype BEFORE comparing — round half to
    even (cvRound), clamped to [0, 255] — so e.g. a lower S bound of
    30*2.55 = 76.5 admits S = 76.  We replicate that exactly.
    """
    h = hsv.astype(jnp.float32)
    lo = jnp.clip(jnp.rint(jnp.asarray(lower, jnp.float32)), 0, 255)
    hi = jnp.clip(jnp.rint(jnp.asarray(upper, jnp.float32)), 0, 255)
    return jnp.all((h >= lo) & (h <= hi), axis=-1)


def zone_mask(H: int, W: int, h, w, top, bottom, left, right):
    """Bool mask restricted to a margin-inset rectangle of the valid region.

    Margins are absolute pixel counts computed host-side (reference
    filtres_liste.py:99-113 computes them from fractional or absolute specs).
    """
    iy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    ix = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    return (iy >= top) & (iy < h - bottom) & (ix >= left) & (ix < w - right)


def color_mask_alpha(
    img_rgb,
    h,
    w,
    lowers,          # [F, 3] float/int arrays
    uppers,          # [F, 3]
    zones,           # [F, 4] int margins (top, bottom, left, right)
):
    """Accumulate F HSV in-range masks (each ANDed with its zone), OR them,
    invert, and return a uint8 alpha channel (255 = keep, 0 = masked out).

    Parity: reference filtres_liste.py:99-144 — per filter: inRange AND
    zone mask, OR-accumulated; final alpha = NOT(mask).
    """
    H, W = img_rgb.shape[-3], img_rgb.shape[-2]
    hsv = rgb_to_hsv_u8(img_rgb[..., :3])
    lowers = jnp.asarray(lowers, jnp.float32).reshape(-1, 3)
    uppers = jnp.asarray(uppers, jnp.float32).reshape(-1, 3)
    zones = jnp.asarray(zones, jnp.int32).reshape(-1, 4)

    def body(i, acc):
        m = in_range(hsv, lowers[i], uppers[i])
        z = zone_mask(H, W, h, w,
                      zones[i, 0], zones[i, 1], zones[i, 2], zones[i, 3])
        return acc | (m & z)

    acc = jax.lax.fori_loop(
        0, lowers.shape[0], body, jnp.zeros((H, W), jnp.bool_)
    )
    alpha = jnp.where(acc, jnp.uint8(0), jnp.uint8(255))
    # keep alpha zero outside the valid region
    from image_processor_pipeline_tpu.ops.geometry import valid_mask
    return jnp.where(valid_mask(h, w, H, W), alpha, jnp.uint8(0))


def gimp_to_cv_hsv(hsv_bound: Sequence[float]) -> Tuple[float, float, float]:
    """GIMP-scale HSV (H∈[0,360], S,V∈[0,100]) → cv2 8-bit scale.

    Parity: reference filtres_liste.py:8-39 (_rescale_filter): H floor-divided
    by 2, S and V multiplied by 2.55 *without rounding* here — cv2.inRange
    saturate-rounds the bounds to uint8 at compare time (see in_range).
    """
    h, s, v = hsv_bound
    if not (0 <= h <= 360 and 0 <= s <= 100 and 0 <= v <= 100):
        raise ValueError(f"HSV bound out of GIMP range: {hsv_bound}")
    return (h // 2, s * 2.55, v * 2.55)


def rescale_filter(filter_tuple, use_gimp_scale: bool = False):
    """Validate/convert one 6-tuple (Hmin,Smin,Vmin,Hmax,Smax,Vmax).

    Parity: reference filtres_liste.py:8-39 — OpenCV scale is validated
    (H <= 180, warn-only if S/V all <= 100); GIMP scale is converted.
    """
    mn_h, mn_s, mn_v, mx_h, mx_s, mx_v = filter_tuple
    if not use_gimp_scale:
        if mn_h > 180 or mx_h > 180:
            raise ValueError(
                f"H values ({mn_h}-{mx_h}) exceed the OpenCV range [0, 180]"
            )
        return tuple(filter_tuple)
    if any(sv > 100 for sv in (mn_s, mn_v, mx_s, mx_v)):
        raise ValueError(
            f"S/V values ({mn_s},{mn_v},{mx_s},{mx_v}) exceed the GIMP "
            "range [0, 100]"
        )
    return (mn_h // 2, mn_s * 2.55, mn_v * 2.55,
            mx_h // 2, mx_s * 2.55, mx_v * 2.55)
