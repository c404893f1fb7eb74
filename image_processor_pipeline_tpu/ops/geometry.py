"""Geometric device ops on padded images.

Representation: a padded canvas ``[H, W, C]`` (static shape under jit) holding
a valid region ``[0:h, 0:w]`` whose extents ``(h, w)`` may be traced values.
Invariant maintained by every op here: pixels outside the valid region are 0.

Batched variants are provided via jax.vmap (suffix ``_batch``).

Parity targets (behavior only, fresh implementation):
  - dihedral flips          reference symmetry.py:114-119 (cv2.flip 1/0/-1)
  - square / border crops   reference crop_square.py:196, recadrages.py:13-61
  - rotate with expand      reference rotations.py:96-109 (PIL rotate(expand=True))
  - tight content bbox      reference recadrages.py:63-82 (PIL getbbox)
  - separable resize        reference overlays.py:129 (PIL LANCZOS resize),
                            done as two matmuls with
                            on-device interpolation-weight matrices.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def valid_mask(h, w, H: int, W: int):
    """Boolean [H, W] mask of the valid region [0:h, 0:w]."""
    iy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    ix = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    return (iy < h) & (ix < w)


def apply_mask(img, h, w):
    """Zero pixels outside the valid region."""
    H, W = img.shape[-3], img.shape[-2]
    m = valid_mask(h, w, H, W)
    return jnp.where(m[..., None], img, jnp.zeros((), img.dtype))


# ---------------------------------------------------------------------------
# dihedral flips (cv2.flip semantics: 1=horizontal/x, 0=vertical/y, -1=both)
# ---------------------------------------------------------------------------

def flip_h(img, h, w):
    """Horizontal mirror (flip around the vertical axis), size-preserving."""
    W = img.shape[-2]
    out = jnp.flip(img, axis=-2)
    return jnp.roll(out, w - W, axis=-2)


def flip_v(img, h, w):
    """Vertical mirror (flip around the horizontal axis), size-preserving."""
    H = img.shape[-3]
    out = jnp.flip(img, axis=-3)
    return jnp.roll(out, h - H, axis=-3)


def flip_hv(img, h, w):
    """180° rotation (both flips)."""
    return flip_h(flip_v(img, h, w), h, w)


def dihedral(img, h, w, sym: str):
    """Apply one of the reference's symmetry generators 'o'/'h'/'v'/'hv'.

    Parity: reference symmetry.py:114-119.
    """
    if sym == "o":
        return img
    if sym == "h":
        return flip_h(img, h, w)
    if sym == "v":
        return flip_v(img, h, w)
    if sym == "hv":
        return flip_hv(img, h, w)
    raise ValueError(f"unknown symmetry {sym!r}")


# ---------------------------------------------------------------------------
# crops
# ---------------------------------------------------------------------------

def crop(img, y0, x0, ch, cw):
    """Extract the window [y0:y0+ch, x0:x0+cw] to the canvas origin.

    The window must lie inside the valid region (callers guarantee this, as
    the reference does for its square crop at crop_square.py:179-193).
    Implemented as a circular roll — no wraparound can reach the new valid
    region because y0+ch <= h <= H — followed by a mask.
    """
    out = jnp.roll(img, (-y0, -x0), axis=(-3, -2))
    return apply_mask(out, ch, cw)


def border_crop(img, h, w, top, bottom, left, right):
    """Crop margins off each side (reference recadrages.py:13-61).

    Margins are absolute pixel counts (the fraction-vs-absolute decision of
    reference recadrages.py:7-10 happens host-side).  Returns (img, ch, cw).
    """
    ch = h - top - bottom
    cw = w - left - right
    return crop(img, top, left, ch, cw), ch, cw


def content_bbox(img, h, w):
    """Tight bbox (y0, x0, bh, bw) of the image content.

    Parity: PIL Image.getbbox() as used at reference rotations.py:99-109 and
    recadrages.py:63-82.  Pillow >= 10 defaults ``alpha_only=True``: on an
    image WITH an alpha channel only the alpha plane is considered (a
    colored-but-transparent pixel does not extend the bbox); without one,
    any nonzero channel counts.  Mirrored here: 4-channel input → alpha
    bbox, 1/3-channel → any-channel bbox.  Returns (0, 0, 0, 0) for an
    all-zero (or fully transparent RGBA) image.
    """
    H, W = img.shape[-3], img.shape[-2]
    if img.shape[-1] == 4:
        nz = (img[..., 3] != 0) & valid_mask(h, w, H, W)
    else:
        nz = jnp.any(img != 0, axis=-1) & valid_mask(h, w, H, W)
    rows = jnp.any(nz, axis=-1)
    cols = jnp.any(nz, axis=-2)
    iy = jax.lax.iota(jnp.int32, H)
    ix = jax.lax.iota(jnp.int32, W)
    big = jnp.int32(1 << 30)
    y0 = jnp.min(jnp.where(rows, iy, big))
    y1 = jnp.max(jnp.where(rows, iy, -1))
    x0 = jnp.min(jnp.where(cols, ix, big))
    x1 = jnp.max(jnp.where(cols, ix, -1))
    any_nz = jnp.any(rows)
    y0 = jnp.where(any_nz, y0, 0)
    x0 = jnp.where(any_nz, x0, 0)
    bh = jnp.where(any_nz, y1 - y0 + 1, 0)
    bw = jnp.where(any_nz, x1 - x0 + 1, 0)
    return y0, x0, bh, bw


def fit_crop(img, h, w):
    """Tight-crop to content bbox; returns (img, bh, bw).

    Parity: reference recadrages.py:63-82 (fit_crop) and the post-rotation
    tight crop at rotations.py:99-109.  An EMPTY bbox (getbbox() None in
    PIL — e.g. a fully transparent RGBA image) keeps the image UNCROPPED:
    the reference saves the un-recadrée image at rotations.py:99-109 and
    copies the original at recadrages.py:74-76, it never emits a 0x0
    output.
    """
    y0, x0, bh, bw = content_bbox(img, h, w)
    empty = bh == 0
    # clamp: an upstream stage may hand a degenerate (negative) extent
    # (e.g. border margins larger than the image) — uncropped then means 0
    hj = jnp.maximum(jnp.asarray(h, bh.dtype), 0)
    wj = jnp.maximum(jnp.asarray(w, bw.dtype), 0)
    bh = jnp.where(empty, hj, bh)
    bw = jnp.where(empty, wj, bw)
    y0 = jnp.where(empty, 0, y0)
    x0 = jnp.where(empty, 0, x0)
    return crop(img, y0, x0, bh, bw), bh, bw


# ---------------------------------------------------------------------------
# arbitrary-angle rotation with expand (PIL semantics)
# ---------------------------------------------------------------------------

def rotated_size(h, w, angle_deg):
    """Expanded canvas extents after rotating (h, w) by angle (degrees CCW).

    Mirrors PIL's expand box (Image.rotate): transform the four corners
    around the center (w/2, h/2), then size = ceil(max) - floor(min) per
    axis.  A small epsilon snaps exact multiples of 90° (PIL handles those
    via its transpose fast path, never through this formula).
    """
    theta = jnp.deg2rad(jnp.asarray(angle_deg, jnp.float32))
    c = jnp.abs(jnp.cos(theta))
    s = jnp.abs(jnp.sin(theta))
    hf = jnp.asarray(h, jnp.float32)
    wf = jnp.asarray(w, jnp.float32)
    ex = (wf * c + hf * s) / 2
    ey = (wf * s + hf * c) / 2
    cx = wf / 2
    cy = hf / 2
    eps = 1e-4
    w2 = (jnp.ceil(cx + ex - eps) - jnp.floor(cx - ex + eps)).astype(jnp.int32)
    h2 = (jnp.ceil(cy + ey - eps) - jnp.floor(cy - ey + eps)).astype(jnp.int32)
    return h2, w2


def rotate_expand(img, h, w, angle_deg, interpolation: str = "nearest"):
    """Rotate CCW by ``angle_deg`` with canvas expansion, fill transparent.

    Parity: PIL Image.rotate(angle, expand=True) at reference rotations.py:96
    (nearest by default there — bicubic is commented out; we offer nearest
    and bilinear).  The rotated content lands at the canvas origin with new
    extents (h2, w2) as returned.  Outside pixels are 0 (transparent for
    RGBA), matching PIL's fillcolor=None on RGBA.

    Returns (out_img, h2, w2).
    """
    H, W = img.shape[-3], img.shape[-2]
    C = img.shape[-1]
    theta = jnp.deg2rad(jnp.asarray(angle_deg, jnp.float32))
    cos = jnp.cos(theta)
    sin = jnp.sin(theta)
    h2, w2 = rotated_size(h, w, angle_deg)

    cy_in = jnp.asarray(h, jnp.float32) / 2
    cx_in = jnp.asarray(w, jnp.float32) / 2
    # PIL places the output origin at floor(min corner coordinate), not at
    # a center-to-center alignment — keep the same subpixel offset.
    ex = (jnp.asarray(w, jnp.float32) * jnp.abs(cos)
          + jnp.asarray(h, jnp.float32) * jnp.abs(sin)) / 2
    ey = (jnp.asarray(w, jnp.float32) * jnp.abs(sin)
          + jnp.asarray(h, jnp.float32) * jnp.abs(cos)) / 2
    eps = 1e-4
    tx = jnp.floor(cx_in - ex + eps)
    ty = jnp.floor(cy_in - ey + eps)

    # output pixel centers in the pre-shift frame
    oy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0).astype(jnp.float32) + 0.5 + ty
    ox = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1).astype(jnp.float32) + 0.5 + tx
    dy = oy - cy_in
    dx = ox - cx_in
    # Inverse map of a visual-CCW rotation (image y axis points down):
    # src = R(-theta) @ dst  with screen coords, i.e.
    sx = cos * dx - sin * dy + cx_in
    sy = sin * dx + cos * dy + cy_in

    hf = jnp.asarray(h, jnp.float32)
    wf = jnp.asarray(w, jnp.float32)

    if interpolation == "nearest":
        ix = jnp.floor(sx).astype(jnp.int32)
        iy = jnp.floor(sy).astype(jnp.int32)
        inb = (sx >= 0) & (sx < wf) & (sy >= 0) & (sy < hf)
        ixc = jnp.clip(ix, 0, W - 1)
        iyc = jnp.clip(iy, 0, H - 1)
        flat = img.reshape(H * W, C)
        out = flat[(iyc * W + ixc).reshape(-1)].reshape(H, W, C)
        out = jnp.where(inb[..., None], out, jnp.zeros((), img.dtype))
    elif interpolation == "bilinear":
        # When angle and size are host-known (the direct-call parity case),
        # take the EXACT path: PIL's float64 matrix + double-double device
        # arithmetic — bit-identical to Pillow (closes the ±1 fill-boundary
        # diffs of the float32 formulation below).
        try:
            _exact_args = (float(angle_deg), int(h), int(w))
        except Exception:  # noqa: BLE001 — traced operands
            _exact_args = None
        if _exact_args is not None:
            return _rotate_bilinear_exact(img, *_exact_args)
        # PIL parity (Image.rotate → transform(AFFINE, BILINEAR) →
        # ImagingGenericTransform + bilinear_filter, verified by probing):
        #   - output→input affine built with angle NEGATED, trig rounded to
        #     15 decimals, center (w/2, h/2), expand shift -(nw-w)/2
        #     (Image.py rotate; NO floor — unlike the nearest fast path
        #     above, whose floor convention is also PIL-probed)
        #   - fill (all-zero) where xin∉[0,w) or yin∉[0,h) BEFORE the -0.5
        #     pixel-center shift
        #   - taps CLAMP (replicate) at the valid-region borders
        #   - final store is a C (UINT8) cast: truncation toward zero
        ar = -theta
        ca = jnp.cos(ar)
        sa = jnp.sin(ar)
        cx = wf / 2
        cy = hf / 2
        c0 = ca * (-cx) + sa * (-cy) + cx
        f0 = -sa * (-cx) + ca * (-cy) + cy
        nwf = jnp.asarray(w2, jnp.float32)
        nhf = jnp.asarray(h2, jnp.float32)
        ex2 = -(nwf - wf) / 2
        ey2 = -(nhf - hf) / 2
        c1 = ca * ex2 + sa * ey2 + c0
        f1 = -sa * ex2 + ca * ey2 + f0
        X = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1).astype(
            jnp.float32) + 0.5
        Y = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0).astype(
            jnp.float32) + 0.5
        xin = ca * X + sa * Y + c1
        yin = -sa * X + ca * Y + f1
        inb = (xin >= 0) & (xin < wf) & (yin >= 0) & (yin < hf)

        fx = xin - 0.5
        fy = yin - 0.5
        x0f = jnp.floor(fx)
        y0f = jnp.floor(fy)
        tx_w = (fx - x0f)[..., None]
        ty_w = (fy - y0f)[..., None]
        x0 = x0f.astype(jnp.int32)
        y0 = y0f.astype(jnp.int32)

        is_int = jnp.issubdtype(img.dtype, jnp.integer)
        premult = is_int and C == 4
        if premult:
            # PIL transforms RGBA via premultiplied alpha (Image.transform
            # converts RGBA→RGBa first): c' = MULDIV255(c, a), exact uint8
            # convention probed against Pillow
            ci = img[..., :3].astype(jnp.int32)
            ai = img[..., 3:].astype(jnp.int32)
            tmp = ci * ai + 128
            pre = ((tmp >> 8) + tmp) >> 8
            work = jnp.concatenate([pre, ai], axis=-1)
        else:
            work = img
        flat = work.astype(jnp.float32).reshape(H * W, C)

        def sample(yy, xx):
            # replicate-clamp at the VALID extent (h, w), not the canvas
            yyc = jnp.clip(yy, 0, h - 1)
            xxc = jnp.clip(xx, 0, w - 1)
            return flat[(yyc * W + xxc).reshape(-1)].reshape(H, W, C)

        v00 = sample(y0, x0)
        v01 = sample(y0, x0 + 1)
        v10 = sample(y0 + 1, x0)
        v11 = sample(y0 + 1, x0 + 1)
        # PIL's BILINEAR macro is v = a + d*(b - a) — keep the same form
        top = v00 + tx_w * (v01 - v00)
        bot = v10 + tx_w * (v11 - v10)
        outf = top + ty_w * (bot - top)
        outf = jnp.where(inb[..., None], outf, 0.0)
        if is_int:
            # (UINT8)v — truncation toward zero (values are >= 0)
            out_i = jnp.clip(jnp.floor(outf), 0, 255).astype(jnp.int32)
            if premult:
                # RGBa→RGBA back-conversion: floor(c'*255 / a), 0 where a=0
                a_out = out_i[..., 3:]
                rgb = jnp.where(
                    a_out > 0,
                    jnp.clip((out_i[..., :3] * 255)
                             // jnp.maximum(a_out, 1), 0, 255),
                    0,
                )
                out_i = jnp.concatenate([rgb, a_out], axis=-1)
            out = out_i.astype(img.dtype)
        else:
            out = outf.astype(img.dtype)
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")

    out = apply_mask(out, h2, w2)
    return out, h2, w2


# ---------------------------------------------------------------------------
# Double-double ("two-float") helpers for the PIL-exact bilinear path.
#
# XLA preserves IEEE f32 semantics (no reassociation; at most FMA
# contraction, which only makes Dekker's two-product MORE exact), so these
# error-free transforms give ~2^-45-relative accuracy — beyond float64's
# 2^-52 rounding, enough to reproduce every one of Pillow's double-precision
# decisions (fill predicate, tap floor, (UINT8) truncation) bit-for-bit.
# ---------------------------------------------------------------------------

def _dd_split(a):
    c = a * 4097.0  # 2^12 + 1 (Veltkamp split for f32)
    hi = c - (c - a)
    return hi, a - hi


def _dd_two_prod(a, b):
    p = a * b
    ah, al = _dd_split(a)
    bh, bl = _dd_split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _dd_two_sum(a, b):
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _dd_add(x, y):
    """(hi, lo) + (hi, lo) → renormalized (hi, lo)."""
    s, e = _dd_two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return _dd_two_sum(s, e)


def _dd_mul_f(x, f):
    """(hi, lo) * plain-f32 f → renormalized (hi, lo)."""
    p, e = _dd_two_prod(x[0], f)
    e = e + x[1] * f
    return _dd_two_sum(p, e)


def _dd_const(v):
    """Split a host float64 into an exact (hi, lo) f32 pair.

    Returned as jnp.float32 scalars so every downstream op (including the
    Veltkamp split inside _dd_two_prod) runs in f32 — a Python float would
    evaluate the split in float64, where c - (c - a) degenerates to a and
    the error-free transform silently breaks.
    """
    import numpy as _np

    hi = _np.float32(v)
    lo = _np.float32(_np.float64(v) - _np.float64(hi))
    return jnp.float32(hi), jnp.float32(lo)


def _dd_floor(x):
    """floor of a dd value, plus the exact fractional part as dd."""
    r = jnp.floor(x[0])
    d = x[0] - r                       # exact (Sterbenz-adjacent)
    fhi, flo = _dd_two_sum(d, x[1])    # frac in (-ulp, 1+ulp)
    wrap_up = fhi >= 1.0
    wrap_dn = fhi < 0.0
    r = r + wrap_up.astype(jnp.float32) - wrap_dn.astype(jnp.float32)
    fhi = fhi - wrap_up.astype(jnp.float32) + wrap_dn.astype(jnp.float32)
    return r, (fhi, flo)


def _pil_rotate_matrix(w: int, h: int, angle: float):
    """Pillow Image.rotate(expand=True) affine construction, replicated in
    float64 verbatim (trig rounded to 15 decimals, corner-based expand
    size, center-preserving translation).  Returns (matrix[6], nw, nh)."""
    import math

    angle = angle % 360.0
    rc_x, rc_y = w / 2.0, h / 2.0
    a_r = -math.radians(angle)
    m = [round(math.cos(a_r), 15), round(math.sin(a_r), 15), 0.0,
         round(-math.sin(a_r), 15), round(math.cos(a_r), 15), 0.0]

    def trans(x, y):
        return m[0] * x + m[1] * y + m[2], m[3] * x + m[4] * y + m[5]

    m[2], m[5] = trans(-rc_x, -rc_y)
    m[2] += rc_x
    m[5] += rc_y
    xx, yy = [], []
    for x, y in ((0, 0), (w, 0), (w, h), (0, h)):
        px, py = trans(x, y)
        xx.append(px)
        yy.append(py)
    nw = math.ceil(max(xx)) - math.floor(min(xx))
    nh = math.ceil(max(yy)) - math.floor(min(yy))
    m[2], m[5] = trans(-(nw - w) / 2.0, -(nh - h) / 2.0)
    return m, nw, nh


def _rotate_bilinear_exact(img, angle: float, h: int, w: int):
    """PIL-EXACT bilinear rotate-expand for host-known angle and size.

    The affine constants come from _pil_rotate_matrix (float64, Pillow's
    own formulas); the per-pixel affine, fill predicate, tap weights and
    blend run in double-double arithmetic, and RGBA goes through the same
    premultiplied round trip as Pillow's Image.transform.  Output is
    bit-identical to Image.rotate(angle, expand=True, resample=BILINEAR)
    (reference transforms/rotations.py:96 uses nearest; bilinear is
    framework surplus held to the BASELINE.md exactness clause).
    """
    H, W = img.shape[-3], img.shape[-2]
    C = img.shape[-1]

    angle_mod = angle % 360.0
    if angle_mod % 90.0 == 0.0:
        # Pillow's transpose fast path (Image.rotate: angle % 90 == 0 with
        # expand → Image.transpose, a raw pixel copy with NO resampling and
        # NO premultiply round trip) — replicate it or RGBA pixels with
        # alpha < 255 lose precision through premultiplication.
        k = int(angle_mod // 90.0) % 4       # CCW quarter turns
        rot = jnp.rot90(img[:h, :w], k=k, axes=(0, 1))
        nh, nw = rot.shape[0], rot.shape[1]
        out = jnp.zeros_like(img)
        out = out.at[:nh, :nw].set(rot)
        return out, nh, nw

    m, nw, nh = _pil_rotate_matrix(w, h, angle)
    a_hi, a_lo = _dd_const(m[0])
    b_hi, b_lo = _dd_const(m[1])
    c_dd = _dd_const(m[2])
    d_hi, d_lo = _dd_const(m[3])
    e_hi, e_lo = _dd_const(m[4])
    f_dd = _dd_const(m[5])

    X = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1).astype(
        jnp.float32) + 0.5            # exact in f32 (≤ 13 mantissa bits)
    Y = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0).astype(
        jnp.float32) + 0.5

    def affine(phi_hi, phi_lo, psi_hi, psi_lo, k_dd):
        t1 = _dd_two_prod(phi_hi, X)
        t2 = _dd_two_prod(psi_hi, Y)
        acc = _dd_add(t1, t2)
        acc = _dd_add(acc, k_dd)
        return _dd_add(acc, _dd_two_sum(phi_lo * X, psi_lo * Y))

    xin = affine(a_hi, a_lo, b_hi, b_lo, c_dd)
    yin = affine(d_hi, d_lo, e_hi, e_lo, f_dd)

    wf, hf = jnp.float32(w), jnp.float32(h)

    def dd_ge0(v):
        return (v[0] > 0) | ((v[0] == 0) & (v[1] >= 0))

    def dd_lt(v, bound):
        return (v[0] < bound) | ((v[0] == bound) & (v[1] < 0))

    inb = dd_ge0(xin) & dd_lt(xin, wf) & dd_ge0(yin) & dd_lt(yin, hf)

    x0f, dx = _dd_floor(_dd_add(xin, (-0.5, 0.0)))
    y0f, dy = _dd_floor(_dd_add(yin, (-0.5, 0.0)))
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)

    is_int = jnp.issubdtype(img.dtype, jnp.integer)
    premult = is_int and C == 4
    if premult:
        ci = img[..., :3].astype(jnp.int32)
        ai = img[..., 3:].astype(jnp.int32)
        tmp = ci * ai + 128
        pre = ((tmp >> 8) + tmp) >> 8
        work = jnp.concatenate([pre, ai], axis=-1)
    else:
        work = img
    flat = work.astype(jnp.float32).reshape(H * W, C)

    def sample(yy, xx):
        yyc = jnp.clip(yy, 0, h - 1)
        xxc = jnp.clip(xx, 0, w - 1)
        return flat[(yyc * W + xxc).reshape(-1)].reshape(H, W, C)

    v00 = sample(y0, x0)
    v01 = sample(y0, x0 + 1)
    v10 = sample(y0 + 1, x0)
    v11 = sample(y0 + 1, x0 + 1)

    dx = (dx[0][..., None], dx[1][..., None])
    dy = (dy[0][..., None], dy[1][..., None])

    def blend_f(va, vb, t_dd):
        # BILINEAR(v, a, b, d) = a + d*(b - a); taps are f32-exact ints,
        # so (vb - va) is exact and the dd product/add carry the rest
        diff = vb - va
        prod = _dd_mul_f(t_dd, diff)
        return _dd_add((va, jnp.zeros_like(va)), prod)

    def blend_dd(va_dd, vb_dd, t_dd):
        diff = _dd_add(vb_dd, (-va_dd[0], -va_dd[1]))
        p = _dd_two_prod(t_dd[0], diff[0])
        e = p[1] + (t_dd[0] * diff[1] + t_dd[1] * diff[0])
        prod = _dd_two_sum(p[0], e)
        return _dd_add(va_dd, prod)

    top = blend_f(v00, v01, dx)
    bot = blend_f(v10, v11, dx)
    outv = blend_dd(top, bot, dy)

    if is_int:
        r, _frac = _dd_floor(outv)     # (UINT8)v truncation (values ≥ 0)
        out_i = jnp.clip(r, 0, 255).astype(jnp.int32)
        out_i = jnp.where(inb[..., None], out_i, 0)
        if premult:
            a_out = out_i[..., 3:]
            rgb = jnp.where(
                a_out > 0,
                jnp.clip((out_i[..., :3] * 255)
                         // jnp.maximum(a_out, 1), 0, 255),
                0,
            )
            out_i = jnp.concatenate([rgb, a_out], axis=-1)
        out = out_i.astype(img.dtype)
    else:
        outf = outv[0] + outv[1]
        out = jnp.where(inb[..., None], outf, 0.0).astype(img.dtype)

    out = apply_mask(out, nh, nw)
    return out, nh, nw


def rotate_fixed(img, h, w, angle_deg):
    """Rotate CCW about the valid-region center WITHOUT canvas expansion
    (PIL rotate(angle, expand=False) semantics): same (h, w), corners that
    leave the frame are cut, uncovered pixels are 0.  Nearest sampling.

    Used by the fused 512px benchmark chain where static shapes must stay
    flat through the whole program.
    """
    H, W = img.shape[-3], img.shape[-2]
    C = img.shape[-1]
    theta = jnp.deg2rad(jnp.asarray(angle_deg, jnp.float32))
    cos = jnp.cos(theta)
    sin = jnp.sin(theta)
    cy = jnp.asarray(h, jnp.float32) / 2
    cx = jnp.asarray(w, jnp.float32) / 2
    oy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0).astype(jnp.float32) + 0.5
    ox = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1).astype(jnp.float32) + 0.5
    dy = oy - cy
    dx = ox - cx
    sx = cos * dx - sin * dy + cx
    sy = sin * dx + cos * dy + cy
    ix = jnp.floor(sx).astype(jnp.int32)
    iy = jnp.floor(sy).astype(jnp.int32)
    inb = (sx >= 0) & (sx < jnp.asarray(w, jnp.float32)) & \
          (sy >= 0) & (sy < jnp.asarray(h, jnp.float32))
    ixc = jnp.clip(ix, 0, W - 1)
    iyc = jnp.clip(iy, 0, H - 1)
    flat = img.reshape(H * W, C)
    out = flat[(iyc * W + ixc).reshape(-1)].reshape(H, W, C)
    out = jnp.where(inb[..., None], out, jnp.zeros((), img.dtype))
    return apply_mask(out, h, w)


def shift_bits_for(size: int) -> int:
    """Bit passes needed so the shear-shift offset covers ±0.354*size
    (the worst-case Paeth shift at ±45°).  9 bits up to 720px, 10 to 1444..."""
    need = int(0.35356 * size) + 2
    bits = 1
    while (1 << (bits - 1)) < need:
        bits += 1
    return max(bits, 4)


def shear13_bits_for(size: int) -> int:
    """Bit passes for the FIRST and THIRD Paeth shears only: their shift
    is rint(tan(φ/2)·y) with |φ| ≤ 45°, so |t| ≤ tan(22.5°)·size/2 ≈
    0.208·size — one bit fewer than the middle (sin) shear up to 1228px.
    Same decomposition, tighter static offset, one roll+select pass saved
    per outer shear."""
    need = int(0.20711 * size) + 2
    bits = 1
    while (1 << (bits - 1)) < need:
        bits += 1
    return max(bits, 4)


# the scope names these passes in profiler traces (bench.py --trace)
@jax.named_scope("shear")
def _row_shift(img, shifts, axis: int = 1, bits: int = 9):
    """Shift each row (axis=1) or column (axis=0) by a per-index amount,
    zero-filling vacated pixels — NO gather.

    The per-row shift t is decomposed into binary components of
    u = t + 2^(bits-1) >= 0: for each bit k the rows with that bit set take
    a UNIFORM circular roll by 2^k, selected per row (roll+select are
    elementwise ops XLA fuses); a final constant roll removes the offset
    and an analytic validity mask kills wrapped pixels.  ~`bits` fused
    passes instead of a per-element gather.
    """
    size = img.shape[axis]
    offset = 1 << (bits - 1)
    t = jnp.clip(shifts, -(offset - 1), offset - 1)
    u = t + offset

    # per-index selector broadcast over the shifted axis
    sel_shape = [1, 1, 1]
    sel_shape[1 - axis] = t.shape[0]
    out = img
    for k in range(bits):
        rolled = jnp.roll(out, 1 << k, axis=axis)
        mask = ((u >> k) & 1).astype(bool).reshape(sel_shape)
        out = jnp.where(mask, rolled, out)
    out = jnp.roll(out, -offset, axis=axis)

    # zero wrapped pixels: position x is valid iff x - t lies in [0, size)
    pos = jax.lax.broadcasted_iota(jnp.int32, (img.shape[0], img.shape[1]),
                                   axis)
    tt = t.reshape(sel_shape[0], sel_shape[1])
    valid = (pos >= tt) & (pos < size + tt)
    return jnp.where(valid[..., None], out, jnp.zeros((), img.dtype))


def rotate_square_shear(img, angle_deg):
    """Rotate a square, fully-valid image CCW about its center on a fixed
    canvas (expand=False) using Paeth's three-shear decomposition.

    Each shear is a per-row (or per-column, via transpose) integer shift —
    a pure pixel permutation, so no resampling artifacts beyond nearest
    rounding — executed as roll+select passes instead of the per-element
    gather of `rotate_fixed`.

    Multiples of 90° are handled exactly by rot90; the residual angle in
    [-45°, 45°] goes through the shears.  Pixels leaving the frame are cut,
    uncovered pixels are zero-filled — same contract as `rotate_fixed`.
    """
    H, W, C = img.shape
    if H != W:
        raise ValueError("rotate_square_shear requires a square canvas")
    quad, sh1, sh2 = shear_params(angle_deg, H)
    # decomposed quarter-turn: transpose-where + two flip-wheres (3 passes)
    # instead of a vmapped lax.switch that computes all 4 branches
    # (2 transposes + 4 flips) then selects.  Same permutations:
    #   q1 = flip0∘T, q2 = flip0∘flip1, q3 = flip1∘T.
    t = (quad == 1) | (quad == 3)
    fy = (quad == 1) | (quad == 2)
    fx = (quad == 2) | (quad == 3)
    img = jnp.where(t, jnp.swapaxes(img, 0, 1), img)
    img = jnp.where(fy, jnp.flip(img, axis=0), img)
    img = jnp.where(fx, jnp.flip(img, axis=1), img)
    # the outer (tan) shears cover |t| <= 0.208*H — one bit pass fewer
    # than the middle (sin) shear; the permutation is identical
    img = _row_shift(img, sh1, axis=1, bits=shear13_bits_for(H))
    img = _row_shift(img, sh2, axis=0, bits=shift_bits_for(H))
    img = _row_shift(img, sh1, axis=1, bits=shear13_bits_for(H))
    return img


def shear_params(angle_deg, H: int):
    """(quad, sh1, sh2) for the Paeth 3-shear rotation on an H×H canvas.

    The single source of truth for the shear permutation — both the device
    path (rotate_square_shear above) and the native CPU chain executor
    (native/ipp_cpu.cpp, fed through transforms/fused.py:native_fn) consume
    these, so the two backends apply the IDENTICAL pixel permutation.

    quad ∈ [0, 4): exact visual-CCW quarter turns applied first;
    sh1 [H] int32: per-row x-shift of the outer (tan) shears;
    sh2 [H] int32: per-column y-shift of the middle (sin) shear.
    Both shift vectors carry the clip _row_shift would apply (its internal
    clip is then idempotent).
    """
    theta = jnp.deg2rad(jnp.asarray(angle_deg, jnp.float32))
    theta = jnp.mod(theta, 2 * jnp.pi)
    # quadrant reduction: visual-CCW quarter turns are exact
    quad = jnp.floor((theta + jnp.pi / 4) / (jnp.pi / 2)).astype(jnp.int32) % 4
    phi = theta - quad.astype(jnp.float32) * (jnp.pi / 2)  # in [-45°, 45°]

    # Paeth: R(phi) = ShearX(a) · ShearY(b) · ShearX(a); with the image y
    # axis pointing down, visual-CCW needs a = tan(phi/2), b = -sin(phi)
    # (solve Sx·Sy·Sx = [[cos, sin], [-sin, cos]]).
    a = jnp.tan(phi / 2)
    b = -jnp.sin(phi)
    c = (jnp.float32(H) - 1.0) / 2.0
    iy = (jax.lax.broadcasted_iota(jnp.int32, (H, 1), 0)
          .astype(jnp.float32)[:, 0] - c)

    sh1 = jnp.rint(a * iy).astype(jnp.int32)   # x-shift per row
    sh2 = jnp.rint(b * iy).astype(jnp.int32)   # y-shift per column
    o13 = 1 << (shear13_bits_for(H) - 1)
    o2 = 1 << (shift_bits_for(H) - 1)
    sh1 = jnp.clip(sh1, -(o13 - 1), o13 - 1)
    sh2 = jnp.clip(sh2, -(o2 - 1), o2 - 1)
    return quad, sh1, sh2


# ---------------------------------------------------------------------------
# separable resize via interpolation-matrix matmuls
# ---------------------------------------------------------------------------

def _filter_fn(name: str):
    if name == "bilinear":
        def f(x):
            ax = jnp.abs(x)
            return jnp.maximum(0.0, 1.0 - ax)
        return f, 1.0
    if name == "lanczos":
        def f(x):
            ax = jnp.abs(x)
            pix = jnp.pi * x
            # sinc(x) * sinc(x/3) on |x| < 3, 1 at 0
            safe = jnp.where(ax < 1e-7, 1.0, pix)
            val = (jnp.sin(safe) / safe) * (jnp.sin(safe / 3.0) / (safe / 3.0))
            val = jnp.where(ax < 1e-7, 1.0, val)
            return jnp.where(ax < 3.0, val, 0.0)
        return f, 3.0
    if name == "nearest":
        def f(x):
            return jnp.where((x >= -0.5) & (x < 0.5), 1.0, 0.0)
        return f, 0.5
    raise ValueError(f"unknown resize filter {name!r}")


def resize_matrix(in_size, out_size, In: int, Out: int, method: str):
    """Dense [Out, In] row-normalized interpolation matrix (PIL semantics).

    ``in_size``/``out_size`` may be traced; ``In``/``Out`` are the static
    canvas extents.  Rows >= out_size and columns >= in_size are zero.
    PIL convention: center = (i + 0.5) * scale, window support scaled by
    max(scale, 1), weights normalized over the in-bounds window.
    """
    f, support = _filter_fn(method)
    inf = jnp.asarray(in_size, jnp.float32)
    outf = jnp.asarray(out_size, jnp.float32)
    scale = inf / jnp.maximum(outf, 1.0)
    filterscale = jnp.maximum(scale, 1.0)
    sup = support * filterscale

    i = jax.lax.broadcasted_iota(jnp.int32, (Out, In), 0).astype(jnp.float32)
    k = jax.lax.broadcasted_iota(jnp.int32, (Out, In), 1).astype(jnp.float32)
    center = (i + 0.5) * scale
    x = (k + 0.5 - center) / filterscale
    wgt = f(x)
    # restrict to the window and to valid input columns
    wgt = jnp.where(jnp.abs(k + 0.5 - center) <= sup, wgt, 0.0)
    wgt = jnp.where(k < inf, wgt, 0.0)
    norm = jnp.sum(wgt, axis=1, keepdims=True)
    wgt = wgt / jnp.where(norm == 0, 1.0, norm)
    wgt = jnp.where(i < outf, wgt, 0.0)
    return wgt


def resize(img, h, w, out_h, out_w, method: str = "lanczos",
           out_canvas: Tuple[int, int] = None):
    """Separable resize of the valid region to (out_h, out_w).

    Builds row/column interpolation matrices on device and runs two
    matmuls instead of a gather-based warp.  Replaces PIL
    Image.resize(..., LANCZOS) at reference overlays.py:129.

    Returns the resized image on an ``out_canvas`` (defaults to the input
    canvas) with zeros outside [0:out_h, 0:out_w].
    """
    H, W = img.shape[-3], img.shape[-2]
    Ho, Wo = out_canvas if out_canvas is not None else (H, W)
    Ay = resize_matrix(h, out_h, H, Ho, method)          # [Ho, H]
    Ax = resize_matrix(w, out_w, W, Wo, method)          # [Wo, W]
    is_int = jnp.issubdtype(img.dtype, jnp.integer)
    imf = img.astype(jnp.float32)
    # PIL resamples horizontally first and materializes a rounded uint8
    # intermediate, then resamples vertically — match that rounding order.
    # HIGHEST: the default f32 matmul precision on a GPU is TF32, whose
    # ~3 decimal digits break the rint boundaries of the PIL contract
    hi = jax.lax.Precision.HIGHEST
    tmp = jnp.einsum("pw,hwc->hpc", Ax, imf, precision=hi,
                     preferred_element_type=jnp.float32)
    if is_int:
        tmp = jnp.clip(jnp.rint(tmp), 0, 255)
    out = jnp.einsum("oh,hpc->opc", Ay, tmp, precision=hi,
                     preferred_element_type=jnp.float32)
    if is_int:
        out = jnp.clip(jnp.rint(out), 0, 255).astype(img.dtype)
    else:
        out = out.astype(img.dtype)
    return apply_mask(out, out_h, out_w)


# ---------------------------------------------------------------------------
# batched wrappers
# ---------------------------------------------------------------------------

flip_h_batch = jax.vmap(flip_h)
flip_v_batch = jax.vmap(flip_v)
flip_hv_batch = jax.vmap(flip_hv)
crop_batch = jax.vmap(crop)
fit_crop_batch = jax.vmap(fit_crop)
rotate_expand_batch = jax.vmap(
    functools.partial(rotate_expand, interpolation="nearest")
)
rotate_expand_bilinear_batch = jax.vmap(
    functools.partial(rotate_expand, interpolation="bilinear")
)
