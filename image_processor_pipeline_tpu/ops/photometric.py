"""Photometric enhancement ops (PIL ImageEnhance / ImageFilter semantics).

Parity targets: reference tranfo.py:9-55 — Brightness, Contrast, Color each
scaled by a random factor, optional GaussianBlur, optional per-channel RGB
gain.  The reference's per-intensity gain redraw (tranfo.py:48-50) is a
defect (SURVEY.md §2.7 #12); the intent — one gain per channel — is
implemented here.

All elementwise / small-conv math in float32, fused by XLA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _luminance_i32(img_i32):
    """ITU-R 601-2 luma EXACTLY as PIL convert('L') computes it.

    Pillow's L conversion is fixed point (libImaging convert.c):
        L = (R*19595 + G*38470 + B*7471 + 0x8000) >> 16
    A float ``rint((299R + 587G + 114B)/1000)`` formulation is off by one on
    9,112 of the 2^24 RGB triples (19595/65536 != 0.299 exactly), so the
    integer form is both the exact one and the cheap one (no divide).
    """
    return (img_i32[..., 0] * 19595 + img_i32[..., 1] * 38470
            + img_i32[..., 2] * 7471 + 0x8000) >> 16


def _blend_trunc(deg_f, img_f, factor):
    """PIL Image.blend semantics, exactly.

    Pillow's C blend (Blend.c) computes ``in1 + alpha*(in2 - in1)`` in
    float32 and TRUNCATES via a ``(UINT8)`` cast — it does not round.  The
    extrapolation branch (alpha outside [0,1]) clamps to [0,255] first; the
    interpolation branch needs no clamp (the lerp stays in range).  A single
    floor(clip(...)) reproduces both branches bit-exactly (verified vs PIL
    over exhaustive values × many factors).
    """
    t = deg_f + jnp.asarray(factor, jnp.float32) * (img_f - deg_f)
    return jnp.floor(jnp.clip(t, 0.0, 255.0))


def brightness(img, factor):
    """PIL ImageEnhance.Brightness: blend(black, img, factor), truncated."""
    f = img.astype(jnp.float32) * jnp.asarray(factor, jnp.float32)
    return jnp.floor(jnp.clip(f, 0.0, 255.0)).astype(img.dtype)


def exact_mean_round_half_up(lum, n, mask=None):
    """floor(sum(lum)/n + 0.5) with an EXACT integer tie decision.

    PIL's Contrast mean is ``int(ImageStat.mean + 0.5)`` computed in double;
    device f64 is slow or absent, so: estimate the mean from an exactly-split
    (hi/lo uint16-limb) float total, then correct it with the exact integer
    residual d = sum(lum) - m̂·n, computed as a wrap-exact int32 sum of
    per-pixel (lum - m̂) — intermediate int32 overflow is modular and the
    final residual is small, so the wrapped sum is the true value.  The
    estimate is within ±1 (proved by the limb bounds); we correct over a
    ±2 window for margin.  lum: int32 luma; n: int32 valid count >= 1.
    """
    lum_m = lum if mask is None else jnp.where(mask, lum, 0)
    lum_u = lum_m.astype(jnp.uint32)
    rows = jnp.sum(lum_u, axis=-1)
    hi = jnp.sum(rows >> 16).astype(jnp.float32)
    lo = jnp.sum(rows & 0xFFFF).astype(jnp.float32)
    total_f = hi * 65536.0 + lo
    n = jnp.asarray(n, jnp.int32)
    m_hat = jnp.floor(total_f / n.astype(jnp.float32) + 0.5).astype(jnp.int32)
    m_hat = jnp.clip(m_hat, 0, 255)
    resid = lum_m - m_hat if mask is None else jnp.where(mask, lum - m_hat, 0)
    d = jnp.sum(resid)
    # mean = max{m : f(m) >= 0} with f(m) = 2(T - m n) + n; f(m̂) = 2d + n
    f0 = 2 * d + n
    two_n = 2 * n
    adj = ((f0 >= two_n).astype(jnp.int32)
           + (f0 >= 2 * two_n).astype(jnp.int32)
           - (f0 < 0).astype(jnp.int32)
           - (f0 < -two_n).astype(jnp.int32))
    return m_hat + adj


def contrast(img, factor, h=None, w=None):
    """PIL ImageEnhance.Contrast: blend(gray(mean_L), img, factor).

    mean_L is PIL's ``int(ImageStat.Stat(convert('L')).mean[0] + 0.5)`` over
    the valid region — an exact integer sum (order-independent, so the mean
    is identical no matter how the image is laid out: pre/post flip,
    sharded, kernel-tiled), rounded half-up by exact_mean_round_half_up.
    """
    lum = _luminance_i32(img.astype(jnp.int32))
    H, W = img.shape[-3], img.shape[-2]
    if h is not None:
        from image_processor_pipeline_tpu.ops.geometry import valid_mask
        m = valid_mask(h, w, H, W)
        n = jnp.maximum(jnp.sum(m), 1)
        mean = exact_mean_round_half_up(lum, n, mask=m)
    else:
        mean = exact_mean_round_half_up(lum, H * W)
    out = _blend_trunc(mean.astype(jnp.float32), img.astype(jnp.float32),
                       factor)
    return out.astype(img.dtype)


def color_balance(img, factor):
    """PIL ImageEnhance.Color: blend(grayscale, img, factor), truncated."""
    lum = _luminance_i32(img.astype(jnp.int32)).astype(jnp.float32)[..., None]
    out = _blend_trunc(lum, img.astype(jnp.float32), factor)
    return out.astype(img.dtype)


def box_radius_bound(sigma_max: float, passes: int = 3) -> int:
    """Static tap-window bound for gaussian_blur: the smallest max_radius
    that covers the box radius Pillow derives from ``sigma_max`` (the far
    taps sit at r+1 <= max_radius+1, so max_radius = floor(fr) suffices;
    +1 slack absorbs f32 rounding of the radius formula)."""
    import math

    sigma2 = sigma_max * sigma_max / passes
    L = math.sqrt(12.0 * sigma2 + 1.0)
    ll = math.floor((L - 1.0) / 2.0)
    a = (2 * ll + 1) * (ll * (ll + 1) - 3 * sigma2)
    a /= 6 * (sigma2 - (ll + 1) * (ll + 1))
    return int(ll + a) + 1


def gaussian_blur(img, sigma, passes: int = 3, max_radius: int = 12,
                  h=None, w=None, sigma_max=None):
    """Gaussian blur BIT-EXACT vs PIL ImageFilter.GaussianBlur.

    Pillow implements GaussianBlur(radius=sigma) as ``passes`` (3) successive
    fractional-radius box blurs per axis (Gwosdek et al. extended box
    filter): per-pass float box radius fr = l + a with
      L = sqrt(12 sigma^2/passes + 1),  l = floor((L-1)/2),
      a = (2l+1)(l(l+1) - 3 sigma^2/n) / (6(sigma^2/n - (l+1)^2)),
    horizontal passes first then vertical.  Each 1-D pass (BoxBlur.c) is
    INTEGER fixed point, not a float convolution: with r = (int)fr,
      ww = (UINT32)(2^24 / (fr*2 + 1))          # float divide, truncated
      fw = (2^24 - (2r+1)*ww) / 2               # leftover split on far taps
      out[x] = (ww*sum(in[x-r..x+r]) + fw*(in[x-r-1] + in[x+r+1])
                + 2^23) >> 24
    with clamp-to-edge taps.  The float weights + rint formulation this
    replaces was off by one at descale boundaries; this pipeline matches
    PIL exactly (validated over 331 shape/sigma/RGB black-box cases,
    including the fr*2+1 divide being float32 — the double variant differs
    at sigma=1.0).  Weight sums are <= 255·2^24 + 510·fw < 2^32, exactly
    Pillow's own uint32 headroom.

    ``h``/``w`` give the valid-region extent on a padded canvas (padded-canvas
    invariant: content lives in [0:h, 0:w]).  Clamp-extension then happens at
    the VALID boundary — the last valid row/column is replicated into the
    padding before each 1-D pass — so padding pixels never bleed into the
    blurred valid region (they are what PIL would read past the edge).
    Without h/w the canvas edge is the clamp boundary (exact-size images).

    Taps are statically bounded by ``max_radius``: a sigma whose Pillow box
    radius exceeds it would silently clamp and the output would no longer
    be PIL-exact (fw would also be derived from the clamped r against the
    unclamped ww, so the tap weights would not sum to 2^24).  The bound is
    therefore VALIDATED at trace time: pass ``sigma_max`` (the top of the
    sigma range) whenever ``sigma`` is traced — both are checked against
    box_radius_bound and a violation raises instead of degrading.
    """
    if sigma_max is not None and box_radius_bound(
            float(sigma_max), passes) > max_radius:
        raise ValueError(
            f"sigma_max={sigma_max} needs a box window of "
            f"{box_radius_bound(float(sigma_max), passes)} taps but "
            f"max_radius={max_radius}; raise max_radius "
            "(see box_radius_bound)")
    try:
        _sigma_conc = float(sigma)
    except Exception:  # noqa: BLE001 — traced sigma
        _sigma_conc = None
    if _sigma_conc is not None and box_radius_bound(
            _sigma_conc, passes) > max_radius:
        raise ValueError(
            f"sigma={_sigma_conc} needs a box window of "
            f"{box_radius_bound(_sigma_conc, passes)} taps but "
            f"max_radius={max_radius}; raise max_radius "
            "(see box_radius_bound)")
    sig = jnp.maximum(jnp.asarray(sigma, jnp.float32), 1e-6)
    sigma2 = sig * sig / passes
    L = jnp.sqrt(12.0 * sigma2 + 1.0)
    l = jnp.floor((L - 1.0) / 2.0)
    a = (2 * l + 1) * (l * (l + 1) - 3 * sigma2)
    a = a / (6 * (sigma2 - (l + 1) * (l + 1)))
    fr = l + a                                   # Pillow's float box radius
    r = jnp.minimum(fr.astype(jnp.int32), max_radius)   # (int)floatRadius
    ww = (jnp.float32(1 << 24) / (fr * 2 + 1)).astype(jnp.uint32)
    fw = (jnp.uint32(1 << 24)
          - (2 * r + 1).astype(jnp.uint32) * ww) // jnp.uint32(2)

    def extend(arr, axis, n):
        """Replicate the last valid line (index n-1 along axis) into the
        padding, so canvas-edge clamping equals valid-edge clamping."""
        if n is None:
            return arr
        idx = jnp.minimum(jnp.arange(arr.shape[axis]), n - 1)
        return jnp.take(arr, idx, axis=axis)

    def box1d(arr, axis):
        """One exact Pillow box pass along ``axis`` (arr: uint32 <= 255).

        Taps are edge-padded static slices (index-clip gathers measured
        ~an order of magnitude slower on the XLA CPU backend)."""
        La = arr.shape[axis]
        pad = [(0, 0)] * arr.ndim
        pad[axis] = (max_radius + 1, max_radius + 1)
        ap = jnp.pad(arr, pad, mode="edge")
        bulk = jnp.zeros(arr.shape, jnp.uint32)
        for k in range(-max_radius - 1, max_radius + 2):
            ak = abs(k)
            wk = jnp.where(ak <= r, ww,
                           jnp.where(ak == r + 1, fw, jnp.uint32(0)))
            sl = [slice(None)] * arr.ndim
            sl[axis] = slice(k + max_radius + 1, k + max_radius + 1 + La)
            bulk = bulk + ap[tuple(sl)] * wk
        return (bulk + jnp.uint32(1 << 23)) >> jnp.uint32(24)

    out = jnp.clip(img, 0, 255).astype(jnp.uint32)
    # Pillow: horizontal passes, then vertical.  Re-extend before every pass:
    # after a pass the padding holds a blur of (edge ∪ constant), not the
    # clamped value PIL would read, so a single up-front extension is wrong.
    for axis, n in ((-2, w), (-3, h)):
        for _ in range(passes):
            out = extend(out, axis, n)
            out = box1d(out, axis)
    return out.astype(img.dtype)


def channel_gains(img, gains):
    """Per-channel multiplicative gain, clamped to [0, 255].

    Intent of reference tranfo.py:46-51 (one gain per RGB channel).
    """
    f = img.astype(jnp.float32) * jnp.asarray(gains, jnp.float32)
    return jnp.clip(jnp.rint(f), 0, 255).astype(img.dtype)


def enhance(img, h, w, b_factor, c_factor, col_factor,
            blur_sigma, apply_blur, rgb_gains, apply_rgb,
            blur_max_radius: int = 12, blur_sigma_max=None):
    """Full enhance chain of reference tranfo.py:9-55 on one image.

    ``apply_blur`` / ``apply_rgb`` are traced booleans (the 30% Bernoulli
    draws of the 'sample' pairing mode, reference pipeline.py:209-225).
    ``blur_max_radius`` statically bounds the box tap window — pass
    box_radius_bound(sigma_max) when the sigma range is known (the
    reference draws [0.5, 3] → 3, a 3x cut in blur taps) along with
    ``blur_sigma_max`` so the bound is validated at trace time.
    """
    out = brightness(img, b_factor)
    out = contrast(out, c_factor, h, w)
    out = color_balance(out, col_factor)
    blurred = gaussian_blur(out, blur_sigma, max_radius=blur_max_radius,
                            h=h, w=w, sigma_max=blur_sigma_max)
    out = jnp.where(apply_blur, blurred, out)
    gained = channel_gains(out, rgb_gains)
    out = jnp.where(apply_rgb, gained, out)
    from image_processor_pipeline_tpu.ops.geometry import apply_mask
    return apply_mask(out, h, w)


enhance_batch = jax.vmap(enhance)
