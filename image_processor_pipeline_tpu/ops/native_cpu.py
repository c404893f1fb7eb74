"""ctypes bindings for the native CPU compute backend (native/ipp_cpu.cpp).

When no accelerator is present, the stage engine can route select
transforms' batch compute to these bit-exact C++ twins of the device ops
(the XLA CPU backend interprets the same math far slower than a tight
scalar loop).  `available()` gates every call; everything degrades to the
jit path when the library can't build.

The C++ kernels replicate the SAME fixed-point formulations as the JAX
ops (ops/color.py, ops/photometric.py) — equivalence is pinned bit-exact
by tests/test_native_cpu.py against both the jit path and the original
libraries (cv2 / PIL).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib = None
_build_failed = False


def _bind_symbols(lib) -> None:
    lib.ipp_cpu_colormask_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.ipp_cpu_colormask_batch.restype = None
    lib.ipp_cpu_enhance_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.ipp_cpu_enhance_batch.restype = None
    u8p, i32p, f32p = (ctypes.POINTER(ctypes.c_uint8),
                       ctypes.POINTER(ctypes.c_int32),
                       ctypes.POINTER(ctypes.c_float))
    lib.ipp_cpu_chain_batch.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,  # imgs, sizes
        i32p, ctypes.c_int,                                   # ops
        i32p, i32p, i32p,                                     # rot params
        i32p,                                                 # flip codes
        i32p, i32p, i32p, i32p,                               # mask params
        f32p, u8p,                                            # enhance
        f32p,                                                 # border margins
        i32p,                                                 # ccl params
        u8p, i32p, ctypes.c_int,                              # outs
    ]
    lib.ipp_cpu_chain_batch.restype = None
    lib.ipp_cpu_flips_batch.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, i32p, ctypes.c_int, u8p, ctypes.c_int,
    ]
    lib.ipp_cpu_flips_batch.restype = None
    lib.ipp_cpu_overlay_batch.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
        u8p, ctypes.c_int, ctypes.c_int, i32p, i32p, u8p, ctypes.c_int,
    ]
    lib.ipp_cpu_overlay_batch.restype = None
    lib.ipp_cpu_rotations_batch.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
        ctypes.POINTER(ctypes.c_double), i32p, ctypes.c_int, u8p, i32p,
        ctypes.c_int,
    ]
    lib.ipp_cpu_rotations_batch.restype = None
    lib.ipp_cpu_ccl_batch.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
        ctypes.c_int, ctypes.c_int, u8p, i32p, ctypes.c_int,
    ]
    lib.ipp_cpu_ccl_batch.restype = None


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is None and not _build_failed:
            from image_processor_pipeline_tpu.io.native import (
                load_native_library,
            )

            _lib = load_native_library("libipp_cpu.so", "ipp_cpu.cpp",
                                       _bind_symbols)
            _build_failed = _lib is None
        return _lib


def available() -> bool:
    return _load() is not None


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def colormask_batch(imgs: np.ndarray, sizes: np.ndarray,
                    bounds: np.ndarray, zones: np.ndarray,
                    n_threads: int = 1) -> Optional[np.ndarray]:
    """Batched HSV color-mask alpha: cv2-exact twin of
    ops/color.py:color_mask_alpha.

    imgs: [N, H, W, 3] uint8 canvases; sizes: [N, 2] int32 valid (h, w);
    bounds: [F, 6] int32 (lo HSV, hi HSV) — already saturate-rounded the
    way cv2.inRange casts its bound scalars; zones: [F, 4] int32 margins.
    Returns [N, H, W] uint8 alpha (zero outside each valid region), or
    None when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    imgs = np.ascontiguousarray(imgs, np.uint8)
    n, H, W = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    sizes = np.ascontiguousarray(sizes, np.int32)
    bounds = np.ascontiguousarray(bounds, np.int32).reshape(-1, 6)
    zones = np.ascontiguousarray(zones, np.int32).reshape(-1, 4)
    alphas = np.zeros((n, H, W), np.uint8)
    lib.ipp_cpu_colormask_batch(
        _u8p(imgs), n, H, W, _i32p(sizes), _i32p(bounds), _i32p(zones),
        bounds.shape[0], _u8p(alphas), max(1, n_threads),
    )
    return alphas


def enhance_batch(imgs: np.ndarray, sizes: np.ndarray,
                  factors: np.ndarray, flags: np.ndarray,
                  n_threads: int = 1) -> Optional[np.ndarray]:
    """Batched PIL-exact enhance chain: twin of ops/photometric.py:enhance.

    imgs: [N, H, W, 3] uint8 canvases; sizes: [N, 2] int32 valid (h, w);
    factors: [N, 7] float32 (brightness, contrast, color, blur sigma,
    gain RGB); flags: [N, 2] uint8 (apply_blur, apply_rgb).  Returns
    [N, H, W, 3] uint8 (zero outside each valid region), or None when the
    native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    imgs = np.ascontiguousarray(imgs, np.uint8)
    n, H, W = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    sizes = np.ascontiguousarray(sizes, np.int32)
    factors = np.ascontiguousarray(factors, np.float32)
    flags = np.ascontiguousarray(flags, np.uint8)
    outs = np.zeros_like(imgs)
    lib.ipp_cpu_enhance_batch(
        _u8p(imgs), n, H, W, _i32p(sizes),
        factors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _u8p(flags), _u8p(outs), max(1, n_threads),
    )
    return outs


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def flips_batch(imgs: np.ndarray, sizes: np.ndarray, codes: np.ndarray,
                n_threads: int = 1):
    """Batched dihedral flips: exact twin of ops/geometry.py flip_h/v/hv
    on padded canvases (a flip is a pure permutation of the valid region).

    imgs: [N, H, W, C] uint8 (C = 3 or 4); sizes: [N, 2] int32 (h, w);
    codes: [K] int32 flips (1='h', 2='v', 3='hv').  Returns
    [K, N, H, W, C] uint8, or None when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    imgs = np.ascontiguousarray(imgs, np.uint8)
    n, H, W, C = imgs.shape
    sizes = np.ascontiguousarray(sizes, np.int32)
    codes = np.ascontiguousarray(codes, np.int32)
    outs = np.zeros((len(codes),) + imgs.shape, np.uint8)
    lib.ipp_cpu_flips_batch(
        _u8p(imgs), n, H, W, C, _i32p(sizes), _i32p(codes), len(codes),
        _u8p(outs), max(1, n_threads),
    )
    return outs


def ccl_batch(imgs: np.ndarray, sizes: np.ndarray, min_size: int,
              keep_large: bool, n_threads: int = 1):
    """Batched component cleanup + alpha tight crop: exact twin of
    ops/ccl.py:cleanup_and_fit (same C++ pass the fused-chain executor
    runs — row-major BFS reproducing the device argmax tie-break).

    imgs: [N, H, W, 4] uint8 RGBA canvases; sizes: [N, 2] int32 (h, w).
    Returns (outs [N, H, W, 4] uint8, out_sizes [N, 2] int32), or None
    when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    imgs = np.ascontiguousarray(imgs, np.uint8)
    n, H, W, C = imgs.shape
    assert C == 4, "cleanup requires RGBA canvases"
    sizes = np.ascontiguousarray(sizes, np.int32)
    outs = np.zeros_like(imgs)
    out_sizes = np.zeros((n, 2), np.int32)
    lib.ipp_cpu_ccl_batch(
        _u8p(imgs), n, H, W, _i32p(sizes), int(min_size),
        int(bool(keep_large)), _u8p(outs), _i32p(out_sizes),
        max(1, n_threads),
    )
    return outs, out_sizes


def overlay_batch(ovs: np.ndarray, ov_sizes: np.ndarray, bgs: np.ndarray,
                  bg_sizes: np.ndarray, geo: np.ndarray,
                  n_threads: int = 1) -> Optional[np.ndarray]:
    """Batched overlay compositing: PIL-exact twin of
    transforms/overlays.py's resize+paste (native/ipp_cpu.cpp:overlay_one
    — Pillow's premultiplied fixed-point LANCZOS resample + Paste.c blend,
    byte-identical to the reference's PIL composite).

    ovs: [N, Ho, Wo, 4] uint8 RGBA overlay canvases; bgs: [N, Hb, Wb, 3]
    uint8 RGB background canvases; *_sizes: [N, 2] int32 valid (h, w);
    geo: [N, 5] int32 (new_h, new_w, py, px, ok) from the device
    program's exact jax.random draws.  Returns [N, Hb, Wb, 3] uint8
    composites, or None when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    ovs = np.ascontiguousarray(ovs, np.uint8)
    bgs = np.ascontiguousarray(bgs, np.uint8)
    n, Ho, Wo = ovs.shape[0], ovs.shape[1], ovs.shape[2]
    Hb, Wb = bgs.shape[1], bgs.shape[2]
    ov_sizes = np.ascontiguousarray(ov_sizes, np.int32)
    bg_sizes = np.ascontiguousarray(bg_sizes, np.int32)
    geo = np.ascontiguousarray(geo, np.int32)
    outs = np.zeros_like(bgs)
    lib.ipp_cpu_overlay_batch(
        _u8p(ovs), n, Ho, Wo, _i32p(ov_sizes), _u8p(bgs), Hb, Wb,
        _i32p(bg_sizes), _i32p(geo), _u8p(outs), max(1, n_threads),
    )
    return outs


def rotations_batch(imgs: np.ndarray, sizes: np.ndarray, mats: np.ndarray,
                    osizes: np.ndarray, n_rot: int,
                    n_threads: int = 1):
    """Batched PIL-exact nearest rotate-expand fan-out: twin of the
    RandomRotations device program (reference rotations.py:96-109 —
    Image.rotate(angle, expand=True, resample=NEAREST) + getbbox crop).

    Pixel-exact vs Pillow by construction: native/ipp_cpu.cpp's
    rotate_nearest_one replicates Pillow's 16.16 fixed-point affine walk
    (fitted and verified against Image.rotate; direct double evaluation
    differs by a few boundary pixels per image).

    imgs: [N, H, W, 4] uint8 RGBA canvases; sizes: [N, 2] int32 (h, w);
    mats: [N * n_rot, 6] float64 Pillow matrices
    (ops/geometry.py:_pil_rotate_matrix); osizes: [N * n_rot, 2] int32
    expanded (nh, nw), each must fit within (H, W).  Returns
    (outs [N, n_rot, H, W, 4], out_sizes [N, n_rot, 2] tight-crop
    extents) or None when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    imgs = np.ascontiguousarray(imgs, np.uint8)
    n, H, W = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    sizes = np.ascontiguousarray(sizes, np.int32)
    mats = np.ascontiguousarray(mats, np.float64).reshape(-1, 6)
    osizes = np.ascontiguousarray(osizes, np.int32).reshape(-1, 2)
    if (osizes[:, 0] > H).any() or (osizes[:, 1] > W).any():
        return None  # expanded box exceeds the canvas; let the jit path pad
    outs = np.zeros((n, n_rot, H, W, 4), np.uint8)
    out_sizes = np.zeros((n * n_rot, 2), np.int32)
    lib.ipp_cpu_rotations_batch(
        _u8p(imgs), n, H, W, _i32p(sizes),
        mats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _i32p(osizes), n_rot, _u8p(outs), _i32p(out_sizes),
        max(1, n_threads),
    )
    return outs, out_sizes.reshape(n, n_rot, 2)


def chain_batch(imgs: np.ndarray, sizes: np.ndarray, ops: np.ndarray,
                rot_quad: np.ndarray, rot_sh1: np.ndarray,
                rot_sh2: np.ndarray, flip_code: np.ndarray,
                mask_F: np.ndarray, mask_bounds: np.ndarray,
                mask_zones: np.ndarray, mask_replace: np.ndarray,
                enh_factors: np.ndarray,
                enh_flags: np.ndarray, bc_margins: np.ndarray,
                ccl_params: np.ndarray, n_threads: int = 1):
    """Batched fused-chain executor: bit-exact twin of FusedChain's device
    program (see native/ipp_cpu.cpp:chain_one for op semantics).

    imgs: [N, H, W, 4] uint8 RGBA canvases; sizes: [N, 2] int32 (h, w);
    ops: [n_ops] int32 opcodes; per-op parameter arrays are item-major
    ([N, slot, ...]) for the random draws and static for mask/border
    params.  Returns (outs [N, H, W, 4], out_sizes [N, 2]) or None when
    the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    imgs = np.ascontiguousarray(imgs, np.uint8)
    n, H, W = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    sizes = np.ascontiguousarray(sizes, np.int32)
    ops = np.ascontiguousarray(ops, np.int32)
    rot_quad = np.ascontiguousarray(rot_quad, np.int32)
    rot_sh1 = np.ascontiguousarray(rot_sh1, np.int32)
    rot_sh2 = np.ascontiguousarray(rot_sh2, np.int32)
    flip_code = np.ascontiguousarray(flip_code, np.int32)
    mask_F = np.ascontiguousarray(mask_F, np.int32)
    mask_bounds = np.ascontiguousarray(mask_bounds, np.int32)
    mask_zones = np.ascontiguousarray(mask_zones, np.int32)
    mask_replace = np.ascontiguousarray(mask_replace, np.int32)
    enh_factors = np.ascontiguousarray(enh_factors, np.float32)
    enh_flags = np.ascontiguousarray(enh_flags, np.uint8)
    bc_margins = np.ascontiguousarray(bc_margins, np.float32)
    ccl_params = np.ascontiguousarray(ccl_params, np.int32)
    outs = np.zeros_like(imgs)
    out_sizes = np.zeros((n, 2), np.int32)
    lib.ipp_cpu_chain_batch(
        _u8p(imgs), n, H, W, _i32p(sizes), _i32p(ops), len(ops),
        _i32p(rot_quad), _i32p(rot_sh1), _i32p(rot_sh2), _i32p(flip_code),
        _i32p(mask_F), _i32p(mask_bounds), _i32p(mask_zones),
        _i32p(mask_replace),
        _f32p(enh_factors), _u8p(enh_flags), _f32p(bc_margins),
        _i32p(ccl_params), _u8p(outs), _i32p(out_sizes), max(1, n_threads),
    )
    return outs, out_sizes
