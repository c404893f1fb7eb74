"""Native CPU compute backend (native/ipp_cpu.cpp) equivalence.

The C++ kernels must be BYTE-IDENTICAL to the jit path (which is itself
pinned bit-exact against PIL / cv2 by test_ops_photometric / test_ops_color)
for every seed, size, and option combination — the engine switches between
the two paths based on the host's backend, so any divergence would make
results depend on where the pipeline ran.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from image_processor_pipeline_tpu.ops import native_cpu

pytestmark = pytest.mark.skipif(
    not native_cpu.available(), reason="native CPU compute lib unavailable"
)


def _rand_batch(rng, n=6, H=96, W=128):
    imgs = np.zeros((n, H, W, 3), np.uint8)
    sizes = np.zeros((n, 2), np.int32)
    for i in range(n):
        h = int(rng.integers(1, H + 1))
        w = int(rng.integers(1, W + 1))
        sizes[i] = (h, w)
        imgs[i, :h, :w] = rng.integers(0, 256, (h, w, 3), np.uint8)
    return imgs, sizes


class TestEnhanceNative:
    def _check(self, imgs, sizes, seeds, blur, rgb):
        from image_processor_pipeline_tpu.transforms.enhance import EnhanceImage

        t = EnhanceImage()
        batch = {
            "image": imgs, "size": sizes, "seed": seeds,
            "apply_blur": blur, "apply_rgb": rgb,
        }
        dev = t.device_fn({k: jnp.asarray(v) for k, v in batch.items()}, ())
        nat = t.native_fn(batch, (), {}, n_threads=2)
        assert nat is not None
        np.testing.assert_array_equal(np.asarray(dev["image"]), nat["image"])

    def test_random_images_many_seeds(self, rng):
        imgs, sizes = _rand_batch(rng)
        n = len(imgs)
        for base in (0, 7_654_321, 2**31):
            seeds = (base + np.arange(n)).astype(np.uint32)
            blur = rng.random(n) < 0.5
            gains = rng.random(n) < 0.5
            self._check(imgs, sizes, seeds, blur, gains)

    def test_uniform_images_hit_mean_ties(self, rng):
        # constant images make the contrast mean an exact tie candidate
        n, H, W = 8, 64, 64
        imgs = np.zeros((n, H, W, 3), np.uint8)
        sizes = np.zeros((n, 2), np.int32)
        for i in range(n):
            sizes[i] = (H, W)
            imgs[i, :, :] = rng.integers(0, 256, (3,), np.uint8)
        # half-lattice mean: two-value images split 50/50
        imgs[0, : H // 2] = 10
        imgs[0, H // 2:] = 11
        seeds = np.arange(n, dtype=np.uint32)
        self._check(imgs, sizes, seeds,
                    np.ones(n, bool), np.ones(n, bool))

    def test_tiny_and_one_pixel_sizes(self, rng):
        imgs = np.zeros((4, 32, 32, 3), np.uint8)
        sizes = np.asarray([(1, 1), (1, 32), (32, 1), (2, 3)], np.int32)
        for i, (h, w) in enumerate(sizes):
            imgs[i, :h, :w] = rng.integers(0, 256, (h, w, 3), np.uint8)
        self._check(imgs, sizes, np.arange(4, dtype=np.uint32),
                    np.ones(4, bool), np.zeros(4, bool))

    def test_against_pil_directly(self, rng):
        """Full-chain golden: native output == PIL composed by hand for a
        known factor set (bypassing jax.random)."""
        from PIL import Image, ImageEnhance, ImageFilter

        h, w = 57, 83
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        canvas = np.zeros((64, 96, 3), np.uint8)
        canvas[:h, :w] = img
        factors = np.asarray(
            [[0.8341, 1.2177, 0.7503, 2.1719, 1.0, 1.0, 1.0]], np.float32)
        flags = np.asarray([[1, 0]], np.uint8)
        out = native_cpu.enhance_batch(
            canvas[None], np.asarray([[h, w]], np.int32), factors, flags)
        im = Image.fromarray(img)
        im = ImageEnhance.Brightness(im).enhance(float(factors[0, 0]))
        im = ImageEnhance.Contrast(im).enhance(float(factors[0, 1]))
        im = ImageEnhance.Color(im).enhance(float(factors[0, 2]))
        im = im.filter(ImageFilter.GaussianBlur(float(factors[0, 3])))
        np.testing.assert_array_equal(out[0, :h, :w], np.asarray(im))
        assert not out[0, h:].any() and not out[0, :, w:].any()


class TestColorMaskNative:
    OPTS = {
        "color_ranges_to_exclude_hsv": [
            (0, 30, 30, 20, 255, 255),
            (100, 10, 10, 140, 200, 200),
            (160, 0, 0, 180, 255, 255),
        ],
        "zones": [(5, 5, 3, 3), None, (0, 10, 0, 0)],
    }

    def _check(self, imgs, sizes, opts):
        from image_processor_pipeline_tpu.transforms.filters import (
            ColorMaskTransparency,
        )

        t = ColorMaskTransparency()
        static = t.static_args(opts, None)
        dev = t.device_fn(
            {"image": jnp.asarray(imgs), "size": jnp.asarray(sizes),
             "seed": jnp.zeros(len(imgs), jnp.uint32)}, static)
        nat = t.native_fn(
            {"image": imgs, "size": sizes}, static, opts, n_threads=2)
        assert nat is not None
        np.testing.assert_array_equal(np.asarray(dev["alpha"]), nat["alpha"])

    def test_random_images(self, rng):
        imgs, sizes = _rand_batch(rng)
        self._check(imgs, sizes, self.OPTS)

    def test_gimp_scale_fractional_bounds(self, rng):
        imgs, sizes = _rand_batch(rng, n=3)
        opts = {
            "color_ranges_to_exclude_hsv": [(10, 30, 30, 50, 90, 95)],
            "use_gimp_scale": True,
        }
        self._check(imgs, sizes, opts)

    def test_all_2m_random_triples_vs_cv2(self, rng):
        """HSV conversion embedded in the mask agrees with cv2 on a large
        random sample (the jit path is exhaustively pinned; this guards the
        C++ table + sector logic independently)."""
        cv2 = pytest.importorskip("cv2")
        n = 1 << 21
        flat = rng.integers(0, 256, (n, 3), np.uint8)
        h = 1024
        img = flat.reshape(h, n // h // 1, 3)[: h, : n // h]
        hsv_ref = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
        # recover native HSV via three single-channel masks
        H, W = img.shape[:2]
        sizes = np.asarray([[H, W]], np.int32)
        for ch in range(3):
            ref_c = hsv_ref[..., ch].astype(np.int32)
            for bound in (0, 37, 91, 180 if ch == 0 else 255):
                bounds = np.zeros((1, 6), np.int32)
                bounds[0, 3:] = 255
                bounds[0, 3] = 180 if ch == 0 else 255
                bounds[0, ch] = bound        # lo[ch] = bound
                zones = np.zeros((1, 4), np.int32)
                alpha = native_cpu.colormask_batch(
                    img[None], sizes, bounds, zones)[0]
                # alpha==0 ⇔ pixel matched ⇔ ref_c >= bound
                np.testing.assert_array_equal(alpha == 0, ref_c >= bound)


class TestSymmetryNative:
    def test_flip_views_byte_identical(self, rng):
        """The host path never materializes flips (native_fn returns {};
        save_item encodes flip VIEWS) — the views' valid regions must equal
        the device flips exactly for all dihedrals, 3-/4-channel canvases,
        odd/even valid extents."""
        from image_processor_pipeline_tpu.transforms.symmetry import (
            GenerateSymmetries,
        )

        views = {"h": lambda a: a[:, ::-1], "v": lambda a: a[::-1],
                 "hv": lambda a: a[::-1, ::-1]}
        t = GenerateSymmetries()
        for C in (3, 4):
            imgs = np.zeros((5, 48, 64, C), np.uint8)
            sizes = np.zeros((5, 2), np.int32)
            for i in range(5):
                h = int(rng.integers(1, 49))
                w = int(rng.integers(1, 65))
                sizes[i] = (h, w)
                imgs[i, :h, :w] = rng.integers(0, 256, (h, w, C), np.uint8)
            for pool in (("o", "h", "v", "hv"), ("h",), ("v", "hv")):
                static = t.static_args({"pool": pool}, None)
                batch = {"image": imgs, "size": sizes}
                dev = t.device_fn(
                    {k: jnp.asarray(v) for k, v in batch.items()}, static)
                assert t.native_fn(batch, static, {}, n_threads=2) == {}
                assert t.launch_batch_native(None, [], {}) == {}
                for s in dev:
                    for i in range(5):
                        h, w = int(sizes[i, 0]), int(sizes[i, 1])
                        np.testing.assert_array_equal(
                            np.asarray(dev[s])[i, :h, :w],
                            views[s](imgs[i, :h, :w]),
                            err_msg=f"{C}ch {s} item {i}")


class TestChainNative:
    """The C++ fused-chain executor (ipp_cpu_chain_batch) must be
    byte-identical to FusedChain.device_fn for every seed and stage mix —
    including the randomness, which both paths draw from the same
    per-stage fold_in tree."""

    HSV = [(100, 60, 60, 130, 255, 255), (0, 0, 0, 180, 60, 40)]

    @staticmethod
    def _square_batch(rng, n=6, S=160, alpha255=True):
        imgs = np.zeros((n, S, S, 4), np.uint8)
        sizes = np.zeros((n, 2), np.int32)
        for i in range(n):
            h = int(rng.integers(30, (3 * S) // 4))
            w = int(rng.integers(30, (3 * S) // 4))
            sizes[i] = (h, w)
            imgs[i, :h, :w, :3] = rng.integers(0, 256, (h, w, 3), np.uint8)
            imgs[i, :h, :w, 3] = 255 if alpha255 else rng.integers(
                0, 256, (h, w), np.uint8)
        return imgs, sizes

    def _check(self, chain, imgs, sizes, seeds):
        batch = {"image": imgs, "size": sizes, "seed": seeds}
        dev = chain.device_fn(
            {k: jnp.asarray(v) for k, v in batch.items()}, ())
        nat = chain.native_fn(batch, (), {}, n_threads=2)
        assert nat is not None
        np.testing.assert_array_equal(np.asarray(dev["h"]), nat["h"])
        np.testing.assert_array_equal(np.asarray(dev["w"]), nat["w"])
        np.testing.assert_array_equal(np.asarray(dev["image"]), nat["image"])

    def test_e2e_chain_config_many_seeds(self, rng):
        from image_processor_pipeline_tpu.transforms.fused import (
            ColorMask, Enhance, Flip, FusedChain, Rotate,
        )

        chain = FusedChain(
            [Rotate(method="shear"), Flip(), ColorMask(self.HSV), Enhance()])
        imgs, sizes = self._square_batch(rng)
        for base in (0, 999_331, 2**31 + 5):
            seeds = (base + np.arange(len(imgs))).astype(np.uint32)
            self._check(chain, imgs, sizes, seeds)

    def test_quadrant_rotations(self, rng):
        """Narrow angle ranges force each quarter-turn branch."""
        from image_processor_pipeline_tpu.transforms.fused import (
            FusedChain, Rotate,
        )

        imgs, sizes = self._square_batch(rng, n=3, S=96)
        seeds = np.arange(3, dtype=np.uint32)
        for lo, hi in ((1, 44), (46, 134), (136, 224), (226, 314),
                       (316, 359), (44.9, 45.1)):
            chain = FusedChain([Rotate(angle_min=lo, angle_max=hi,
                                       method="shear")])
            self._check(chain, imgs, sizes, seeds)

    def test_all_stage_types_and_degenerate_margins(self, rng):
        from image_processor_pipeline_tpu.transforms.fused import (
            BorderCrop, ColorMask, Enhance, FitCrop, Flip, FusedChain,
            Rotate,
        )

        chain = FusedChain([
            Rotate(method="shear"),
            BorderCrop((0.1, 3, 0.05, 2)),
            Flip(pool=("h", "v")),
            ColorMask(self.HSV, zones=[(4, 4, 2, 2), None]),
            Enhance(blur_prob=1.0, rgb_prob=1.0),
            FitCrop(),
        ])
        imgs, sizes = self._square_batch(rng, alpha255=False)
        self._check(chain, imgs, sizes,
                    np.arange(len(imgs), dtype=np.uint32) + 7)
        # margins that erase the whole image → (0, 0) on both paths
        chain2 = FusedChain([BorderCrop((0.9, 0.9, 0.0, 0.0)), FitCrop()])
        self._check(chain2, imgs, sizes,
                    np.arange(len(imgs), dtype=np.uint32))

    def test_all_zero_content(self):
        from image_processor_pipeline_tpu.transforms.fused import (
            FusedChain, Rotate,
        )

        imgs = np.zeros((2, 64, 64, 4), np.uint8)
        sizes = np.asarray([(40, 30), (1, 1)], np.int32)
        chain = FusedChain([Rotate(method="shear")])
        self._check(chain, imgs, sizes, np.arange(2, dtype=np.uint32))

    def test_cleanup_ccl_stage(self, rng):
        """Component cleanup: multi-component alpha layouts incl. exact
        size ties (device argmax picks the smallest root — BFS discovery
        order must reproduce it)."""
        from image_processor_pipeline_tpu.transforms.fused import (
            Cleanup, ColorMask, FusedChain,
        )

        S = 96
        imgs = np.zeros((4, S, S, 4), np.uint8)
        sizes = np.zeros((4, 2), np.int32)
        for i in range(4):
            h, w = 80, 72
            sizes[i] = (h, w)
            imgs[i, :h, :w, :3] = rng.integers(0, 256, (h, w, 3), np.uint8)
        # item 0: several blobs of distinct sizes + alpha==1 noise
        imgs[0, 5:20, 5:20, 3] = 200
        imgs[0, 40:45, 40:60, 3] = 255
        imgs[0, 70:75, 5:8, 3] = 9
        imgs[0, 30:35, 30:35, 3] = 1   # below the >1 threshold
        # item 1: two EQUAL-size components (tie on the argmax)
        imgs[1, 2:10, 2:10, 3] = 128
        imgs[1, 50:58, 50:58, 3] = 128
        # item 2: diagonal-touching pixels (8-connectivity)
        for k in range(30):
            imgs[2, 10 + k, 10 + k, 3] = 255
        imgs[2, 60:62, 60:62, 3] = 255
        # item 3: all alpha below threshold → empty result
        imgs[3, :, :, 3] = 1
        seeds = np.arange(4, dtype=np.uint32)
        for kw in (False, True):
            chain = FusedChain([Cleanup(min_component_size=60,
                                        keep_large_components=kw)])
            self._check(chain, imgs, sizes, seeds)
        # cleanup after a mask, mid-chain
        chain = FusedChain([ColorMask(self.HSV), Cleanup(50, True)])
        self._check(chain, imgs, sizes, seeds)

    def test_declines_unsupported_stages(self, rng):
        from image_processor_pipeline_tpu.transforms.fused import (
            FusedChain, Rotate, Stage,
        )

        class Custom(Stage):
            def apply(self, img, h, w, key):
                return img, h, w

        imgs, sizes = self._square_batch(rng, n=2, S=64)
        batch = {"image": imgs, "size": sizes,
                 "seed": np.zeros(2, np.uint32)}
        assert FusedChain([Rotate(method="nearest")]).native_fn(
            batch, (), {}) is None
        assert FusedChain([Custom()]).native_fn(batch, (), {}) is None


class TestCleanupNative:
    def test_ccl_batch_matches_device(self, rng):
        """Standalone ccl_batch == vmapped ops/ccl.py:cleanup_and_fit
        exactly (pixels AND crop extents), incl. size ties, diagonal
        connectivity, alpha==1 threshold, and empty results."""
        import jax
        from image_processor_pipeline_tpu.ops import ccl

        S = 96
        imgs = np.zeros((5, S, S, 4), np.uint8)
        sizes = np.zeros((5, 2), np.int32)
        for i in range(5):
            h, w = 80, 72
            sizes[i] = (h, w)
            imgs[i, :h, :w, :3] = rng.integers(0, 256, (h, w, 3), np.uint8)
        imgs[0, 5:20, 5:20, 3] = 200
        imgs[0, 40:45, 40:60, 3] = 255
        imgs[0, 70:75, 5:8, 3] = 9
        imgs[0, 30:35, 30:35, 3] = 1       # below the >1 threshold
        imgs[1, 2:10, 2:10, 3] = 128       # exact size tie
        imgs[1, 50:58, 50:58, 3] = 128
        for k in range(30):                # diagonal chain (8-conn)
            imgs[2, 10 + k, 10 + k, 3] = 255
        imgs[2, 60:62, 60:62, 3] = 255
        imgs[3, :, :, 3] = 1               # all below threshold -> empty
        a = rng.integers(0, 2, (80, 72), np.uint8)  # dense random speckle
        imgs[4, :80, :72, 3] = a * rng.integers(2, 256, (80, 72), np.uint8)

        for min_size, keep_large in ((60, False), (60, True), (3, True)):
            res = native_cpu.ccl_batch(imgs, sizes, min_size, keep_large)
            assert res is not None
            n_outs, n_sizes = res

            def one(img, size):
                out, bh, bw = ccl.cleanup_and_fit(
                    img, size[0], size[1], min_size,
                    keep_large_components=keep_large)
                return out, bh, bw

            d_outs, d_bh, d_bw = jax.vmap(one)(
                jnp.asarray(imgs), jnp.asarray(sizes))
            d_outs = np.asarray(d_outs)
            for i in range(5):
                assert int(d_bh[i]) == int(n_sizes[i, 0]), (i, min_size)
                assert int(d_bw[i]) == int(n_sizes[i, 1]), (i, min_size)
                bh, bw = int(n_sizes[i, 0]), int(n_sizes[i, 1])
                if bh > 0 and bw > 0:
                    np.testing.assert_array_equal(
                        n_outs[i, :bh, :bw], d_outs[i, :bh, :bw])

    def test_engine_native_vs_jit_cleanup(self, tmp_path, rng):
        """KeepLargestComponent through the engine: native_compute=True
        writes byte-identical PNGs to the jit path."""
        from PIL import Image
        from image_processor_pipeline_tpu.pipeline import ProcessingStep
        from image_processor_pipeline_tpu.transforms.cleanup import (
            KeepLargestComponent,
        )

        src = tmp_path / "src"
        src.mkdir()
        for i in range(5):
            h, w = 40 + 4 * i, 52
            arr = np.zeros((h, w, 4), np.uint8)
            arr[..., :3] = rng.integers(0, 256, (h, w, 3), np.uint8)
            n_blobs = int(rng.integers(1, 5))
            for _ in range(n_blobs):
                y, x = int(rng.integers(0, h - 6)), int(rng.integers(0, w - 6))
                s = int(rng.integers(2, 7))
                arr[y:y + s, x:x + s, 3] = 255
            Image.fromarray(arr).save(src / f"im{i}.png")
        outs = {}
        for mode in (False, True):
            out = tmp_path / f"out_{mode}"
            step = ProcessingStep(
                name=f"cl_{mode}", process_function=KeepLargestComponent(),
                input_dirs=[src], output_dirs=[out], seed=9,
                options={"native_compute": mode,
                         "min_component_size": 10,
                         "keep_large_components": True},
                save_log=False,
            )
            step.run()
            outs[mode] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
        assert outs[False].keys() == outs[True].keys()
        assert len(outs[True]) == 5
        for name in outs[True]:
            assert outs[False][name] == outs[True][name], name


class TestEngineNativeBackend:
    def test_pipeline_native_vs_jit_byte_identical(self, tmp_path, rng):
        """An engine run with native_compute=True produces byte-identical
        output files to native_compute=False (same seed)."""
        from PIL import Image
        from image_processor_pipeline_tpu.pipeline import ProcessingStep
        from image_processor_pipeline_tpu.transforms.enhance import EnhanceImage

        src = tmp_path / "src"
        src.mkdir()
        for i in range(6):
            arr = rng.integers(0, 256, (40 + i, 50, 3), np.uint8)
            Image.fromarray(arr).save(src / f"im{i}.png")
        outs = {}
        for mode in (False, True):
            out = tmp_path / f"out_{mode}"
            step = ProcessingStep(
                name=f"enh_{mode}", process_function=EnhanceImage(),
                input_dirs=[src], output_dirs=[out], seed=1234,
                options={"native_compute": mode}, save_log=False,
            )
            step.run()
            outs[mode] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
        assert outs[False].keys() == outs[True].keys()
        assert len(outs[True]) == 6
        for name in outs[True]:
            assert outs[False][name] == outs[True][name], name

    def test_chain_native_vs_jit_byte_identical(self, tmp_path, rng):
        """The full fused chain through the engine: native_compute=True
        writes byte-identical files to the jit path (same seed)."""
        from PIL import Image
        from image_processor_pipeline_tpu.pipeline import ProcessingStep
        from image_processor_pipeline_tpu.transforms.fused import (
            ColorMask, Enhance, Flip, FusedChain, Rotate,
        )

        src = tmp_path / "src"
        src.mkdir()
        for i in range(5):
            arr = rng.integers(0, 256, (40 + 3 * i, 52, 3), np.uint8)
            Image.fromarray(arr).save(src / f"im{i}.png")
        hsv = [(100, 60, 60, 130, 255, 255)]
        outs = {}
        for mode in (False, True):
            out = tmp_path / f"chain_{mode}"
            step = ProcessingStep(
                name=f"chain_{mode}",
                process_function=FusedChain(
                    [Rotate(method="shear"), Flip(), ColorMask(hsv),
                     Enhance()]),
                input_dirs=[src], output_dirs=[out], seed=77,
                options={"native_compute": mode}, save_log=False,
            )
            step.run()
            outs[mode] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
        assert outs[False].keys() == outs[True].keys()
        assert len(outs[True]) == 5
        for name in outs[True]:
            assert outs[False][name] == outs[True][name], name


class TestOverlayNative:
    """PasteOverlayOntoBackground native twin (ipp_cpu_overlay_batch).

    The native path implements Pillow's own algorithms (premultiplied
    fixed-point LANCZOS resample, Paste.c blend) so it is BYTE-exact vs
    PIL; the jit path is an f32 resample (PIL ±1).  Geometry (sizes,
    positions, labels) must be identical across backends — it comes from
    the same traced draw program either way.
    """

    def _batch(self, rng, n=5, Ho=96, Wo=112, Hb=200, Wb=224):
        ovs = np.zeros((n, Ho, Wo, 4), np.uint8)
        bgs = np.zeros((n, Hb, Wb, 3), np.uint8)
        ov_sz = np.zeros((n, 2), np.int32)
        bg_sz = np.zeros((n, 2), np.int32)
        for i in range(n):
            oh = int(rng.integers(3, Ho + 1))
            ow = int(rng.integers(3, Wo + 1))
            bh = int(rng.integers(60, Hb + 1))
            bw = int(rng.integers(60, Wb + 1))
            ovs[i, :oh, :ow] = rng.integers(0, 256, (oh, ow, 4), np.uint8)
            # exercise the alpha 0/255 passthrough legs of the unpremultiply
            if i == 0:
                ovs[i, :oh, : ow // 2, 3] = 255
            if i == 1:
                ovs[i, :oh, : ow // 2, 3] = 0
            bgs[i, :bh, :bw] = rng.integers(0, 256, (bh, bw, 3), np.uint8)
            ov_sz[i] = (oh, ow)
            bg_sz[i] = (bh, bw)
        return {
            "overlay": ovs, "ov_size": ov_sz,
            "background": bgs, "bg_size": bg_sz,
            "seed": (1000 + np.arange(n)).astype(np.uint32),
        }

    def test_native_composite_pil_byte_exact(self, rng):
        from PIL import Image
        from image_processor_pipeline_tpu.transforms.overlays import (
            PasteOverlayOntoBackground,
        )

        t = PasteOverlayOntoBackground()
        batch = self._batch(rng)
        nat = t.native_fn(batch, (0.15, 0.30), {}, n_threads=2)
        assert nat is not None
        for i in range(len(batch["seed"])):
            oh, ow = batch["ov_size"][i]
            bh, bw = batch["bg_size"][i]
            nh, nw = (int(x) for x in nat["new_size"][i])
            py, px = (int(x) for x in nat["pos"][i])
            ovi = Image.fromarray(
                batch["overlay"][i, :oh, :ow], "RGBA"
            ).resize((nw, nh), Image.Resampling.LANCZOS)
            comp = Image.fromarray(batch["background"][i, :bh, :bw], "RGB")
            comp.paste(ovi, (px, py), ovi)
            np.testing.assert_array_equal(
                nat["image"][i][:bh, :bw], np.asarray(comp))

    def test_native_vs_jit_geometry_exact_image_pm1(self, rng):
        from image_processor_pipeline_tpu.transforms.overlays import (
            PasteOverlayOntoBackground,
        )

        t = PasteOverlayOntoBackground()
        batch = self._batch(rng)
        static = (0.15, 0.30)
        dev = t._jitted()(
            t, {k: jnp.asarray(v) for k, v in batch.items()}, static)
        nat = t.native_fn(batch, static, {}, n_threads=1)
        assert nat is not None
        for k in ("pos", "new_size", "ok"):
            np.testing.assert_array_equal(
                np.asarray(dev[k]), np.asarray(nat[k]), err_msg=k)
        d = np.abs(np.asarray(dev["image"], np.int32)
                   - np.asarray(nat["image"], np.int32))
        assert d.max() <= 1  # f32 resample rint boundaries only

    def test_engine_native_vs_jit(self, tmp_path, rng):
        """Engine runs with native_compute on/off: label files byte-equal,
        image pixels within ±1 (the native composite is the PIL-exact
        one; the jit resample rounds at f32 boundaries)."""
        from PIL import Image
        from image_processor_pipeline_tpu.pipeline import ProcessingStep
        from image_processor_pipeline_tpu.transforms.overlays import (
            PasteOverlayOntoBackground,
        )

        ov_dir = tmp_path / "ov"
        bg_dir = tmp_path / "bg"
        ov_dir.mkdir()
        bg_dir.mkdir()
        for i in range(4):
            arr = rng.integers(0, 256, (30 + i, 40, 4), np.uint8)
            Image.fromarray(arr, "RGBA").save(ov_dir / f"ov{i}.png")
            arr = rng.integers(0, 256, (90, 110 + i, 3), np.uint8)
            Image.fromarray(arr).save(bg_dir / f"bg{i}.png")
        outs = {}
        for mode in (False, True):
            img_out = tmp_path / f"img_{mode}"
            lbl_out = tmp_path / f"lbl_{mode}"
            step = ProcessingStep(
                name=f"ovl_{mode}",
                process_function=PasteOverlayOntoBackground(),
                input_dirs=[ov_dir, bg_dir],
                output_dirs=[img_out, lbl_out],
                seed=4321, options={"native_compute": mode},
                pairing_method="zip", save_log=False,
            )
            step.run()
            outs[mode] = (img_out, lbl_out)
        jit_imgs = sorted(outs[False][0].iterdir())
        nat_imgs = sorted(outs[True][0].iterdir())
        assert [p.name for p in jit_imgs] == [p.name for p in nat_imgs]
        assert len(nat_imgs) == 4
        for pj, pn in zip(jit_imgs, nat_imgs):
            a = np.asarray(Image.open(pj), np.int32)
            b = np.asarray(Image.open(pn), np.int32)
            assert np.abs(a - b).max() <= 1, pj.name
        for pj, pn in zip(sorted(outs[False][1].iterdir()),
                          sorted(outs[True][1].iterdir())):
            assert pj.read_bytes() == pn.read_bytes(), pj.name


class TestRotationsNative:
    """The rotations twin targets PILLOW-exactness (Image.rotate's 16.16
    fixed-point nearest affine + getbbox crop), which is STRONGER than the
    jit path's float32 formulation — the two paths may differ on a few
    floor-boundary pixels per image, so the engine A/B asserts the same
    >=0.97 pixel-match bar the jit path's own PIL parity test uses."""

    def test_rotations_batch_pil_byte_exact(self, rng):
        import math
        from PIL import Image
        from image_processor_pipeline_tpu.ops.geometry import (
            _pil_rotate_matrix,
        )

        for trial in range(8):
            h = int(rng.integers(30, 160))
            w = int(rng.integers(30, 160))
            diag = int(math.ceil(math.hypot(h, w))) + 2
            arr = rng.integers(0, 256, (h, w, 4), np.uint8)
            canvas = np.zeros((1, diag, diag, 4), np.uint8)
            canvas[0, :h, :w] = arr
            n_rot = 3
            angles = rng.uniform(0.01, 359.99, n_rot)
            mats = np.empty((n_rot, 6))
            osz = np.empty((n_rot, 2), np.int32)
            for j, a in enumerate(angles):
                m, nw, nh = _pil_rotate_matrix(w, h, float(a))
                mats[j] = m
                osz[j] = (nh, nw)
            outs, out_sizes = native_cpu.rotations_batch(
                canvas, np.asarray([[h, w]], np.int32), mats, osz, n_rot)
            for j, a in enumerate(angles):
                pil = Image.fromarray(arr).rotate(
                    float(a), expand=True, resample=Image.NEAREST)
                box = pil.getbbox()
                ref = np.asarray(pil.crop(box))
                bh, bw = out_sizes[0, j]
                got = outs[0, j, :bh, :bw]
                np.testing.assert_array_equal(got, ref)

    def test_rotations_batch_alpha_only_bbox(self, rng):
        """Pillow >= 10 getbbox() is alpha_only on RGBA: a colored-but-
        transparent border must be trimmed exactly as PIL trims it (the
        code-review repro: any-channel bbox read (80, 86) where PIL reads
        (78, 84) on a 50x70 image rotated 33 degrees)."""
        import math
        from PIL import Image
        from image_processor_pipeline_tpu.ops.geometry import (
            _pil_rotate_matrix,
        )

        h, w = 50, 70
        arr = rng.integers(0, 256, (h, w, 4), np.uint8)
        arr[..., 3] = 255
        arr[:2] = (200, 10, 10, 0)     # colored transparent border rows
        arr[:, -2:] = (10, 200, 10, 0)
        diag = int(math.ceil(math.hypot(h, w))) + 2
        canvas = np.zeros((1, diag, diag, 4), np.uint8)
        canvas[0, :h, :w] = arr
        for a in (33.0, 217.4):
            m, nw, nh = _pil_rotate_matrix(w, h, a)
            outs, out_sizes = native_cpu.rotations_batch(
                canvas, np.asarray([[h, w]], np.int32),
                np.asarray([m]), np.asarray([[nh, nw]], np.int32), 1)
            pil = Image.fromarray(arr).rotate(
                a, expand=True, resample=Image.NEAREST)
            box = pil.getbbox()
            ref = np.asarray(pil.crop(box))
            bh, bw = out_sizes[0, 0]
            np.testing.assert_array_equal(outs[0, 0, :bh, :bw], ref)

    def test_rotations_batch_empty_content(self):
        """A fully transparent input has getbbox() None: the reference
        saves the UNCROPPED rotated image (rotations.py:99-109), so the
        twin returns the full expanded extents, not (0, 0)."""
        canvas = np.zeros((1, 64, 64, 4), np.uint8)
        from image_processor_pipeline_tpu.ops.geometry import (
            _pil_rotate_matrix,
        )

        m, nw, nh = _pil_rotate_matrix(30, 20, 33.0)
        outs, out_sizes = native_cpu.rotations_batch(
            canvas, np.asarray([[20, 30]], np.int32),
            np.asarray([m]), np.asarray([[nh, nw]], np.int32), 1)
        assert tuple(out_sizes[0, 0]) == (nh, nw)
        assert not outs.any()  # all-transparent content stays zero

    def test_host_angles_match_device_draws(self):
        """native_fn's host-side angle replication equals the device
        program's in-program jax.random.uniform draws bit-for-bit."""
        import jax
        import jax.numpy as jnp
        from image_processor_pipeline_tpu.transforms.rotations import (
            RandomRotations,
        )

        seeds = np.asarray([3, 17, 123456, 2**31 - 5], np.uint32)
        t = RandomRotations()
        host = t._host_angles(seeds, 10, 1.0, 359.0)

        def dev(seed):
            return jax.random.uniform(
                jax.random.PRNGKey(seed), (10,), minval=1.0, maxval=359.0)

        ref = np.asarray(jax.vmap(dev)(jnp.asarray(seeds)))
        np.testing.assert_array_equal(host, ref)

    def test_engine_native_vs_jit_rotations(self, tmp_path, rng):
        from PIL import Image
        from image_processor_pipeline_tpu.pipeline import ProcessingStep
        from image_processor_pipeline_tpu.transforms.rotations import (
            RandomRotations,
        )

        src = tmp_path / "src"
        src.mkdir()
        for i in range(4):
            arr = rng.integers(0, 256, (60 + 7 * i, 80, 3), np.uint8)
            Image.fromarray(arr).save(src / f"im{i}.png")
        outs = {}
        for mode in (False, True):
            out = tmp_path / f"rot_{mode}"
            step = ProcessingStep(
                name=f"rot_{mode}", process_function=RandomRotations(),
                input_dirs=[src], output_dirs=[out], seed=99,
                options={"num_rotations": 4, "native_compute": mode},
                save_log=False,
            )
            step.run()
            outs[mode] = sorted(out.iterdir())
        assert [p.name for p in outs[False]] == [p.name for p in outs[True]]
        assert len(outs[True]) == 4 * 5  # original + 4 rotations
        for pj, pn in zip(outs[False], outs[True]):
            a = np.asarray(Image.open(pj))
            b = np.asarray(Image.open(pn))
            # float32 (jit) vs Pillow-fixed-point (native) canvas extents
            # may round one pixel apart at corner angles
            assert abs(a.shape[0] - b.shape[0]) <= 1, pj.name
            assert abs(a.shape[1] - b.shape[1]) <= 1, pj.name
            if a.shape == b.shape:
                match = (a == b).all(axis=-1).mean()
                assert match > 0.97, (pj.name, match)

    def test_engine_native_rotation_is_pil_exact(self, tmp_path, rng):
        """Through the whole engine (decode -> twin -> encode), a pinned
        angle yields EXACTLY Pillow's rotate+getbbox crop — byte-for-byte
        the reference's output (rotations.py:96-109)."""
        from PIL import Image
        from image_processor_pipeline_tpu.pipeline import ProcessingStep
        from image_processor_pipeline_tpu.transforms.rotations import (
            RandomRotations,
        )

        src = tmp_path / "src"
        src.mkdir()
        arr = rng.integers(0, 256, (70, 90, 3), np.uint8)
        Image.fromarray(arr).save(src / "im.png")
        out = tmp_path / "out"
        step = ProcessingStep(
            name="rot", process_function=RandomRotations(),
            input_dirs=[src], output_dirs=[out], seed=5,
            options={"num_rotations": 2, "include_original": False,
                     "angle_min": 77.25, "angle_max": 77.25,
                     "native_compute": True},
            save_log=False,
        )
        step.run()
        files = sorted(out.iterdir())
        assert len(files) == 2
        rgba = np.dstack([arr, np.full(arr.shape[:2], 255, np.uint8)])
        pil = Image.fromarray(rgba).rotate(
            77.25, expand=True, resample=Image.NEAREST)
        ref = np.asarray(pil.crop(pil.getbbox()))
        for f in files:
            got = np.asarray(Image.open(f))
            np.testing.assert_array_equal(got, ref)

    def test_device_decode_option_keeps_original_save(self, tmp_path, rng):
        """RandomRotations.save_item re-encodes the decoded input as the
        include_original copy, so save_needs_image must gate device_decode
        off (a run with the option must still save all outputs)."""
        from PIL import Image
        from image_processor_pipeline_tpu.pipeline import ProcessingStep
        from image_processor_pipeline_tpu.transforms.rotations import (
            RandomRotations,
        )

        assert RandomRotations.save_needs_image is True
        src = tmp_path / "src"
        src.mkdir()
        Image.fromarray(
            rng.integers(0, 256, (50, 60, 3), np.uint8)).save(src / "a.jpg")
        out = tmp_path / "out"
        step = ProcessingStep(
            name="rot", process_function=RandomRotations(),
            input_dirs=[src], output_dirs=[out], seed=3,
            options={"num_rotations": 2, "device_decode": True},
            save_log=False,
        )
        counters = step.run(progress=False)
        assert dict(counters) == {"Success": 1}
        assert len(list(out.iterdir())) == 3  # original + 2 rotations

    def test_fully_transparent_input_saves_uncropped_like_reference(
            self, tmp_path):
        """Reference rotations.py:99-109: getbbox() None → warn and save
        the UNCROPPED rotated image.  A fully transparent RGBA input must
        produce N output files (not skipped items) on both backends."""
        from PIL import Image
        from image_processor_pipeline_tpu.pipeline import ProcessingStep
        from image_processor_pipeline_tpu.transforms.rotations import (
            RandomRotations,
        )

        src = tmp_path / "src"
        src.mkdir()
        arr = np.zeros((30, 40, 4), np.uint8)
        arr[..., 0] = 77  # colored but fully transparent
        Image.fromarray(arr).save(src / "t.png")
        for mode in (True, False):
            out = tmp_path / f"out_{mode}"
            step = ProcessingStep(
                name="rot", process_function=RandomRotations(),
                input_dirs=[src], output_dirs=[out], seed=1,
                options={"num_rotations": 2, "include_original": False,
                         "native_compute": mode},
                save_log=False,
            )
            counters = step.run(progress=False)
            assert dict(counters) == {"Success": 1}, mode
            files = sorted(out.iterdir())
            assert len(files) == 2, mode
            for f in files:
                a = np.asarray(Image.open(f))
                assert a.shape[0] > 0 and a.shape[1] > 0
                assert not a[..., 3].any()  # stays fully transparent


class TestChainEmptyContent:
    def test_fully_transparent_chain_input_succeeds(self, tmp_path):
        """fit_crop's empty-bbox fallback keeps content uncropped (the
        reference never emits a 0x0 output), so a fully transparent input
        must flow through the whole fused chain on both backends."""
        from PIL import Image
        from image_processor_pipeline_tpu.pipeline import ProcessingStep
        from image_processor_pipeline_tpu.transforms.fused import (
            Enhance, Flip, FusedChain, Rotate,
        )

        src = tmp_path / "src"
        src.mkdir()
        arr = np.zeros((24, 32, 4), np.uint8)
        arr[..., 1] = 99  # colored but fully transparent
        Image.fromarray(arr).save(src / "t.png")
        outs = {}
        for mode in (True, False):
            out = tmp_path / f"chain_{mode}"
            step = ProcessingStep(
                name=f"c_{mode}",
                process_function=FusedChain(
                    [Rotate(method="shear"), Flip(), Enhance()]),
                input_dirs=[src], output_dirs=[out], seed=5,
                options={"native_compute": mode}, save_log=False,
            )
            counters = step.run(progress=False)
            assert dict(counters) == {"Success": 1}, mode
            outs[mode] = {p.name: p.read_bytes()
                          for p in sorted(out.iterdir())}
        assert outs[True] == outs[False] and len(outs[True]) == 1
