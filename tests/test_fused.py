"""Fused chain stage tests: one device program == equivalent staged runs."""

import numpy as np
import pytest
from pathlib import Path
from PIL import Image

from image_processor_pipeline_tpu import ProcessingPipeline, ProcessingStep
from image_processor_pipeline_tpu.transforms.fused import (
    BorderCrop,
    Cleanup,
    ColorMask,
    Enhance,
    FitCrop,
    Flip,
    FusedChain,
    Rotate,
)


@pytest.fixture
def images(tmp_path, rng):
    d = tmp_path / "in"
    d.mkdir()
    for i in range(3):
        arr = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
        Image.fromarray(arr).save(d / f"f{i}.png")
    return tmp_path


def _run(tmp_path, chain, out="out", **opts):
    pipe = ProcessingPipeline(root_dir=tmp_path)
    pipe.add_step(ProcessingStep(
        name="fused", process_function=chain,
        input_dirs=["in"], output_dirs=[out], seed=5, options=opts,
    ))
    return pipe.run(progress=False)[0]


class TestFusedChain:
    def test_rotate_flip_enhance_chain(self, images):
        c = _run(images, FusedChain([Rotate(), Flip(), Enhance()]))
        assert c["Success"] == 3
        outs = sorted((images / "out").iterdir())
        assert [p.name for p in outs] == ["f0.png", "f1.png", "f2.png"]
        for p in outs:
            arr = np.asarray(Image.open(p))
            assert arr.shape[2] == 4
            # rotation expanded the canvas beyond the original
            assert arr.shape[0] > 40 or arr.shape[1] > 56

    def test_border_then_fit(self, images):
        c = _run(images, FusedChain([BorderCrop((0.1, 0.1, 0.1, 0.1)),
                                     FitCrop()]))
        assert c["Success"] == 3
        arr = np.asarray(Image.open(images / "out" / "f0.png"))
        assert arr.shape[:2] == (32, 46)  # 40-2*4, 56-2*5 margins

    def test_colormask_cleanup_chain(self, tmp_path):
        d = tmp_path / "in"
        d.mkdir()
        arr = np.zeros((48, 48, 3), np.uint8)
        arr[:, :] = (0, 250, 0)         # chroma background
        arr[10:38, 10:38] = (200, 30, 160)  # object
        arr[2, 44] = (200, 30, 160)     # isolated speck
        Image.fromarray(arr).save(d / "g.png")
        chain = FusedChain([
            ColorMask([(50, 100, 100, 70, 255, 255)]),
            Cleanup(min_component_size=100),
        ])
        c = _run(tmp_path, chain)
        assert c["Success"] == 1
        out = np.asarray(Image.open(tmp_path / "out" / "g.png"))
        assert out.shape == (28, 28, 4)  # tight-cropped object
        assert (out[..., 3] == 255).all()

    def test_rotate_shear_method(self, images):
        c = _run(images, FusedChain([Rotate(method="shear"), FitCrop()]),
                 out="shear_out")
        assert c["Success"] == 3
        for p in (images / "shear_out").iterdir():
            arr = np.asarray(Image.open(p))
            assert arr.shape[0] > 40 or arr.shape[1] > 56  # expanded

    def test_deterministic_with_seed(self, images):
        _run(images, FusedChain([Rotate(), Enhance()]), out="o1")
        _run(images, FusedChain([Rotate(), Enhance()]), out="o2")
        a = np.asarray(Image.open(images / "o1" / "f0.png"))
        b = np.asarray(Image.open(images / "o2" / "f0.png"))
        np.testing.assert_array_equal(a, b)

    def test_jpg_output_drops_alpha(self, images):
        c = _run(images, FusedChain([Enhance()]), output_suffix=".jpg")
        assert c["Success"] == 3
        with Image.open(images / "out" / "f0.jpg") as im:
            assert im.mode == "RGB"

    def test_jpg_encoder_follows_final_stage_anchor(self, images):
        """A chain ending in a cv2-anchored stage (Flip — symmetry.py:133
        saves via cv2.imwrite q95) must emit cv2-q95 bytes; one ending in
        a PIL-anchored stage (Enhance — tranfo.py:53) PIL-q75 bytes.  The
        .png run of the same chain/seed captures the exact pixels (same
        engine RNG tree), so each .jpg can be checked byte-for-byte
        against its reference encoder."""
        import io as _io

        import cv2

        cases = [
            (FusedChain([Enhance(), Flip(pool=("o",))]), "cv2"),
            (FusedChain([Flip(pool=("o",)), Enhance()]), "pil"),
        ]
        for chain, anchor in cases:
            _run(images, chain, out=f"{anchor}_png")
            _run(images, chain, out=f"{anchor}_jpg", output_suffix=".jpg")
            for i in range(3):
                rgb = np.asarray(
                    Image.open(images / f"{anchor}_png" / f"f{i}.png")
                )[..., :3]
                got = (images / f"{anchor}_jpg" / f"f{i}.jpg").read_bytes()
                if anchor == "cv2":
                    ok, enc = cv2.imencode(
                        ".jpg", rgb[..., ::-1],
                        [cv2.IMWRITE_JPEG_QUALITY, 95])
                    assert ok and got == enc.tobytes()
                else:
                    buf = _io.BytesIO()
                    Image.fromarray(rgb).save(buf, "JPEG", quality=75)
                    assert got == buf.getvalue()


class TestFusionEquivalence:
    def test_fused_maskclean_equals_two_stage_pipeline(self, tmp_path, rng):
        """ColorMask→Cleanup as ONE FusedChain step writes byte-identical
        files to the two-stage pipeline (these stages draw no RNG and the
        intermediate PNG is lossless, so fusion must be invisible)."""
        from image_processor_pipeline_tpu.transforms import (
            ColorMaskTransparency,
            KeepLargestComponent,
        )

        d = tmp_path / "in"
        d.mkdir()
        hsv = [(100, 60, 60, 130, 255, 255)]
        for i in range(4):
            h, w = 40 + 5 * i, 64
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            arr[10:30, 10:40] = (20, 30, 200)  # maskable block
            Image.fromarray(arr).save(d / f"m{i}.png")

        # two-stage
        pipe = ProcessingPipeline(root_dir=tmp_path)
        pipe.add_step(ProcessingStep(
            name="mask", process_function=ColorMaskTransparency(),
            input_dirs=["in"], output_dirs=["mid"], seed=3,
            options={"color_ranges_to_exclude_hsv": hsv}))
        pipe.add_step(ProcessingStep(
            name="clean", process_function=KeepLargestComponent(),
            output_dirs=["two_stage"], seed=3))
        c = pipe.run(progress=False)
        assert c[0]["Success"] == 4 and c[1]["Success"] == 4, c

        # fused
        pipe2 = ProcessingPipeline(root_dir=tmp_path)
        pipe2.add_step(ProcessingStep(
            name="fused", process_function=FusedChain(
                [ColorMask(hsv), Cleanup()]),
            input_dirs=["in"], output_dirs=["fused_out"], seed=9))
        c2 = pipe2.run(progress=False)[0]
        assert c2["Success"] == 4, c2

        a = {p.name: p.read_bytes()
             for p in sorted((tmp_path / "two_stage").iterdir())}
        b = {p.name: p.read_bytes()
             for p in sorted((tmp_path / "fused_out").iterdir())}
        assert a == b


class TestShrinkOutput:
    def test_shrink_changes_no_bytes(self, tmp_path, rng):
        """The D2H shrink (valid-region fetch + .jpg alpha drop) must be
        byte-invisible: engine runs with shrink forced off vs on write
        identical files.  Large-ish images so the rotate diag canvas
        actually exceeds the 128-padded content bbox."""
        d = tmp_path / "in"
        d.mkdir()
        for i in range(3):
            h, w = 150 + 40 * i, 260
            Image.fromarray(
                rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            ).save(d / f"f{i}.png")
        for suffix in (".png", ".jpg"):
            outs = {}
            for shrink in (False, True):
                chain = FusedChain([Rotate(method="shear"), Enhance()])
                if not shrink:
                    chain.shrinks_output = False  # instance override
                pipe = ProcessingPipeline(root_dir=tmp_path)
                pipe.add_step(ProcessingStep(
                    name=f"c_{shrink}_{suffix[1:]}", process_function=chain,
                    input_dirs=["in"],
                    output_dirs=[f"o_{shrink}_{suffix[1:]}"], seed=5,
                    options={"output_suffix": suffix,
                             "native_compute": False},
                ))
                c = pipe.run(progress=False)[0]
                assert c["Success"] == 3, c
                outs[shrink] = {
                    p.name: p.read_bytes()
                    for p in sorted(
                        (tmp_path / f"o_{shrink}_{suffix[1:]}").iterdir())
                }
            assert outs[False] == outs[True], suffix

    def test_shrink_actually_shrinks(self, rng):
        """The shrunk fetch is smaller than the canvas on a rotate chain."""
        from image_processor_pipeline_tpu.io.batching import canvas_for

        chain = FusedChain([Rotate(method="shear")])
        h, w = 150, 200
        canvas = canvas_for(max(h, w), max(h, w), scale=1.5)  # diag-ish
        img = np.zeros((1, canvas[0], canvas[1], 4), np.uint8)
        img[0, :h, :w, :3] = rng.integers(0, 256, (h, w, 3), np.uint8)
        img[0, :h, :w, 3] = 255
        batch = {"image": img, "size": np.asarray([[h, w]], np.int32),
                 "seed": np.asarray([3], np.uint32)}
        out = chain.launch_batch(canvas, [
            {"image": img[0], "size": batch["size"][0], "_seed": 3}
        ], {})
        shrunk = chain.shrink_output(out, None, {"output_suffix": ".jpg"})
        assert shrunk["image"].shape[3] == 3  # alpha dropped
        assert (shrunk["image"].shape[1] < img.shape[1]
                or shrunk["image"].shape[2] < img.shape[2])
        # pixels inside the valid region unchanged
        hh, ww = int(out["h"][0]), int(out["w"][0])
        np.testing.assert_array_equal(
            np.asarray(shrunk["image"])[0, :hh, :ww],
            np.asarray(out["image"])[0, :hh, :ww, :3])


class TestDeviceEncode:
    """options={'device_encode': True}: D2H ships sparse quantized DCT
    coefficients; the saver entropy-encodes.  Byte-invisible vs the pixel
    path for both reference encoder anchors (PIL q75, cv2 q95)."""

    def _dataset(self, tmp_path, rng, smooth=True):
        d = tmp_path / "in"
        d.mkdir()
        for i in range(3):
            h, w = 150 + 40 * i, 260
            if smooth:
                yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
                arr = np.clip(np.stack([
                    127 + 90 * np.sin(xx / 15 + c) * np.cos(yy / 21 - c)
                    for c in range(3)], axis=-1)
                    + rng.normal(0, 5, (h, w, 3)), 0, 255).astype(np.uint8)
            else:
                arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"f{i}.png")
        return d

    def _bytes(self, tmp_path, chain, tag, **opts):
        pipe = ProcessingPipeline(root_dir=tmp_path)
        step = ProcessingStep(
            name=f"de_{tag}", process_function=chain,
            input_dirs=["in"], output_dirs=[f"o_{tag}"], seed=5,
            options={"output_suffix": ".jpg", "native_compute": False,
                     **opts},
        )
        pipe.add_step(step)
        c = pipe.run(progress=False)[0]
        assert c["Success"] == 3, c
        self.last_metrics = step.metrics
        return {p.name: p.read_bytes()
                for p in sorted((tmp_path / f"o_{tag}").iterdir())}

    @pytest.mark.parametrize("stages", [
        [Rotate(method="shear"), Enhance()],   # PIL-anchored final (q75)
        [Flip()],                              # cv2-anchored final (q95)
    ], ids=["pil_q75", "cv2_q95"])
    def test_byte_identical(self, tmp_path, rng, stages):
        from image_processor_pipeline_tpu.io import native
        if not native.available():
            pytest.skip("native engine unavailable")
        self._dataset(tmp_path, rng)
        ref = self._bytes(tmp_path, FusedChain(list(stages)), "off")
        dev = self._bytes(tmp_path, FusedChain(list(stages)), "on",
                          device_encode=True)
        assert ref == dev
        m = self.last_metrics
        # the coefficient transport really engaged AND shrank the fetch
        assert 0 < m.d2h_bytes_fetched < m.d2h_bytes_full

    def test_overflow_pixel_fallback(self, tmp_path, rng):
        """A cap far below noise density forces the per-item pixel
        fallback — still byte-identical, and the sparse jit really did
        overflow (exercised via a tiny device_encode_cap)."""
        from image_processor_pipeline_tpu.io import native
        if not native.available():
            pytest.skip("native engine unavailable")
        self._dataset(tmp_path, rng, smooth=False)
        ref = self._bytes(tmp_path, FusedChain([Flip()]), "off")
        chain = FusedChain([Flip()])
        dev = self._bytes(tmp_path, chain, "on",
                          device_encode=True, device_encode_cap=0.02)
        assert ref == dev
        # the overflows were recorded for the hysteresis (the 3-item run
        # is below the 16-item minimum sample, so the sticky disable
        # itself must NOT have tripped — a run this small never pays
        # enough to be worth killing the transport)
        assert getattr(chain, "_enc_overflow_n", 0) == 3
        assert not getattr(chain, "_device_encode_off", False)
        # at scale the same cumulative majority DOES trip it
        from image_processor_pipeline_tpu.ops import jpeg as djpeg

        djpeg.note_overflows(chain, 13, 13)
        assert getattr(chain, "_device_encode_off", False)

    def test_empty_chain_anchor_agrees(self, tmp_path, rng):
        """FusedChain([]) saves via PIL q75; the device_encode transport
        must quantize at the SAME anchor or bytes diverge between the
        coefficient and pixel paths."""
        from image_processor_pipeline_tpu.io import native
        if not native.available():
            pytest.skip("native engine unavailable")
        self._dataset(tmp_path, rng)
        ref = self._bytes(tmp_path, FusedChain([]), "off")
        dev = self._bytes(tmp_path, FusedChain([]), "on",
                          device_encode=True)
        assert ref == dev

    def test_auto_gate_off_on_cpu(self, tmp_path, rng):
        """device_encode defaults to 'auto' = off on the CPU backend."""
        import jax

        from image_processor_pipeline_tpu.ops import jpeg as djpeg

        chain = FusedChain([Flip()])
        assert jax.default_backend() == "cpu"
        assert not djpeg.device_encode_enabled({}, chain)
        assert djpeg.device_encode_enabled({"device_encode": True}, chain)
        chain._device_encode_off = True
        assert not djpeg.device_encode_enabled(
            {"device_encode": True}, chain)
