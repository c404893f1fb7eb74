"""Stage-level tests for every transform family, run through the
orchestrator over temp directories (reference behavior contracts)."""

import numpy as np
import pytest
from pathlib import Path
from PIL import Image

from image_processor_pipeline_tpu import ProcessingPipeline, ProcessingStep
from image_processor_pipeline_tpu.transforms import (
    BorderCrop,
    ColorMaskTransparency,
    EnhanceImage,
    FitCrop,
    GenerateSymmetries,
    KeepLargestComponent,
    PasteOverlayOntoBackground,
    RandomRotations,
)
from image_processor_pipeline_tpu.io.labels import read_yolo_labels


def _mkimgs(d, n=3, size=(40, 60), channels=3, suffix=".png", rng=None,
            smooth=False):
    rng = rng or np.random.default_rng(0)
    d.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        if smooth:
            # photographic-like content: sparse after quantization, so
            # the device_encode coefficient transport actually engages
            # (noise overflows the compaction cap and falls back to
            # pixels, which would leave the sparse path untested)
            h, w = size
            yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
            arr = np.clip(np.stack(
                [127 + 90 * np.sin(xx / 11 + c + i)
                 * np.cos(yy / 17 - c) for c in range(channels)],
                axis=-1) + rng.normal(0, 4, (h, w, channels)),
                0, 255).astype(np.uint8)
        else:
            arr = rng.integers(0, 256, size=(*size, channels),
                               dtype=np.uint8)
        if channels == 4:
            arr[..., 3] = 255
        p = d / f"x{i}{suffix}"
        Image.fromarray(arr).save(p)
        paths.append(p)
    return paths


def _run_step(tmp_path, transform, in_dirs, out_dirs, **kw):
    pipe = ProcessingPipeline(root_dir=tmp_path)
    pipe.add_step(ProcessingStep(
        name="t", process_function=transform,
        input_dirs=in_dirs, output_dirs=out_dirs, seed=11, **kw,
    ))
    return pipe.run(progress=False)[0]


class TestRotations:
    def test_fanout_and_naming(self, tmp_path):
        _mkimgs(tmp_path / "in", n=2, size=(30, 40))
        c = _run_step(tmp_path, RandomRotations(), ["in"], ["out"],
                      options={"num_rotations": 3})
        assert c["Success"] == 2
        names = sorted(p.name for p in (tmp_path / "out").iterdir())
        assert "x0_r000.png" in names  # original included by default
        assert "x0_r001.png" in names and "x0_r003.png" in names
        assert len(names) == 8  # 2 × (3 rotations + original)

    def test_rotation_grows_canvas(self, tmp_path):
        _mkimgs(tmp_path / "in", n=1, size=(30, 40))
        _run_step(tmp_path, RandomRotations(), ["in"], ["out"],
                  options={"num_rotations": 2, "include_original": False})
        for p in (tmp_path / "out").iterdir():
            with Image.open(p) as im:
                assert im.mode == "RGBA"
                # expanded rotations of an opaque rect are strictly larger
                assert im.width > 40 or im.height > 30

    def test_shear_method_option(self, tmp_path):
        _mkimgs(tmp_path / "in", n=2, size=(30, 40))
        c = _run_step(tmp_path, RandomRotations(), ["in"], ["out"],
                      options={"num_rotations": 2, "method": "shear"})
        assert c["Success"] == 2
        for p in (tmp_path / "out").glob("*_r00[12].png"):
            with Image.open(p) as im:
                # expanded footprint, same content area (±shear jitter)
                assert im.width > 40 or im.height > 30

    def test_jpeg_format_option(self, tmp_path):
        _mkimgs(tmp_path / "in", n=1)
        _run_step(tmp_path, RandomRotations(), ["in"], ["out"],
                  options={"num_rotations": 1, "output_format": "jpeg"})
        names = {p.name for p in (tmp_path / "out").iterdir()}
        assert names == {"x0_r000.jpg", "x0_r001.jpg"}

    def test_device_encode_byte_identical(self, tmp_path):
        """device_encode ships sparse DCT coefficients D2H and entropy-
        encodes in the saver — same bytes as the pixel path (jit leg;
        the native twin bypasses it)."""
        from image_processor_pipeline_tpu.io import native
        if not native.available():
            pytest.skip("native engine unavailable")
        _mkimgs(tmp_path / "in", n=2, size=(70, 90), smooth=True)
        outs = {}
        for tag, de in (("off", False), ("on", True)):
            t = RandomRotations()
            _run_step(tmp_path, t, ["in"], [f"o_{tag}"],
                      options={"num_rotations": 3, "output_format": "jpeg",
                               "native_compute": False,
                               "device_encode": de})
            outs[tag] = {p.name: p.read_bytes()
                         for p in sorted((tmp_path / f"o_{tag}").iterdir())}
        # the sparse transport really carried the rotations (no overflow
        # pixel fallback on this smooth content)
        assert getattr(t, "_enc_total_n", 0) > 0
        assert getattr(t, "_enc_overflow_n", 0) == 0
        assert outs["off"].keys() == outs["on"].keys()
        assert len(outs["off"]) == 8  # 2 x (3 rotations + original)
        assert outs["off"] == outs["on"]


class TestSymmetry:
    def test_all_syms_exact_vs_cv2(self, tmp_path):
        cv2 = pytest.importorskip("cv2")
        rng = np.random.default_rng(5)
        paths = _mkimgs(tmp_path / "in", n=1, size=(33, 47), rng=rng)
        src = np.asarray(Image.open(paths[0]))
        c = _run_step(tmp_path, GenerateSymmetries(), ["in"], ["out"])
        assert c["Success"] == 1
        out = tmp_path / "out"
        np.testing.assert_array_equal(
            np.asarray(Image.open(out / "x0_o.png")), src)
        np.testing.assert_array_equal(
            np.asarray(Image.open(out / "x0_h.png")), cv2.flip(src, 1))
        np.testing.assert_array_equal(
            np.asarray(Image.open(out / "x0_v.png")), cv2.flip(src, 0))
        np.testing.assert_array_equal(
            np.asarray(Image.open(out / "x0_hv.png")), cv2.flip(src, -1))

    def test_choose_random_subset(self, tmp_path):
        _mkimgs(tmp_path / "in", n=4)
        c = _run_step(tmp_path, GenerateSymmetries(), ["in"], ["out"],
                      options={"pool": ["h", "v", "hv"], "choose_random": 1,
                               "include_original": True})
        assert c["Success"] == 4
        # each input produced the forced original + 1 random sym
        for i in range(4):
            files = list((tmp_path / "out").glob(f"x{i}_*"))
            assert len(files) == 2
            assert any(f.stem.endswith("_o") for f in files)

    def test_invalid_pool_errors(self, tmp_path):
        _mkimgs(tmp_path / "in", n=1)
        c = _run_step(tmp_path, GenerateSymmetries(), ["in"], ["out"],
                      options={"pool": ["h", "zz"]})
        assert c["Error"] == 1

    def test_bad_extension_rejected(self, tmp_path):
        (tmp_path / "in").mkdir()
        (tmp_path / "in" / "f.xyz").write_bytes(b"nope")
        c = _run_step(tmp_path, GenerateSymmetries(), ["in"], ["out"])
        assert c["Error"] == 1

    def test_device_encode_byte_identical(self, tmp_path):
        """Symmetry flips ship as sparse DCT coefficients on .jpg runs
        (q95 cv2 anchor); the 'o' original keeps the host pixel encode.
        Bytes identical to the pixel path (jit leg), including when a
        tiny cap forces the per-item pixel overflow fallback."""
        from image_processor_pipeline_tpu.io import native
        if not native.available():
            pytest.skip("native engine unavailable")
        _mkimgs(tmp_path / "in", n=3, size=(70, 90), suffix=".jpg",
                smooth=True)
        outs = {}
        trs = {}
        for tag, opts in (
                ("off", {"device_encode": False}),
                ("on", {"device_encode": True}),
                ("ovf", {"device_encode": True, "device_encode_cap": 0.02}),
                # fully codec-to-codec: sparse coefficients in (hybrid
                # decode), flips + FDCT on device, sparse coefficients
                # out — pixels never touch host memory
                ("full", {"device_encode": True, "device_decode": True}),
                # hybrid decode ON but the cap is statically non-viable
                # (transport_cap_viable): needs_host_image keeps the host
                # decode instead of betting on a transport that must
                # decline
                ("fb", {"device_encode": True, "device_decode": True,
                        "device_encode_cap": 9.0}),
        ):
            trs[tag] = t = GenerateSymmetries()
            _run_step(tmp_path, t, ["in"], [f"o_{tag}"],
                      options={"native_compute": False, **opts})
            outs[tag] = {p.name: p.read_bytes()
                         for p in sorted((tmp_path / f"o_{tag}").iterdir())}
        # 'on' really shipped coefficients (4 planes x 3 items — the 'o'
        # copy device-encodes too, its batch is already resident); 'ovf'
        # really overflowed; 'full' ran the same transport fed by the
        # hybrid decode
        assert getattr(trs["on"], "_enc_total_n", 0) == 12
        assert getattr(trs["on"], "_enc_overflow_n", 0) == 0
        assert getattr(trs["ovf"], "_enc_overflow_n", 0) > 0
        assert getattr(trs["full"], "_enc_total_n", 0) == 12
        assert getattr(trs["full"], "_enc_overflow_n", 0) == 0
        assert len(outs["off"]) == 12  # 3 inputs x 4 symmetries
        for tag in ("on", "ovf", "full", "fb"):
            assert outs["off"] == outs[tag], tag

    def test_device_encode_decline_counts_toward_gate(self, tmp_path,
                                                      monkeypatch):
        """A RUN-time transport decline on chunks where the engine
        skipped the host decode betting on it (forced here by stubbing
        encode_shrink — the engine's 128-floor canvases can't decline
        geometrically under a statically-viable cap): save_item feeds
        from the fetched input_pixels fallback, the declines count into
        the sticky gate, and output bytes stay identical."""
        from image_processor_pipeline_tpu.io import native
        if not native.available():
            pytest.skip("native engine unavailable")
        from image_processor_pipeline_tpu.ops import jpeg as djpeg
        _mkimgs(tmp_path / "in", n=20, size=(70, 90), suffix=".jpg",
                smooth=True)
        outs = {}
        trs = {}
        for tag, opts in (
                ("off", {"device_encode": False}),
                ("on", {"device_encode": True, "device_decode": True}),
        ):
            if tag == "on":
                monkeypatch.setattr(djpeg, "encode_shrink",
                                    lambda *a, **k: None)
            trs[tag] = t = GenerateSymmetries()
            _run_step(tmp_path, t, ["in"], [f"d_{tag}"],
                      options={"native_compute": False, **opts})
            outs[tag] = {p.name: p.read_bytes()
                         for p in sorted((tmp_path / f"d_{tag}").iterdir())}
        assert len(outs["off"]) == 80  # 20 inputs x 4 symmetries
        assert outs["off"] == outs["on"]
        # every chunk declined -> the cumulative gate sticky-disabled;
        # declines count in plane-ROW units (items x 4 planes), matching
        # the denominator note_overflows uses on transported chunks
        assert getattr(trs["on"], "_device_encode_off", False)
        assert getattr(trs["on"], "_enc_overflow_n", 0) == 80

    def test_device_encode_skips_unselectable_original(self, tmp_path):
        """include_original=False with a flips-only pool: the 'o' plane
        is never device-encoded (its coefficients could never be read),
        so the hysteresis total counts 2 planes per item, not 3 — and
        bytes match the plain path."""
        from image_processor_pipeline_tpu.io import native
        if not native.available():
            pytest.skip("native engine unavailable")
        _mkimgs(tmp_path / "in", n=3, size=(70, 90), suffix=".jpg",
                smooth=True)
        opts = {"pool": ["h", "v"], "include_original": False,
                "native_compute": False}
        outs = {}
        trs = {}
        for tag, de in (("off", False), ("on", True)):
            trs[tag] = t = GenerateSymmetries()
            _run_step(tmp_path, t, ["in"], [f"p_{tag}"],
                      options={**opts, "device_encode": de,
                               "device_decode": de})
            outs[tag] = {p.name: p.read_bytes()
                         for p in sorted((tmp_path / f"p_{tag}").iterdir())}
        assert len(outs["off"]) == 6  # 3 inputs x {h, v}
        assert outs["off"] == outs["on"]
        assert getattr(trs["on"], "_enc_total_n", 0) == 6  # 3 items x 2


class TestEnhance:
    def test_sample_mode_pipeline(self, tmp_path):
        _mkimgs(tmp_path / "in", n=10, suffix=".jpg")
        c = _run_step(tmp_path, EnhanceImage(), ["in"], ["out"],
                      pairing_method="sample")
        assert c["Success"] == 10
        outs = list((tmp_path / "out").iterdir())
        assert len(outs) == 10
        for p in outs:
            with Image.open(p) as im:
                assert im.size == (60, 40)

    def test_output_differs_from_input(self, tmp_path):
        paths = _mkimgs(tmp_path / "in", n=1, suffix=".png")
        _run_step(tmp_path, EnhanceImage(), ["in"], ["out"],
                  pairing_method="one_input")
        src = np.asarray(Image.open(paths[0]))
        out = np.asarray(Image.open(tmp_path / "out" / "x0.png"))
        assert not (src == out).all()

    def test_device_encode_byte_identical(self, tmp_path):
        """Coefficient D2H transport on an all-.jpg bucket — same bytes
        as the pixel path (jit leg)."""
        from image_processor_pipeline_tpu.io import native
        if not native.available():
            pytest.skip("native engine unavailable")
        _mkimgs(tmp_path / "in", n=3, suffix=".jpg", smooth=True)
        outs = {}
        for tag, de in (("off", False), ("on", True)):
            t = EnhanceImage()
            _run_step(tmp_path, t, ["in"], [f"o_{tag}"],
                      pairing_method="one_input",
                      options={"native_compute": False,
                               "device_encode": de})
            outs[tag] = {p.name: p.read_bytes()
                         for p in sorted((tmp_path / f"o_{tag}").iterdir())}
        # the sparse transport really carried the items (no fallback)
        assert getattr(t, "_enc_total_n", 0) > 0
        assert getattr(t, "_enc_overflow_n", 0) == 0
        assert len(outs["off"]) == 3
        assert outs["off"] == outs["on"]


class TestColorMask:
    def test_alpha_masks_green(self, tmp_path):
        cv2 = pytest.importorskip("cv2")
        d = tmp_path / "in"
        d.mkdir()
        arr = np.zeros((32, 32, 3), np.uint8)
        arr[:16] = (0, 255, 0)     # green top half
        arr[16:] = (255, 0, 0)     # red bottom half
        Image.fromarray(arr).save(d / "g.png")
        hsv_g = cv2.cvtColor(arr[:1, :1], cv2.COLOR_RGB2HSV)[0, 0]
        filt = (int(hsv_g[0]) - 5, 100, 100, int(hsv_g[0]) + 5, 255, 255)
        c = _run_step(
            tmp_path, ColorMaskTransparency(), ["in"], ["out"],
            options={"color_ranges_to_exclude_hsv": [filt],
                     "output_prefix": "0141"},
        )
        assert c["Success"] == 1
        out = np.asarray(Image.open(tmp_path / "out" / "0141_g.png"))
        assert out.shape[2] == 4
        assert (out[:16, :, 3] == 0).all()      # green masked out
        assert (out[16:, :, 3] == 255).all()    # red kept
        # RGB channels keep ORIGINAL values even where masked
        np.testing.assert_array_equal(out[..., :3], arr)

    def test_missing_filters_is_error(self, tmp_path):
        _mkimgs(tmp_path / "in", n=1)
        c = _run_step(tmp_path, ColorMaskTransparency(), ["in"], ["out"])
        assert c["Error"] == 1

    def test_gimp_scale(self, tmp_path):
        d = tmp_path / "in"
        d.mkdir()
        arr = np.zeros((16, 16, 3), np.uint8)
        arr[:, :] = (0, 255, 0)
        Image.fromarray(arr).save(d / "g.png")
        # pure green is H=120 GIMP (→60 cv2), S=V=100%
        c = _run_step(
            tmp_path, ColorMaskTransparency(), ["in"], ["out"],
            options={"color_ranges_to_exclude_hsv": [(110, 80, 80, 130, 100, 100)],
                     "use_gimp_scale": True},
        )
        assert c["Success"] == 1
        out = np.asarray(Image.open(tmp_path / "out" / "g.png"))
        assert (out[..., 3] == 0).all()


class TestOverlays:
    def test_modulo_composite_with_labels(self, tmp_path):
        rng = np.random.default_rng(3)
        ov_dir = tmp_path / "overlays"
        bg_dir = tmp_path / "bgs"
        ov_dir.mkdir()
        bg_dir.mkdir()
        for i in range(4):
            ov = rng.integers(0, 256, size=(24, 30, 4), dtype=np.uint8)
            ov[..., 3] = 255
            Image.fromarray(ov).save(ov_dir / f"ov{i}.png")
        for i in range(2):
            bg = rng.integers(0, 256, size=(100, 150, 3), dtype=np.uint8)
            Image.fromarray(bg).save(bg_dir / f"bg{i}.jpg")

        c = _run_step(
            tmp_path, PasteOverlayOntoBackground(),
            ["overlays", "bgs"], ["out/imgs", "out/labels"],
            pairing_method="modulo", options={"yolo_class_id": 7},
        )
        assert c["Success"] == 4
        for i in range(4):
            img_p = tmp_path / "out/imgs" / f"ov{i}.jpg"
            lbl_p = tmp_path / "out/labels" / f"ov{i}.txt"
            assert img_p.exists() and lbl_p.exists()
            with Image.open(img_p) as im:
                assert im.size == (150, 100)  # background size
            cls, xywhn = read_yolo_labels(lbl_p)
            assert cls[0] == 7
            assert ((xywhn > 0) & (xywhn < 1)).all()
            # overlay diagonal between ~15% and 30% of bg diagonal
            bw, bh = xywhn[0, 2] * 150, xywhn[0, 3] * 100
            diag_ratio = np.hypot(bw, bh) / np.hypot(150, 100)
            assert 0.10 < diag_ratio < 0.32

    def test_device_encode_byte_identical(self, tmp_path):
        """Composites ship as sparse DCT coefficients when every
        background in the bucket is .jpg (PIL q75 anchor) — same bytes
        and labels as the pixel path (jit leg)."""
        from image_processor_pipeline_tpu.io import native
        if not native.available():
            pytest.skip("native engine unavailable")
        rng = np.random.default_rng(3)
        ov_dir = tmp_path / "overlays"
        ov_dir.mkdir()
        for i in range(4):
            ov = rng.integers(0, 256, size=(24, 30, 4), dtype=np.uint8)
            ov[..., 3] = 255
            Image.fromarray(ov).save(ov_dir / f"ov{i}.png")
        _mkimgs(tmp_path / "bgs", n=2, size=(100, 150), suffix=".jpg",
                smooth=True)
        outs = {}
        for tag, de in (("off", False), ("on", True)):
            t = PasteOverlayOntoBackground()
            _run_step(tmp_path, t, ["overlays", "bgs"],
                      [f"o_{tag}/i", f"o_{tag}/l"],
                      pairing_method="modulo",
                      options={"native_compute": False,
                               "device_encode": de})
            outs[tag] = {p.name: p.read_bytes()
                         for p in sorted((tmp_path / f"o_{tag}").rglob("*")
                                         ) if p.is_file()}
        assert getattr(t, "_enc_total_n", 0) > 0
        assert getattr(t, "_enc_overflow_n", 0) == 0
        assert len(outs["off"]) == 8  # 4 composites + 4 labels
        assert outs["off"] == outs["on"]

    def test_composite_contains_overlay_pixels(self, tmp_path):
        ov_dir = tmp_path / "ov"
        bg_dir = tmp_path / "bg"
        ov_dir.mkdir()
        bg_dir.mkdir()
        ov = np.zeros((20, 20, 4), np.uint8)
        ov[..., 0] = 255  # pure red, fully opaque
        ov[..., 3] = 255
        Image.fromarray(ov).save(ov_dir / "o.png")
        bg = np.zeros((80, 80, 3), np.uint8)
        Image.fromarray(bg).save(bg_dir / "b.png")
        _run_step(tmp_path, PasteOverlayOntoBackground(),
                  ["ov", "bg"], ["o/i", "o/l"], pairing_method="modulo")
        out = np.asarray(Image.open(tmp_path / "o/i" / "o.png"))
        cls, xywhn = read_yolo_labels(tmp_path / "o/l" / "o.txt")
        x1 = round((xywhn[0, 0] - xywhn[0, 2] / 2) * 80)
        y1 = round((xywhn[0, 1] - xywhn[0, 3] / 2) * 80)
        x2 = round((xywhn[0, 0] + xywhn[0, 2] / 2) * 80)
        y2 = round((xywhn[0, 1] + xywhn[0, 3] / 2) * 80)
        inner = out[y1 + 2:y2 - 2, x1 + 2:x2 - 2]
        assert (inner[..., 0] > 200).all()  # red overlay dominates
        outside = out.copy()
        outside[y1:y2, x1:x2] = 0
        assert (outside == 0).all()  # background untouched

    def test_label_values_equal_the_f32_box_formula(self):
        """Labels come from the integer paste geometry on the host, bit for
        bit the f32 values of ops.bbox.xyxy2xywhn jitted on the CPU."""
        import jax

        from image_processor_pipeline_tpu.ops import bbox
        from image_processor_pipeline_tpu.transforms.overlays import (
            label_values,
        )

        rng = np.random.default_rng(5)
        n = 4096
        bg = rng.integers(1, 4097, (n, 2))
        new = rng.integers(0, 1 << 12, (n, 2)) % bg + 1
        pos = rng.integers(0, 1 << 12, (n, 2)) % (bg - new + 1)
        xyxy = np.stack([pos[:, 1], pos[:, 0], pos[:, 1] + new[:, 1],
                         pos[:, 0] + new[:, 0]], 1).astype(np.float32)
        want = np.asarray(jax.jit(jax.vmap(bbox.xyxy2xywhn))(
            xyxy, bg[:, 1].astype(np.float32), bg[:, 0].astype(np.float32)))
        got = np.stack([label_values(p, s, b)
                        for p, s, b in zip(pos, new, bg)])
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


class TestRecadrages:
    def test_border_crop_fraction_and_pixels(self, tmp_path):
        rng = np.random.default_rng(9)
        d = tmp_path / "in"
        d.mkdir()
        arr = rng.integers(0, 256, size=(100, 200, 3), dtype=np.uint8)
        Image.fromarray(arr).save(d / "a.jpg", quality=100)
        c = _run_step(tmp_path, BorderCrop(), ["in"], ["out"],
                      options={"crop_margins": (0.1, 0.2, 10, 20)})
        assert c["Success"] == 1
        with Image.open(tmp_path / "out" / "a.jpg") as im:
            assert im.size == (200 - 30, 100 - 30)

    def test_border_crop_rejects_png(self, tmp_path):
        _mkimgs(tmp_path / "in", n=1, suffix=".png")
        c = _run_step(tmp_path, BorderCrop(), ["in"], ["out"])
        assert c["Error"] == 1

    def test_border_crop_margins_too_large(self, tmp_path):
        _mkimgs(tmp_path / "in", n=1, suffix=".jpg")
        c = _run_step(tmp_path, BorderCrop(), ["in"], ["out"],
                      options={"crop_margins": (0.6, 0.6, 0, 0)})
        assert c["Error"] == 1

    def test_fit_crop_trims_transparent_border(self, tmp_path):
        d = tmp_path / "in"
        d.mkdir()
        arr = np.zeros((50, 60, 4), np.uint8)
        arr[10:30, 15:45] = [9, 8, 7, 255]
        Image.fromarray(arr).save(d / "a.png")
        c = _run_step(tmp_path, FitCrop(), ["in"], ["out"])
        assert c["Success"] == 1
        out = np.asarray(Image.open(tmp_path / "out" / "a.png"))
        assert out.shape == (20, 30, 4)
        ref = np.asarray(Image.open(d / "a.png").crop(
            Image.open(d / "a.png").getbbox()))
        np.testing.assert_array_equal(out, ref)


class TestCleanup:
    def test_pipeline_cleanup(self, tmp_path):
        d = tmp_path / "in"
        d.mkdir()
        arr = np.zeros((64, 64, 4), np.uint8)
        arr[..., :3] = 77
        arr[10:40, 10:40, 3] = 255  # main blob
        arr[2, 60, 3] = 255          # isolated pixel
        Image.fromarray(arr).save(d / "a.png")
        c = _run_step(tmp_path, KeepLargestComponent(), ["in"], ["out"])
        assert c["Success"] == 1
        out = np.asarray(Image.open(tmp_path / "out" / "a.png"))
        assert out.shape == (30, 30, 4)  # tight-cropped to the main blob
        assert (out[..., 3] == 255).all()

    def test_rejects_non_png_and_no_alpha(self, tmp_path):
        d = tmp_path / "in"
        d.mkdir()
        rng = np.random.default_rng(0)
        Image.fromarray(
            rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)
        ).save(d / "no_alpha.png")
        Image.fromarray(
            rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)
        ).save(d / "b.jpg")
        c = _run_step(tmp_path, KeepLargestComponent(), ["in"], ["out"])
        assert c["Error"] == 2


class TestSlicerNativePaths:
    """The slicer transforms' numpy fast paths (native_fn views) must be
    byte-identical to the jit device programs, file for file."""

    def test_border_crop_native_vs_jit(self, tmp_path, rng):
        d = tmp_path / "in"
        d.mkdir()
        for i in range(5):
            h, w = int(rng.integers(30, 80)), int(rng.integers(30, 80))
            Image.fromarray(
                rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            ).save(d / f"b{i}.jpg", quality=92)
        outs = {}
        for mode in (False, True):
            c = _run_step(
                tmp_path, BorderCrop(), ["in"], [f"o_{mode}"],
                options={"native_compute": mode,
                         "crop_margins": (0.1, 3, 0.25, 1)})
            assert c["Success"] == 5, c
            outs[mode] = {p.name: p.read_bytes()
                          for p in sorted((tmp_path / f"o_{mode}").iterdir())}
        assert outs[False] == outs[True]

    def test_fit_crop_native_vs_jit(self, tmp_path, rng):
        d = tmp_path / "in"
        d.mkdir()
        # RGBA (alpha-only bbox), RGB (any-channel bbox), fully transparent
        a = np.zeros((40, 60, 4), np.uint8)
        a[..., :3] = rng.integers(0, 256, (40, 60, 3), np.uint8)
        a[12:30, 7:50, 3] = 200
        Image.fromarray(a).save(d / "rgba.png")
        b = np.zeros((50, 44, 3), np.uint8)
        b[5:20, 9:31] = rng.integers(1, 256, (15, 22, 3), np.uint8)
        Image.fromarray(b).save(d / "rgb.png")
        t = np.zeros((24, 24, 4), np.uint8)
        t[..., :3] = 50  # colored but transparent -> getbbox None
        Image.fromarray(t).save(d / "transparent.png")
        outs = {}
        for mode in (False, True):
            c = _run_step(tmp_path, FitCrop(), ["in"], [f"o_{mode}"],
                          options={"native_compute": mode})
            assert c["Success"] == 3, c
            outs[mode] = {p.name: p.read_bytes()
                          for p in sorted((tmp_path / f"o_{mode}").iterdir())}
        assert outs[False] == outs[True]
        # the transparent image stayed uncropped (PIL getbbox-None parity)
        out_t = np.asarray(Image.open(tmp_path / "o_True" / "transparent.png"))
        assert out_t.shape == (24, 24, 4)

    def test_crop_square_native_vs_jit(self, tmp_path, rng):
        from image_processor_pipeline_tpu.transforms.crop_square import (
            SquareCropAroundBBox,
        )

        imgs = tmp_path / "imgs"
        lbls = tmp_path / "lbls"
        imgs.mkdir()
        lbls.mkdir()
        for i in range(6):
            h, w = int(rng.integers(40, 100)), int(rng.integers(40, 100))
            Image.fromarray(
                rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            ).save(imgs / f"c{i}.jpg", quality=92)
            lines = []
            for _ in range(int(rng.integers(1, 4))):
                cx, cy = rng.uniform(0.3, 0.7, 2)
                bw, bh = rng.uniform(0.05, 0.3, 2)
                lines.append(f"{int(rng.integers(0, 5))} {cx:.6f} {cy:.6f} "
                             f"{bw:.6f} {bh:.6f}")
            (lbls / f"c{i}.txt").write_text("\n".join(lines) + "\n")
        outs = {}
        for mode in (False, True):
            pipe = ProcessingPipeline(root_dir=tmp_path)
            pipe.add_step(ProcessingStep(
                name=f"cs_{mode}", process_function=SquareCropAroundBBox(),
                input_dirs=["imgs", "lbls"], pairing_method="zip",
                output_dirs=[f"oi_{mode}", f"ol_{mode}"], seed=31,
                options={"native_compute": mode},
            ))
            counts = pipe.run(progress=False)[0]
            files = {}
            for sub in (f"oi_{mode}", f"ol_{mode}"):
                for p in sorted((tmp_path / sub).iterdir()):
                    files[f"{sub.split('_')[0]}/{p.name}"] = p.read_bytes()
            outs[mode] = (dict(counts), files)
        assert outs[False][0] == outs[True][0]  # same status counters
        assert outs[False][1] == outs[True][1]  # same bytes, images+labels

    def test_crop_square_device_encode_byte_identical(self, tmp_path, rng):
        """Square crops ship as sparse DCT coefficients on all-.jpg
        buckets (cv2 q95 anchor) — same bytes and labels as the pixel
        path (jit leg)."""
        from image_processor_pipeline_tpu.io import native
        from image_processor_pipeline_tpu.transforms.crop_square import (
            SquareCropAroundBBox,
        )
        if not native.available():
            pytest.skip("native engine unavailable")
        imgs = tmp_path / "imgs"
        lbls = tmp_path / "lbls"
        _mkimgs(imgs, n=4, size=(80, 100), suffix=".jpg", smooth=True)
        lbls.mkdir()
        for i in range(4):
            (lbls / f"x{i}.txt").write_text(
                f"{i % 3} 0.5 0.5 {0.2 + 0.05 * i:.6f} 0.25\n")
        outs = {}
        for tag, de in (("off", False), ("on", True)):
            t = SquareCropAroundBBox()
            pipe = ProcessingPipeline(root_dir=tmp_path)
            pipe.add_step(ProcessingStep(
                name=f"cs_{tag}", process_function=t,
                input_dirs=["imgs", "lbls"], pairing_method="zip",
                output_dirs=[f"oi_{tag}", f"ol_{tag}"], seed=31,
                options={"native_compute": False, "device_encode": de},
            ))
            c = pipe.run(progress=False)[0]
            assert c["Success"] == 4, c
            files = {}
            for sub in (f"oi_{tag}", f"ol_{tag}"):
                for p in sorted((tmp_path / sub).iterdir()):
                    files[f"{sub.split('_')[0]}/{p.name}"] = p.read_bytes()
            outs[tag] = files
        assert getattr(t, "_enc_total_n", 0) > 0
        assert getattr(t, "_enc_overflow_n", 0) == 0
        assert outs["off"] == outs["on"]


class TestRotationInterpolation:
    def test_bilinear_option(self, tmp_path):
        _mkimgs(tmp_path / "in", n=1, size=(30, 40))
        c = _run_step(tmp_path, RandomRotations(), ["in"], ["out"],
                      options={"num_rotations": 1, "include_original": False,
                               "interpolation": "bilinear"})
        assert c["Success"] == 1
        p = next((tmp_path / "out").iterdir())
        with Image.open(p) as im:
            assert im.mode == "RGBA"
            # PIL parity: bilinear transform CLAMPS taps at the image border
            # and fills outside — alpha stays binary (probed against Pillow;
            # partial edge alpha would mean we blend with the transparent
            # padding, which PIL does not)
            a = np.asarray(im)[..., 3]
            assert set(np.unique(a)) <= {0, 255}
            assert (a == 255).any() and (a == 0).any()


class TestSymmetryProbePath:
    def test_gray_png_keeps_native_bands(self, tmp_path, rng):
        # gray inputs must NOT take the batched probe path (the native
        # decoder normalizes to RGB; load_item's PIL path keeps L) — the
        # 'o' output must stay single-band grayscale
        from PIL import Image

        from image_processor_pipeline_tpu import (
            ProcessingPipeline, ProcessingStep)
        from image_processor_pipeline_tpu.transforms import (
            GenerateSymmetries)

        (tmp_path / "in").mkdir()
        arr = rng.integers(0, 256, (24, 30), np.uint8)
        Image.fromarray(arr, "L").save(tmp_path / "in" / "g.png")
        rgbarr = rng.integers(0, 256, (24, 30, 3), np.uint8)
        Image.fromarray(rgbarr).save(tmp_path / "in" / "c.png")
        pipe = ProcessingPipeline(root_dir=tmp_path)
        pipe.add_step(ProcessingStep(
            name="sym", process_function=GenerateSymmetries(),
            input_dirs=["in"], output_dirs=["out"], seed=1))
        counters = pipe.run(progress=False)
        assert counters[0]["Success"] == 2
        gray_o = Image.open(tmp_path / "out" / "g_o.png")
        assert gray_o.mode == "L"
        np.testing.assert_array_equal(np.asarray(gray_o), arr)
        col_o = Image.open(tmp_path / "out" / "c_o.png")
        assert col_o.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(col_o), rgbarr)
        # flipped outputs exist and match numpy flips for both
        gh = np.asarray(Image.open(tmp_path / "out" / "g_h.png"))
        np.testing.assert_array_equal(gh, arr[:, ::-1])
        ch = np.asarray(Image.open(tmp_path / "out" / "c_h.png"))
        np.testing.assert_array_equal(ch, rgbarr[:, ::-1])


class TestOverlayProbe:
    def test_probe_matches_load_byte_identical(self, tmp_path):
        """The overlay probe path (two native batch decodes per bucket,
        VERDICT r2 weak #4) must be byte-identical to the per-item
        load_item path — across JPEG/PNG overlays and backgrounds,
        including a grayscale overlay that exercises the forced-RGBA
        conversion."""
        rng = np.random.default_rng(11)
        ov_dir = tmp_path / "overlays"
        bg_dir = tmp_path / "bgs"
        ov_dir.mkdir()
        bg_dir.mkdir()
        ov_rgba = rng.integers(0, 256, size=(24, 30, 4), dtype=np.uint8)
        Image.fromarray(ov_rgba).save(ov_dir / "a_rgba.png")
        ov_rgb = rng.integers(0, 256, size=(20, 26, 3), dtype=np.uint8)
        Image.fromarray(ov_rgb).save(ov_dir / "b_rgb.png")
        Image.fromarray(ov_rgb).save(ov_dir / "c_jpg.jpg")
        ov_gray = rng.integers(0, 256, size=(18, 22), dtype=np.uint8)
        Image.fromarray(ov_gray, mode="L").save(ov_dir / "d_gray.png")
        for i, suffix in enumerate((".jpg", ".png")):
            bg = rng.integers(0, 256, size=(100, 150, 3), dtype=np.uint8)
            Image.fromarray(bg).save(bg_dir / f"bg{i}{suffix}")

        def run(out_name, transform):
            return _run_step(
                tmp_path, transform, ["overlays", "bgs"],
                [f"{out_name}/imgs", f"{out_name}/labels"],
                pairing_method="modulo",
            )

        c1 = run("probed", PasteOverlayOntoBackground())
        no_probe = PasteOverlayOntoBackground()
        no_probe.probe_item = lambda inputs, options: None
        c2 = run("loaded", no_probe)
        assert c1["Success"] == c2["Success"] == 4
        outs = sorted((tmp_path / "probed/imgs").iterdir()) + sorted(
            (tmp_path / "probed/labels").iterdir())
        assert len(outs) == 8
        for p in outs:
            q = tmp_path / "loaded" / p.parent.name / p.name
            assert p.read_bytes() == q.read_bytes(), p.name

    def test_probe_corrupt_background_is_item_error(self, tmp_path):
        """A corrupt file behind the probe path logs Error; the run
        continues (same failure semantics as the single-image path)."""
        rng = np.random.default_rng(5)
        ov_dir = tmp_path / "overlays"
        bg_dir = tmp_path / "bgs"
        ov_dir.mkdir()
        bg_dir.mkdir()
        for i in range(3):
            ov = rng.integers(0, 256, size=(24, 30, 4), dtype=np.uint8)
            Image.fromarray(ov).save(ov_dir / f"ov{i}.png")
        bg = rng.integers(0, 256, size=(100, 150, 3), dtype=np.uint8)
        Image.fromarray(bg).save(bg_dir / "bg0.jpg")
        # valid PNG signature + IHDR (so the header probe succeeds) but a
        # garbage body — the pixel decode must fail hard
        Image.fromarray(bg).save(bg_dir / "bg1.png")
        good = (bg_dir / "bg1.png").read_bytes()
        (bg_dir / "bg1.png").write_bytes(good[:33] + b"\x00" * 64)

        c = _run_step(
            tmp_path, PasteOverlayOntoBackground(),
            ["overlays", "bgs"], ["o/i", "o/l"], pairing_method="modulo",
        )
        assert c["Success"] + c["Error"] == 3
        assert c["Error"] >= 1


class TestD2HMetering:
    def test_native_decline_still_metered(self, tmp_path):
        """native_compute on with a transform whose native twin DECLINES
        (bilinear rotations have no C++ twin) falls back to the jit
        path: its outputs are device-resident, so the step's D2H byte
        meters must engage (the gate keys on output residency, not on
        the engine's use_native flag)."""
        _mkimgs(tmp_path / "in", n=2, size=(30, 40))
        from image_processor_pipeline_tpu import (
            ProcessingPipeline, ProcessingStep,
        )

        pipe = ProcessingPipeline(root_dir=tmp_path)
        step = ProcessingStep(
            name="t", process_function=RandomRotations(),
            input_dirs=["in"], output_dirs=["out"], seed=11,
            options={"native_compute": True, "method": "bilinear",
                     "interpolation": "bilinear", "num_rotations": 2},
        )
        pipe.add_step(step)
        c = pipe.run(progress=False)[0]
        assert c["Success"] == 2
        assert step.metrics.d2h_bytes_full > 0
        assert step.metrics.d2h_bytes_fetched > 0
