"""Flagship fused chain + fast rotation paths + mesh sharding tests."""

import json
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from image_processor_pipeline_tpu.models.chains import AugmentChain, augment_chain
from image_processor_pipeline_tpu.ops import geometry


class TestShearRotation:
    @pytest.mark.parametrize("angle", [17.0, 45.0, 90.0, 133.0, 180.0, 260.0, 359.0])
    def test_close_to_gather_rotation(self, angle):
        rng = np.random.default_rng(0)
        S = 64
        img = jnp.asarray(rng.integers(0, 256, (S, S, 3), dtype=np.uint8))
        ref = np.asarray(geometry.rotate_fixed(img, S, S, angle))
        got = np.asarray(geometry.rotate_square_shear(img, angle))
        frac = (ref == got).all(axis=-1).mean()
        if angle % 90 == 0:
            assert frac == 1.0  # quarter turns are exact
        else:
            # 3-shear nearest vs direct nearest: same footprint, ±1 px jitter
            assert frac > 0.6
            nz_ref = ref.sum(-1) > 0
            nz_got = got.sum(-1) > 0
            iou = (nz_ref & nz_got).sum() / max(1, (nz_ref | nz_got).sum())
            assert iou > 0.85

    def test_large_canvas_shifts_not_clipped(self):
        """Regression: BITS=9 silently clipped shear shifts at ±255,
        distorting rotations on canvases > ~720px."""
        from image_processor_pipeline_tpu.ops.geometry import shift_bits_for

        assert shift_bits_for(512) == 9
        assert shift_bits_for(768) == 10
        assert shift_bits_for(2048) == 11

        rng = np.random.default_rng(0)
        S = 768
        img = jnp.asarray(rng.integers(0, 256, (S, S, 3), dtype=np.uint8))
        ref = np.asarray(geometry.rotate_fixed(img, S, S, 44.0))
        got = np.asarray(geometry.rotate_square_shear(img, 44.0))
        nz_ref = ref.sum(-1) > 0
        nz_got = got.sum(-1) > 0
        iou = (nz_ref & nz_got).sum() / max(1, (nz_ref | nz_got).sum())
        assert iou > 0.9  # was ~0.5 with clipped shifts

    def test_content_preserving_for_small_angles(self):
        # shears are permutations: pixel multiset is preserved inside frame
        S = 64
        img = jnp.zeros((S, S, 3), jnp.uint8).at[20:40, 20:40, 0].set(200)
        out = np.asarray(geometry.rotate_square_shear(img, 10.0))
        # content pixel count preserved (no resampling loss, block well inside)
        assert abs(int((out[..., 0] == 200).sum()) - 400) <= 8


class TestAugmentChain:
    def test_shapes_and_dtype(self):
        ch = AugmentChain(input_size=640)
        imgs, xy, seeds = ch.example_inputs(4)
        out = np.asarray(ch(imgs, xy, seeds))
        assert out.shape == (4, 512, 512, 4)
        assert out.dtype == np.uint8

    def test_reproducible_and_seed_sensitive(self):
        ch = AugmentChain(input_size=640)
        imgs, xy, seeds = ch.example_inputs(2)
        a = np.asarray(ch(imgs, xy, seeds))
        b = np.asarray(ch(imgs, xy, seeds))
        np.testing.assert_array_equal(a, b)
        c = np.asarray(ch(imgs, xy, seeds + 100))
        assert not (a == c).all()

    def test_rotation_modes_agree_on_footprint(self):
        imgs = np.random.default_rng(0).integers(
            0, 256, (2, 96, 96, 3), dtype=np.uint8
        )
        xy = np.tile(np.asarray([0.5, 0.5, 0.2, 0.2], np.float32), (2, 1))
        seeds = np.arange(2, dtype=np.uint32)
        fn = jax.jit(augment_chain, static_argnums=(3, 4))
        a = np.asarray(fn(imgs, xy, seeds, 64, "shear"))
        b = np.asarray(fn(imgs, xy, seeds, 64, "gather"))
        assert a.shape == b.shape == (2, 64, 64, 4)
        # same crop + similar rotation footprint
        nz_a = a[..., :3].sum(-1) > 0
        nz_b = b[..., :3].sum(-1) > 0
        iou = (nz_a & nz_b).sum() / max(1, (nz_a | nz_b).sum())
        assert iou > 0.8


class TestFullReference:
    """rotation='full_reference': the chain in flip-first order."""

    @pytest.mark.parametrize("flip", [0, 1, 2, 3])
    def test_matches_hand_composition(self, flip):
        from image_processor_pipeline_tpu.models import chains
        from image_processor_pipeline_tpu.ops import color as color_ops
        from image_processor_pipeline_tpu.ops import photometric

        rng = np.random.default_rng(flip)
        B, SIN, S = 2, 96, 64
        imgs = rng.integers(0, 256, (B, SIN, SIN, 3), np.uint8)
        y0 = rng.integers(0, SIN - S + 1, B).astype(np.int32)
        x0 = rng.integers(0, SIN - S + 1, B).astype(np.int32)
        angles = np.asarray([23.0, 301.0], np.float32)
        prms = rng.uniform(0.7, 1.3, (B, 6)).astype(np.float32)
        flips = np.full((B,), flip, np.int32)
        got = np.asarray(jax.jit(
            chains.augment_full_reference, static_argnames="crop")(
            imgs, y0, x0, angles, prms, flips, crop=S))

        for i in range(B):
            img = imgs[i, y0[i]:y0[i] + S, x0[i]:x0[i] + S]
            if flip & 1:
                img = img[:, ::-1]
            if flip & 2:
                img = img[::-1]
            img = geometry.rotate_square_shear(jnp.asarray(img), angles[i])
            alpha = color_ops.color_mask_alpha(
                img, S, S,
                jnp.asarray(chains._FILTER_LOWERS, jnp.float32),
                jnp.asarray(chains._FILTER_UPPERS, jnp.float32),
                jnp.asarray(chains._FILTER_ZONES, jnp.int32))
            img = photometric.brightness(img, prms[i, 0])
            img = photometric.contrast(img, prms[i, 1])
            img = photometric.color_balance(img, prms[i, 2])
            img = photometric.channel_gains(img, prms[i, 3:6])
            want = np.concatenate(
                [np.asarray(img), np.asarray(alpha)[..., None]], axis=-1)
            np.testing.assert_array_equal(got[i], want)

    @pytest.mark.parametrize("mode", [
        "pallas", "pallas_fused", "fused_reference", "pallas_full",
        "pallas_full:gath,interp"])
    def test_removed_modes_raise(self, mode):
        imgs = np.zeros((2, 96, 96, 3), np.uint8)
        xy = np.tile(np.asarray([0.5, 0.5, 0.2, 0.2], np.float32), (2, 1))
        seeds = np.arange(2, dtype=np.uint32)
        with pytest.raises(ValueError, match="unknown rotation mode"):
            augment_chain(imgs, xy, seeds, 64, mode)


class TestMeshSharding:
    def test_sharded_step_8_devices(self):
        from image_processor_pipeline_tpu.parallel.mesh import (
            make_mesh,
            sharded_augment_step,
        )

        n = len(jax.devices())
        assert n == 8, "conftest must provide 8 virtual CPU devices"
        mesh = make_mesh(8, shape=(4, 2))
        step = sharded_augment_step(mesh, crop=64)
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, (8, 96, 96, 3), dtype=np.uint8)
        xy = np.tile(np.asarray([0.5, 0.5, 0.2, 0.2], np.float32), (8, 1))
        seeds = np.arange(8, dtype=np.uint32)
        with mesh:
            out, count = step(images, xy, seeds)
        assert out.shape == (8, 64, 64, 4)
        assert int(count) == 8

    def test_global_counter_psum(self):
        from image_processor_pipeline_tpu.parallel.distributed import (
            global_counter,
        )
        from image_processor_pipeline_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(8, shape=(8, 1))
        assert global_counter(5, mesh) == 5

    def test_sharding_matches_single_device(self):
        """Batch-sharded result must equal the unsharded computation."""
        from image_processor_pipeline_tpu.parallel.mesh import (
            make_mesh,
            sharded_augment_step,
        )

        mesh = make_mesh(8, shape=(8, 1))
        step = sharded_augment_step(mesh, crop=64)
        rng = np.random.default_rng(3)
        images = rng.integers(0, 256, (8, 96, 96, 3), dtype=np.uint8)
        xy = np.tile(np.asarray([0.5, 0.5, 0.2, 0.2], np.float32), (8, 1))
        seeds = np.arange(8, dtype=np.uint32)
        with mesh:
            out, _ = step(images, xy, seeds)
        ref = jax.jit(augment_chain, static_argnums=(3, 4))(
            images, xy, seeds, 64, "shear"
        )
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


class TestEngineMesh:
    """In-process multi-device data parallelism: ProcessingStep(mesh=...)
    fans the bucket batch axis over the local devices (the reference's
    workers=-1 all-cores ergonomics mapped to chips)."""

    def _run(self, tmp_path, mesh, out, n=11, fmt="png", **opts):
        from PIL import Image

        from image_processor_pipeline_tpu.pipeline import (
            ProcessingPipeline,
            ProcessingStep,
        )
        from image_processor_pipeline_tpu.transforms.fused import (
            Enhance,
            Flip,
            FusedChain,
            Rotate,
        )

        src = tmp_path / "src"
        if not src.exists():
            src.mkdir()
            rng = np.random.default_rng(7)
            for i in range(n):
                arr = rng.integers(0, 256, (40 + (i % 3), 52, 3), np.uint8)
                Image.fromarray(arr).save(src / f"im{i}.{fmt}")
        pipe = ProcessingPipeline(root_dir=tmp_path)
        pipe.add_step(ProcessingStep(
            name="chain", process_function=FusedChain(
                [Rotate(method="shear"), Flip(), Enhance()]),
            input_dirs=["src"], output_dirs=[out], seed=99, mesh=mesh,
            save_log=True,
            # jit path on all legs: mesh parallelism is the device path
            options={"native_compute": False, **opts},
        ))
        counters = pipe.run(progress=False)
        report = json.loads((tmp_path / "chain.json").read_text())
        files = {p.name: p.read_bytes()
                 for p in sorted((tmp_path / out).iterdir())}
        return counters[0], report, files

    def test_engine_mesh_byte_identical(self, tmp_path):
        """Files-in/files-out over 8 virtual devices: byte-identical
        outputs and an identical report vs the single-device run — n=11
        forces non-multiple batches through the mesh padding."""
        c1, r1, f1 = self._run(tmp_path, None, "out_single")
        c8, r8, f8 = self._run(tmp_path, "auto", "out_mesh")
        assert c1 == c8 and c8["Success"] == 11
        assert f1 == f8
        strip = lambda rep: [  # noqa: E731
            {**e, "outputs": [str(Path(o).name) for o in e["outputs"] or []]}
            for e in (rep if isinstance(rep, list) else rep["items"])
        ]
        assert strip(r1) == strip(r8)

    def test_engine_mesh_with_device_decode(self, tmp_path):
        """Mesh padding duplicates tail items; the hybrid device decode
        must still engage on those padded chunks (unique head decodes on
        device, zero tail rows) and stay byte-identical to the
        single-device pixel-decode run.  JPEG sources so the coefficient
        transport is actually exercised; n=11 is not a multiple of the
        4-wide data axis."""
        from image_processor_pipeline_tpu.io import native
        if not native.available():
            pytest.skip("native engine unavailable")
        c1, r1, f1 = self._run(tmp_path, None, "out_px", fmt="jpg")
        c8, r8, f8 = self._run(tmp_path, "auto", "out_dd", fmt="jpg",
                               device_decode=True)
        assert c1 == c8 and c8["Success"] == 11
        assert f1 == f8

    def test_engine_mesh_defaults(self, tmp_path):
        """Default mesh=None is single-device on the CPU backend (native
        twins are the fast path there); False forces off; 'auto' builds
        over all local devices."""
        from image_processor_pipeline_tpu.pipeline import ProcessingStep
        from image_processor_pipeline_tpu.transforms.enhance import (
            EnhanceImage,
        )

        def mk(mesh):
            return ProcessingStep(
                "m", EnhanceImage(), input_dirs=["x"], output_dirs=["y"],
                root_dir=tmp_path, mesh=mesh)

        assert mk(None)._resolve_mesh() is None   # cpu backend default
        assert mk(False)._resolve_mesh() is None
        assert mk("auto")._resolve_mesh().shape["data"] == 8

    def test_engine_mesh_int_and_validation(self, tmp_path):
        import pytest as _pytest

        from image_processor_pipeline_tpu.pipeline import ProcessingStep
        from image_processor_pipeline_tpu.transforms.enhance import (
            EnhanceImage,
        )

        step = ProcessingStep(
            "bad", EnhanceImage(), input_dirs=["x"], output_dirs=["y"],
            root_dir=tmp_path, mesh="bogus")
        with _pytest.raises(ValueError):
            step._resolve_mesh()
        step1 = ProcessingStep(
            "one", EnhanceImage(), input_dirs=["x"], output_dirs=["y"],
            root_dir=tmp_path, mesh=1)
        assert step1._resolve_mesh() is None
        step4 = ProcessingStep(
            "four", EnhanceImage(), input_dirs=["x"], output_dirs=["y"],
            root_dir=tmp_path, mesh=4)
        assert step4._resolve_mesh().shape["data"] == 4


class TestShardBatch:
    def test_shard_batch_wrapper(self):
        from image_processor_pipeline_tpu.parallel.mesh import (
            make_mesh,
            shard_batch,
        )

        mesh = make_mesh(8, shape=(8, 1))
        fn = shard_batch(lambda x: x * 2, mesh)
        x = np.arange(16, dtype=np.int32)
        with mesh:
            out = np.asarray(fn(x))
        np.testing.assert_array_equal(out, x * 2)

    def test_make_mesh_shape_validation(self):
        from image_processor_pipeline_tpu.parallel.mesh import make_mesh

        with pytest.raises(ValueError):
            make_mesh(8, shape=(3, 2))

    def test_make_mesh_rejects_over_ask(self):
        """Asking for more devices than the pool raises instead of a
        silent truncation (review r4)."""
        from image_processor_pipeline_tpu.parallel.mesh import make_mesh

        with pytest.raises(ValueError):
            make_mesh(9)  # conftest provides exactly 8
        assert make_mesh(
            4, devices=jax.local_devices()[:4]).shape["data"] == 4
