"""The port's native image prep (glimpseprune_torch/preprocessing/native.py
over its own csrc/gp_preproc.cpp) against the JAX package's native path
(native/gp_preproc.cpp, built by its own ``build()``, into a temporary
path) and against the
port's PIL path; ``prepare_inputs(use_native_preproc=True)`` against JAX's;
a native build that fails raises; without PIL and without the native path
a resize raises an ImportError that names the native path.

The JAX package builds with ``-march=native`` and the port does not, so FMA
contraction may move the last bits of the floats: they are held within
1e-6 (builds of the same source with and without the flag differed by at
most 2.4e-7 on images of these sizes), and the uint8 resize exactly."""

import sys

import numpy as np
import pytest

from glimpseprune_tpu.config import tiny_test_config
from glimpseprune_tpu.preprocessing import native as jax_native


@pytest.fixture(scope="module")
def natives(tmp_path_factory):
    """The port's library, and the JAX package's built by its own build()
    into a private path (not native/, which the JAX package's own test
    builds into from another worker at the same time)."""
    from glimpseprune_torch.preprocessing import native

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH",
                   str(tmp_path_factory.mktemp("jax_native") / "libgp_preproc.so"))
        mp.setattr(jax_native, "_lib", None)
        jax_native.build()
        jax_native._load()
        native.build()
        yield native


@pytest.mark.parametrize("shape,resized_hw", [((300, 500), None), ((112, 140), (112, 140)),
                                              ((1000, 750), None), ((57, 211), (56, 112))])
def test_native_matches_jax_native(natives, shape, resized_hw):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape + (3,), dtype=np.uint8)
    got, g1 = natives.preprocess_image_native(img, resized_hw=resized_hw)
    want, g2 = jax_native.preprocess_image_native(img, resized_hw=resized_hw)
    assert tuple(g1) == tuple(g2)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    th, tw = resized_hw or (g1[1] * 14, g1[2] * 14)
    np.testing.assert_array_equal(natives.resize_bicubic_native(img, th, tw),
                                  jax_native.resize_bicubic_native(img, th, tw))


def test_native_against_pil_path(natives):
    """JAX's tolerances (tests/test_native_preproc.py): exact without a
    resize, close with one, the uint8 resize close to PIL's."""
    from PIL import Image

    from glimpseprune_torch.preprocessing.image import preprocess_image

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (112, 140, 3), dtype=np.uint8)
    ref, g1 = preprocess_image(img, resized_hw=(112, 140))
    out, g2 = natives.preprocess_image_native(img, resized_hw=(112, 140))
    assert g1 == g2
    np.testing.assert_allclose(out, ref, atol=1e-6)

    img = np.random.default_rng(1).integers(0, 255, (300, 500, 3), dtype=np.uint8)
    ref, g1 = preprocess_image(img)
    out, g2 = natives.preprocess_image_native(img)
    assert g1 == g2
    d = np.abs(out - ref)
    assert d.mean() < 0.01 and np.percentile(d, 99) < 0.05

    img = np.random.default_rng(2).integers(0, 255, (200, 333, 3), dtype=np.uint8)
    ours = natives.resize_bicubic_native(img, 112, 140)
    pil = np.asarray(Image.fromarray(img).resize((140, 112), Image.BICUBIC))
    diff = np.abs(ours.astype(int) - pil.astype(int))
    assert diff.mean() < 1.0 and (diff > 8).mean() < 0.01
    # sizes that the C code would index past are refused before the call
    for bad in ((50, 56), (0, 28), (28, -28)):
        with pytest.raises(ValueError):
            natives.preprocess_image_native(img, resized_hw=bad)
    with pytest.raises(ValueError):
        natives.resize_bicubic_native(img, 0, 10)


def test_prepare_inputs_native_equals_jax(natives):
    """A multi-image row and a single-image row, every image resized, through
    both packages' native paths: every field equal (patches within 1e-6)."""
    from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner

    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs

    cfg = tiny_test_config()
    rng = np.random.default_rng(3)
    marks = [cfg.vision_start_token_id, cfg.image_token_id, cfg.vision_end_token_id]
    prompts = [[7, 8] + marks + [9] + marks + [10, 11], [12] + marks + [13, 14, 15]]
    images = [[rng.integers(0, 256, (70, 90, 3), dtype=np.uint8),
               rng.integers(0, 256, (50, 61, 3), dtype=np.uint8)],
              rng.integers(0, 256, (100, 45, 3), dtype=np.uint8)]
    kw = dict(seq_multiple=8, patch_multiple=16, use_native_preproc=True)
    want = jax_runner.prepare_inputs(cfg, prompts, images, **kw)
    got = prepare_inputs(cfg, prompts, images, **kw)
    np.testing.assert_allclose(got.patches, want.patches, rtol=0, atol=1e-6)
    for name in ("input_ids", "valid", "position_ids", "vis_pos_ids", "full_seg", "vis_valid",
                 "packed_idx", "img_slots", "img_valid", "img_group", "grids", "n_img_tokens"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.out_len == want.out_len


def test_env_default_and_named_import_error(natives, monkeypatch):
    """Without PIL: the numpy path's resize raises an ImportError naming
    use_native_preproc and GP_NATIVE_PREPROC; the native path, asked for by
    the argument or by GP_NATIVE_PREPROC=1, resizes without PIL."""
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs

    cfg = tiny_test_config()
    img = np.random.default_rng(4).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    prompt = [[5, cfg.vision_start_token_id, cfg.image_token_id, cfg.vision_end_token_id, 6]]
    want = prepare_inputs(cfg, prompt, [img], seq_multiple=8, patch_multiple=16,
                          use_native_preproc=True)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.delenv("GP_NATIVE_PREPROC", raising=False)
    with pytest.raises(ImportError, match="use_native_preproc.*GP_NATIVE_PREPROC"):
        prepare_inputs(cfg, prompt, [img], seq_multiple=8, patch_multiple=16)
    with pytest.raises(ImportError, match="use_native_preproc"):
        prepare_inputs(cfg, prompt, [img], seq_multiple=8, patch_multiple=16,
                       use_native_preproc=False)
    monkeypatch.setenv("GP_NATIVE_PREPROC", "1")
    got = prepare_inputs(cfg, prompt, [img], seq_multiple=8, patch_multiple=16)
    np.testing.assert_array_equal(got.patches, want.patches)
    # an image already at its smart_resize size needs no resize, and no PIL
    at_size = img[:56, :84]
    prepare_inputs(cfg, prompt, [at_size], seq_multiple=8, patch_multiple=16,
                   use_native_preproc=False)


def test_failed_native_build_raises(natives, monkeypatch, tmp_path):
    """A native path that was asked for and cannot be built raises: nothing
    falls back to the PIL path."""
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs

    cfg = tiny_test_config()
    img = np.random.default_rng(5).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    prompt = [[5, cfg.vision_start_token_id, cfg.image_token_id, cfg.vision_end_token_id, 6]]
    monkeypatch.setattr(natives, "_lib", None)
    monkeypatch.setattr(natives, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(natives, "SOURCE", tmp_path / "missing.cpp")
    with pytest.raises(OSError):
        prepare_inputs(cfg, prompt, [img], seq_multiple=8, patch_multiple=16,
                       use_native_preproc=True)
    assert not natives.available()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(natives, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        prepare_inputs(cfg, prompt, [img], seq_multiple=8, patch_multiple=16,
                       use_native_preproc=True)
