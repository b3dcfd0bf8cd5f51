"""The port keeps its own copies of the JAX package's numpy-only modules
(``config``, ``registry``, ``preprocessing``) so that it imports nothing
of the JAX package. Each copy must behave as its original: the same
configuration from every directory under configs/ and from
``tiny_test_config``, and identical arrays from the preprocessing
functions on seeded inputs."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import glimpseprune_tpu.config as jax_config
import glimpseprune_tpu.preprocessing as jax_prep
from glimpseprune_tpu.registry import Registry as JaxRegistry
from test_torch_inputs import assert_same_fields

ROOT = Path(__file__).resolve().parents[1]
CONFIG_DIRS = sorted(p.parent.name for p in (ROOT / "configs").glob("*/config.json"))


@pytest.mark.parametrize("name", CONFIG_DIRS)
def test_model_config_load_matches_jax(name):
    import glimpseprune_torch.config as torch_config

    path = str(ROOT / "configs" / name)
    got, want = torch_config.ModelConfig.load(path), jax_config.ModelConfig.load(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("factory", ["tiny_test_config", "qwen2_5_vl_3b", "qwen2_5_vl_7b"])
def test_config_factories_match_jax(factory):
    import glimpseprune_torch.config as torch_config

    got, want = getattr(torch_config, factory)(), getattr(jax_config, factory)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_config_save_load_round_trip(tmp_path):
    """A config the port saves is the one the JAX package loads."""
    import glimpseprune_torch.config as torch_config

    cfg = torch_config.tiny_test_config(le_dropout_prob=0.1)
    cfg.save(str(tmp_path))
    assert dataclasses.asdict(jax_config.ModelConfig.load(str(tmp_path))) == \
        dataclasses.asdict(cfg)


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, (list, int, float)):
        assert got == want
    else:
        assert_same_fields(got, want)


GRIDS = np.array([[1, 8, 12], [1, 6, 6]], np.int64)
PREP_CASES = {
    "smart_resize": lambda m, rng: m.smart_resize(457, 1203, 28),
    "preprocess_image": lambda m, rng: m.preprocess_image(
        rng.integers(0, 256, (90, 130, 3), dtype=np.uint8)),
    "preprocess_video": lambda m, rng: m.preprocess_video(
        rng.integers(0, 256, (4, 60, 84, 3), dtype=np.uint8)),
    "get_window_index": lambda m, rng: m.get_window_index(GRIDS, 112, 2, 14),
    "build_vision_geometry": lambda m, rng: m.build_vision_geometry(GRIDS, 112, 2, 14,
                                                                     padded_len=256),
    "vision_pos_ids": lambda m, rng: m.vision_pos_ids(GRIDS, 2),
    "segment_ids": lambda m, rng: m.segment_ids_from_cu_seqlens(
        m.cu_seqlens_from_grid(GRIDS), 160),
    "get_rope_index": lambda m, rng: m.get_rope_index(
        np.array([[5, 7, 151652] + [151655] * 24 + [151653, 9, 11]]),
        image_grid_thw=np.array([[1, 8, 12]]), attention_mask=np.ones((1, 30), np.int64)),
    "ref_token_mask_from_bboxes": lambda m, rng: m.ref_token_mask_from_bboxes(
        [[0.1, 0.2, 0.45, 0.9], [0.6, 0.0, 1.0, 0.3]], (6, 9)),
    "bbox_grid_indices": lambda m, rng: m.bbox_grid_indices(
        [[0.1, 0.2, 0.45, 0.9], [0.3, 0.5, 0.7, 0.6]], (6, 9)),
}


@pytest.mark.parametrize("case", sorted(PREP_CASES))
def test_preprocessing_copy_matches_jax(case):
    import glimpseprune_torch.preprocessing as torch_prep
    from glimpseprune_torch.preprocessing import image as torch_image

    from glimpseprune_tpu.preprocessing import image as jax_image

    fn = PREP_CASES[case]
    torch_mod = torch_image if case == "preprocess_video" else torch_prep
    jax_mod = jax_image if case == "preprocess_video" else jax_prep
    _same(fn(torch_mod, np.random.default_rng(0)), fn(jax_mod, np.random.default_rng(0)))


def test_registry_copy_behaves_as_jax():
    from glimpseprune_torch.registry import Registry

    for cls in (Registry, JaxRegistry):
        reg = cls("thing")
        reg.register("a")(len)
        assert reg.get("a") is len
        with pytest.raises(Exception) as err:
            reg.get("b")
        assert "b" in str(err.value)
