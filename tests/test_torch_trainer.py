"""The port's data pipeline and GPTrainer (glimpseprune_torch/training/
data.py, trainer.py, glimpseprune_torch/persistence.py) against the JAX
package's on one synthetic corpus, seed and set of tiny weights: the same
samples and batches, the same metric history over three steps, a resumed
run equal to an uninterrupted one, and a new-modules checkpoint that the
JAX package imports to the same values."""

import json
import os

import numpy as np
import pytest

from glimpseprune_tpu.persistence import load_torch_new_modules_file
from glimpseprune_tpu.training import data as jax_data
from glimpseprune_tpu.training.trainer import GPTrainer as JaxTrainer
from glimpseprune_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from test_torch_training import torch_model, torch_names, train_setup

HISTORY_KEYS = ("loss", "loc_loss", "le_loss", "mask_iou")


def make_corpus(tmp_path, n=8):
    """n jsonl rows over random images stored as .npy (read by np.load),
    with pixel boxes that the norm_bboxes mapper normalizes."""
    rng = np.random.default_rng(0)
    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir / "cot" / "toy", exist_ok=True)
    rows = []
    for i in range(n):
        name = f"img{i}.npy"
        h, w = (64, 96) if i % 2 else (56, 56)
        np.save(img_dir / "cot" / "toy" / name, rng.integers(0, 255, (h, w, 3), np.uint8))
        x0, y0 = rng.integers(0, 20, 2)
        rows.append({"question": f"What is in region {i}?", "answer": f"object {i}",
                     "image": name, "width": w, "height": h,
                     "bboxs": [[float(x0), float(y0), float(x0 + 30), float(y0 + 25)]],
                     "dataset": "toy", "split": "train"})
    jsonl = tmp_path / "toy_train.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in rows))
    config = {"datasets": [{"json_path": str(jsonl), "sampling_strategy": "first:6",
                            "mapper": "cot_train", "bbox_type": "xyxy",
                            "additional_mappers": ["norm_bboxes"], "score_funcs": ["llm"]}]}
    return config, str(img_dir)


def tokenize(text):
    return [5 + (ord(c) % 200) for c in text[:10]]


def tcfg_kwargs(out, epochs=2):
    return dict(batch_size=2, num_epochs=epochs, log_every=1, save_every=0, output_dir=out,
                seq_multiple=8, patch_multiple=16, learning_rate=3e-3)


def port_trainer(tmp_path, out, epochs=2, resume_from=None):
    from glimpseprune_torch.training.data import GPDataset
    from glimpseprune_torch.training.trainer import GPTrainer, TrainerConfig

    cfg, _, _, _, params = train_setup()
    config, img_dir = make_corpus(tmp_path)
    return GPTrainer(cfg, torch_model(cfg, params), GPDataset(config, img_dir=img_dir),
                     tokenize, load_image=np.load,
                     tcfg=TrainerConfig(**tcfg_kwargs(str(tmp_path / out), epochs)),
                     resume_from=resume_from)


@pytest.mark.parametrize("strategy", ["first:3", "end:2", "random:4", None])
def test_sampling_matches_jax(strategy):
    from glimpseprune_torch.training.data import _apply_sampling

    rows = list(range(10))
    assert _apply_sampling(rows, strategy, 42) == jax_data._apply_sampling(rows, strategy, 42)


def test_dataset_matches_jax(tmp_path):
    """Same samples (after mappers and both filters) and the same batches."""
    from glimpseprune_torch.training.data import GPDataset

    config, img_dir = make_corpus(tmp_path)
    kw = dict(img_dir=img_dir, tokenize=tokenize, filters=("image_exist", "inputs_seq_length"),
              filter_kwargs={"max_input_seq_length": 15})
    got, want = GPDataset(config, **kw), jax_data.GPDataset(config, **kw)
    assert 0 < len(got) == len(want) < 6  # the length filter dropped the 64x96 rows
    for a, b in zip(got.samples, want.samples):
        assert (a.query, a.answer, a.img_path, a.score_funcs) == (
            b.query, b.answer, b.img_path, b.score_funcs)
        np.testing.assert_allclose(a.normed_bboxes, b.normed_bboxes)
    assert [[s.answer for s in bt] for bt in got.batches(2, seed=3, drop_last=False)] == [
        [s.answer for s in bt] for bt in want.batches(2, seed=3, drop_last=False)]
    assert len(GPDataset(config, img_dir="/nonexistent")) == 0


def test_trainer_history_matches_jax(tmp_path):
    """Three GPTrainer steps (cosine schedule, AdamW, clip 1.0) on the same
    corpus and seed give the JAX trainer's history: the first step to fp32
    sum order, the next two after parameter updates that agree to ~1e-5
    (see test_three_steps_match_jax_train_state), so rtol 1e-4."""
    cfg, _, _, jmodel, params = train_setup()
    config, img_dir = make_corpus(tmp_path)
    want = JaxTrainer(cfg, jmodel, params, jax_data.GPDataset(config, img_dir=img_dir),
                      tokenize, load_image=np.load,
                      tcfg=JaxTrainerConfig(**tcfg_kwargs(str(tmp_path / "jax")))
                      ).train(max_steps=3)
    got = port_trainer(tmp_path, "port").train(max_steps=3)
    assert [h["step"] for h in got] == [h["step"] for h in want] == [1, 2, 3]
    for g, w in zip(got, want):
        for key in HISTORY_KEYS:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {g['step']} {key}")


def test_trainer_resume_equals_uninterrupted(tmp_path):
    """4 steps (across an epoch boundary: 3 steps per epoch), a new trainer
    resumed from the checkpoint, 2 more: steps 5 and 6 equal those of an
    uninterrupted 6-step run, dropout stream and schedule included."""
    full = port_trainer(tmp_path, "full", epochs=3).train(max_steps=6)
    port_trainer(tmp_path, "part", epochs=3).train(max_steps=4)
    resumed_trainer = port_trainer(tmp_path, "part", epochs=3,
                                   resume_from=str(tmp_path / "part"))
    assert resumed_trainer.step == 4
    resumed = resumed_trainer.train(max_steps=6)
    by_step = {h["step"]: h for h in full}
    assert [h["step"] for h in resumed] == [h["step"] for h in full]
    for h in resumed[4:]:
        for key in HISTORY_KEYS:
            np.testing.assert_allclose(h[key], by_step[h["step"]][key], rtol=1e-6,
                                       err_msg=f"step {h['step']} {key}")


def test_saved_new_modules_import_in_jax(tmp_path):
    """The trainer's new_modules_gp.pt (the reference release layout) goes
    through the JAX package's import_torch_new_modules to the port's
    trained values; load_new_modules restores them into a fresh model."""
    import torch

    from glimpseprune_torch.persistence import NEW_MODULES_FILE, load_new_modules
    from glimpseprune_torch.training.train_step import new_module_filter

    trainer = port_trainer(tmp_path, "ckpt")
    trainer.train(max_steps=2)
    trained = {k: v.detach().numpy() for k, v in trainer.model.state_dict().items()
               if new_module_filter(k)}
    cfg, _, _, _, params = train_setup()
    imported = torch_names(load_torch_new_modules_file(
        str(tmp_path / "ckpt" / NEW_MODULES_FILE), cfg))
    start = torch_names({})
    assert set(imported) == set(trained)
    for name, value in trained.items():
        np.testing.assert_array_equal(imported[name], value, err_msg=name)
    assert any(np.abs(trained[k] - start[k]).max() > 0 for k in trained)
    fresh, saved_cfg = load_new_modules(torch_model(cfg, params), str(tmp_path / "ckpt"))
    assert saved_cfg.gp.selected_layers == cfg.gp.selected_layers
    for name, p in fresh.state_dict().items():
        if new_module_filter(name):
            assert torch.equal(p, torch.as_tensor(trained[name])), name
