"""The port's chat layer against the JAX package's: the copy of
preprocessing/chat.py renders byte-equal text and equal ids on
tests/test_chat.py's conversations, ``prepare_chat_inputs`` gives the same
arrays field by field, and ``chat_collate`` the same batch. Exact equality
throughout: this is host-side Python and numpy."""

import numpy as np
import pytest

from glimpseprune_tpu.config import tiny_test_config
from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
from glimpseprune_tpu.preprocessing import chat as jax_chat
from glimpseprune_tpu.training import trainer as jax_trainer
from glimpseprune_tpu.training.data import TrainSample
from test_chat import CONVERSATIONS, _toy_tokenizer
from test_torch_inputs import assert_same_fields


@pytest.mark.parametrize("i", range(len(CONVERSATIONS)))
@pytest.mark.parametrize("gen", [False, True])
@pytest.mark.parametrize("vid", [False, True])
def test_chat_copy_renders_as_jax(i, gen, vid):
    from glimpseprune_torch.preprocessing import chat

    msgs = CONVERSATIONS[i]
    got = chat.render_qwen_chat(msgs, add_generation_prompt=gen, add_vision_id=vid)
    assert got == jax_chat.render_qwen_chat(msgs, add_generation_prompt=gen,
                                            add_vision_id=vid)
    assert got.encode() == jax_chat.render_qwen_chat_jinja(
        msgs, add_generation_prompt=gen, add_vision_id=vid).encode()
    assert chat.render_vicuna_v1(msgs, add_generation_prompt=gen) == \
        jax_chat.render_vicuna_v1(msgs, add_generation_prompt=gen)
    cfg = tiny_test_config()
    sids = chat.qwen_special_ids(cfg, im_start_id=497)
    assert sids == jax_chat.qwen_special_ids(cfg, im_start_id=497)
    tok = _toy_tokenizer()
    assert chat.chat_prompt_ids(got, tok, sids) == jax_chat.chat_prompt_ids(got, tok, sids)
    if msgs[-1]["role"] == "assistant":
        assert chat.split_sft_conversation(msgs, tok, sids) == \
            jax_chat.split_sft_conversation(msgs, tok, sids)


def chat_images(n):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (64, 96, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("is_sft", [True, False])
def test_prepare_chat_inputs_matches_jax(is_sft):
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_chat_inputs

    cfg = tiny_test_config()
    tok = _toy_tokenizer()
    sids = jax_chat.qwen_special_ids(cfg, im_start_id=497)
    # SFT: the whole conversation; inference: the user turn alone
    msgs = [CONVERSATIONS[2] if is_sft else CONVERSATIONS[2][:1]] * 2
    kwargs = dict(special_ids=sids, is_sft=is_sft, seq_multiple=8, patch_multiple=16,
                  normed_bboxes=[[[0.0, 0.0, 0.5, 1.0]], [[0.2, 0.2, 0.9, 0.8]]])
    want = jax_runner.prepare_chat_inputs(cfg, msgs, chat_images(2), tok, **kwargs)
    got = prepare_chat_inputs(cfg, msgs, chat_images(2), tok, **kwargs)
    assert_same_fields(want, got)
    assert (got.labels is not None) == is_sft


def test_chat_collate_matches_jax():
    from glimpseprune_torch.training import trainer as torch_trainer

    cfg = tiny_test_config()
    tok = _toy_tokenizer()
    samples = [TrainSample("What is this?", "a cat", "a.jpg", [[0.0, 0.0, 0.5, 1.0]]),
               TrainSample("And here?", "two dogs", "b.jpg", [[0.5, 0.0, 1.0, 1.0]])]
    imgs = dict(zip(("a.jpg", "b.jpg"), chat_images(2)))
    kw = dict(seq_multiple=8, patch_multiple=16)
    want = jax_trainer.chat_collate(cfg, samples, tok, imgs.__getitem__,
                                    jax_trainer.TrainerConfig(**kw), im_start_id=497)
    got = torch_trainer.chat_collate(cfg, samples, tok, imgs.__getitem__,
                                     torch_trainer.TrainerConfig(**kw), im_start_id=497,
                                     device="cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    n_labelled = (got["labels"] != -100).sum(1).tolist()
    assert n_labelled == [len(tok(a)) + 1 + len(tok("\n")) for a in ("a cat", "two dogs")]
