"""Chat-template / conversation formatting.

A copy of glimpseprune_tpu/preprocessing/chat.py (pure Python; jinja2 is
imported only by ``render_qwen_chat_jinja``), kept so that the port imports
nothing of the JAX package; tests/test_torch_chat.py holds it byte-equal to
the original's renderings.

The reference trains and evals *through* the model's chat template: the Qwen
recipe renders conversations with the HF processor's jinja template
(GPCollator, reference train_qwen_gp.py:600-662; lmms wrapper
my_lmms_eval/models/qwen2_5_vl_gp.py:337-356), and LLaVA-1.5 uses
``conv_templates["vicuna_v1"]`` (reference llava/conversation.py:242-253).
Released checkpoints mis-answer without the exact prompt bytes, so this
module reproduces both formats exactly:

* ``render_qwen_chat`` — a pure-Python renderer of the Qwen2.5-VL-Instruct
  chat template (the public jinja template shipped in the model's
  tokenizer/processor config, vendored below as ``QWEN_CHAT_TEMPLATE``).
  tests/test_chat.py verifies byte-for-byte equality against a jinja2
  rendering with the same environment settings HF transformers uses.
* ``render_vicuna_v1`` — the LLaVA SeparatorStyle.TWO format.
* ``chat_prompt_ids`` — rendered text -> token ids, with special-token
  markers mapped to ids directly (never through the plain-text tokenizer)
  and one image placeholder id per ``<|image_pad|>`` marker, ready for
  ``prepare_inputs`` (which expands placeholders to the merged-grid count).
* ``split_sft_conversation`` — (prompt_ids, answer_ids) split at the last
  assistant turn, equivalent to the reference's mask-labels-until-last
  ``<|im_start|>``+3 rule (train_qwen_gp.py:606-620): everything up to and
  including ``<|im_start|>assistant\\n`` is prompt (label −100), the rest is
  answer.

Messages use the HF chat format::

    [{"role": "user", "content": [{"type": "image"},
                                  {"type": "text", "text": "what is this?"}]},
     {"role": "assistant", "content": "a cat"}]

``content`` may be a plain string (text-only turn) or a list of typed parts.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# --------------------------------------------------------------------------- #
# Qwen2.5-VL chat template
# --------------------------------------------------------------------------- #

# The public jinja chat template of Qwen/Qwen2.5-VL-*-Instruct (shipped in the
# hub tokenizer_config/chat_template.json). Vendored verbatim so the renderer
# below can be verified against a real jinja rendering offline.
QWEN_CHAT_TEMPLATE = (
    "{% set image_count = namespace(value=0) %}"
    "{% set video_count = namespace(value=0) %}"
    "{% for message in messages %}"
    "{% if loop.first and message['role'] != 'system' %}"
    "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
    "{% endif %}"
    "<|im_start|>{{ message['role'] }}\n"
    "{% if message['content'] is string %}"
    "{{ message['content'] }}<|im_end|>\n"
    "{% else %}"
    "{% for content in message['content'] %}"
    "{% if content['type'] == 'image' or 'image' in content or 'image_url' in content %}"
    "{% set image_count.value = image_count.value + 1 %}"
    "{% if add_vision_id %}Picture {{ image_count.value }}: {% endif %}"
    "<|vision_start|><|image_pad|><|vision_end|>"
    "{% elif content['type'] == 'video' or 'video' in content %}"
    "{% set video_count.value = video_count.value + 1 %}"
    "{% if add_vision_id %}Video {{ video_count.value }}: {% endif %}"
    "<|vision_start|><|video_pad|><|vision_end|>"
    "{% elif 'text' in content %}"
    "{{ content['text'] }}"
    "{% endif %}"
    "{% endfor %}"
    "<|im_end|>\n"
    "{% endif %}"
    "{% endfor %}"
    "{% if add_generation_prompt %}"
    "<|im_start|>assistant\n"
    "{% endif %}"
)

QWEN_DEFAULT_SYSTEM = "You are a helpful assistant."


def _is_image_part(part: Dict) -> bool:
    return part.get("type") == "image" or "image" in part or "image_url" in part


def _is_video_part(part: Dict) -> bool:
    return part.get("type") == "video" or "video" in part


def render_qwen_chat(
    messages: Sequence[Dict],
    add_generation_prompt: bool = False,
    add_vision_id: bool = False,
) -> str:
    """Render a conversation exactly like Qwen2.5-VL's chat template."""
    out: List[str] = []
    image_count = 0
    video_count = 0
    for i, message in enumerate(messages):
        role = message["role"]
        if i == 0 and role != "system":
            out.append(f"<|im_start|>system\n{QWEN_DEFAULT_SYSTEM}<|im_end|>\n")
        out.append(f"<|im_start|>{role}\n")
        content = message["content"]
        if isinstance(content, str):
            out.append(f"{content}<|im_end|>\n")
        else:
            for part in content:
                if _is_image_part(part):
                    image_count += 1
                    if add_vision_id:
                        out.append(f"Picture {image_count}: ")
                    out.append("<|vision_start|><|image_pad|><|vision_end|>")
                elif _is_video_part(part):
                    video_count += 1
                    if add_vision_id:
                        out.append(f"Video {video_count}: ")
                    out.append("<|vision_start|><|video_pad|><|vision_end|>")
                elif "text" in part:
                    out.append(part["text"])
            out.append("<|im_end|>\n")
    if add_generation_prompt:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def render_qwen_chat_jinja(
    messages: Sequence[Dict],
    add_generation_prompt: bool = False,
    add_vision_id: bool = False,
) -> str:
    """Ground-truth rendering via jinja2 with HF transformers' environment
    settings (ImmutableSandboxedEnvironment, trim_blocks, lstrip_blocks) —
    exactly what ``tokenizer.apply_chat_template`` executes. Used by tests to
    pin ``render_qwen_chat`` byte-for-byte; also usable directly."""
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True)
    tmpl = env.from_string(QWEN_CHAT_TEMPLATE)
    return tmpl.render(
        messages=messages,
        add_generation_prompt=add_generation_prompt,
        add_vision_id=add_vision_id,
    )


# --------------------------------------------------------------------------- #
# LLaVA vicuna_v1
# --------------------------------------------------------------------------- #

VICUNA_V1_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's "
    "questions."
)
VICUNA_V1_ROLES = ("USER", "ASSISTANT")
LLAVA_IMAGE_TOKEN = "<image>"


def render_vicuna_v1(
    messages: Sequence[Dict],
    add_generation_prompt: bool = False,
) -> str:
    """LLaVA-1.5 ``conv_templates["vicuna_v1"]`` (SeparatorStyle.TWO, sep=" ",
    sep2="</s>"; reference llava/conversation.py:53-63,242-253).

    Image parts render as ``<image>\\n`` prepended to the turn's text — the
    reference convention (get_prompt's tuple branch prepends "<image>\\n",
    conversation.py:33-42; eval does DEFAULT_IMAGE_TOKEN + "\\n" + qs).
    ``add_generation_prompt`` appends an empty ASSISTANT turn ("ASSISTANT:"),
    matching append_message(roles[1], None).
    """
    seps = (" ", "</s>")
    ret = VICUNA_V1_SYSTEM + seps[0]
    turns: List[Tuple[str, Optional[str]]] = []
    for message in messages:
        role = {"user": "USER", "assistant": "ASSISTANT"}.get(
            message["role"], message["role"].upper()
        )
        content = message["content"]
        if isinstance(content, str):
            text = content
        else:
            n_images = sum(1 for p in content if _is_image_part(p))
            body = "".join(p.get("text", "") for p in content if "text" in p)
            text = (LLAVA_IMAGE_TOKEN + "\n") * n_images + body
        turns.append((role, text))
    if add_generation_prompt:
        turns.append(("ASSISTANT", None))
    for i, (role, text) in enumerate(turns):
        if text:
            ret += role + ": " + text + seps[i % 2]
        else:
            ret += role + ":"
    return ret


# --------------------------------------------------------------------------- #
# rendered text -> token ids
# --------------------------------------------------------------------------- #


def qwen_special_ids(cfg, im_start_id: int = 151644, im_end_id: Optional[int] = None) -> Dict[str, int]:
    """Special-token id map for splitting rendered Qwen chat text.

    ``<|im_end|>`` IS Qwen's eos (id 151645 == cfg.eos_token_id); im_start is
    151645-1 in the released vocab but configurable for toy tokenizers.
    """
    return {
        "<|im_start|>": im_start_id,
        "<|im_end|>": cfg.eos_token_id if im_end_id is None else im_end_id,
        "<|vision_start|>": cfg.vision_start_token_id,
        "<|vision_end|>": cfg.vision_end_token_id,
        "<|image_pad|>": cfg.image_token_id,
        "<|video_pad|>": cfg.video_token_id,
    }


def chat_prompt_ids(
    text: str,
    tokenize: Callable[[str], List[int]],
    special_ids: Dict[str, int],
) -> List[int]:
    """Rendered chat text -> token ids.

    Splits on the special markers (mapped to ids directly — a plain-text
    tokenizer must never see them) and tokenizes the text in between. With an
    HF tokenizer whose ``tokenize`` already handles specials this produces
    identical ids, because HF tokenizers treat specials as atomic splits too.
    """
    if not special_ids:
        return list(tokenize(text))
    pattern = "|".join(re.escape(k) for k in sorted(special_ids, key=len, reverse=True))
    ids: List[int] = []
    pos = 0
    for m in re.finditer(pattern, text):
        if m.start() > pos:
            ids.extend(tokenize(text[pos : m.start()]))
        ids.append(special_ids[m.group(0)])
        pos = m.end()
    if pos < len(text):
        ids.extend(tokenize(text[pos:]))
    return ids


def split_sft_conversation(
    messages: Sequence[Dict],
    tokenize: Callable[[str], List[int]],
    special_ids: Dict[str, int],
    renderer: Callable[..., str] = render_qwen_chat,
) -> Tuple[List[int], List[int]]:
    """Full SFT conversation -> (prompt_ids, answer_ids).

    Equivalent to the reference's label masking (mask until last
    ``<|im_start|>`` + 3, train_qwen_gp.py:606-620): the rendered prefix up to
    and including the final assistant header is the prompt; the assistant
    reply (+ its closing markers) is the answer and carries labels.
    """
    assert messages and messages[-1]["role"] == "assistant", (
        "SFT conversation must end with an assistant turn"
    )
    full = renderer(list(messages), add_generation_prompt=False)
    prefix = renderer(list(messages[:-1]), add_generation_prompt=True)
    assert full.startswith(prefix), (full, prefix)
    prompt_ids = chat_prompt_ids(prefix, tokenize, special_ids)
    answer_ids = chat_prompt_ids(full[len(prefix):], tokenize, special_ids)
    return prompt_ids, answer_ids
