"""Faults planted in the program's timed path, to show that the check
calls such a run not correct: by the CPU tests at the tiny size, and by
``python3 -m gpbench.calibrate --fault <name>`` at a cell's own size on the
card. The benchmark's own runs never import this module.

Each fault is (module, attribute, replacement); ``plant`` sets it, with
``setattr`` or a test's ``monkeypatch.setattr``. The cells run on one card,
so no fault of an exchange between cards applies.
"""

from __future__ import annotations


def altered_token():
    """Every sampled token is the next id: a token altered where it is
    produced."""
    from glimpseprune_torch.models.qwen2_5_vl import gp_model
    real = gp_model.sample_next

    def altered(logits, temperature=None, noise=None):
        return (real(logits, temperature, noise) + 1) % logits.shape[-1]
    return gp_model, "sample_next", altered


def state_unchanged():
    """The decode step leaves the cache as it found it: no token's k/v is
    kept."""
    from glimpseprune_torch.models.qwen2_5_vl import language
    return language, "cache_append", lambda cache, kv, layer, idx: cache


def half_the_image():
    """The keep policy sees only the first half of the image tokens and
    its decision is repeated over the second half."""
    from glimpseprune_torch.models.qwen2_5_vl import gp_model
    real = gp_model.keep_scores_with_policy

    def half(probs, valid, *a, **k):
        n = probs.shape[-1] // 2
        kept = real(probs[..., :n].clone(), valid[..., :n], *a, **k)
        return kept.repeat(1, 2)[:, :probs.shape[-1]]
    return gp_model, "keep_scores_with_policy", half


FAULTS = {f.__name__: f for f in (altered_token, state_unchanged, half_the_image)}


def plant(name: str, set_attr=setattr) -> None:
    module, attr, replacement = FAULTS[name]()
    set_attr(module, attr, replacement)
