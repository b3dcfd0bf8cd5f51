"""Judging what the timed path served, against the float32 reference.

For each sampled request the reference works the keep logits out again
from the pixels, the prompt and the weights, and reads:

- ``keep_policy_flips``: the image tokens whose keeping departs from the
  recipe's policy (threshold, cap, floor) applied to the program's own keep
  logits; a token that ties with the decision boundary is excused. An exact
  check of the keep decision: the keep set is the policy's, whatever the
  logits it was taken from.
- ``keep_gap``: the widest distance, in keep logits, from the recipe's
  decision boundary of an image token on whose keeping the program and the
  reference disagree (0 where they agree). A near tie gives a small gap: the
  program is judged by how far its keep set departs, not by equality.
- ``token_gap``: the widest gap by which a served token's logit lies below
  the reference's best at its position, the reference following the
  program's keep set and served tokens (valid for greedy decoding).
- ``token_gap_mean``: the mean of those gaps over the request's served
  tokens (0 where every served token is the reference's best).
- ``keep_err``: the RMS distance of the program's keep logits from the
  reference's, over the spread (RMS about their mean) of the reference's.
- ``logit_err``: the same for the first logits, the prefill's output, the
  reference following the program's keep set.

The reference reads the program's keep set and tokens only to judge them.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from gpbench.reference.model import Reference, Request


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    """RMS(got - want) over RMS(want - mean(want))."""
    got, want = got.float().to(want.device).reshape(-1), want.float().reshape(-1)
    return float((got - want).pow(2).mean().sqrt() / (want - want.mean()).pow(2).mean().sqrt())


def policy_flips(ref: Reference, logits: torch.Tensor, keep: torch.Tensor) -> int:
    """Tokens whose keeping departs from the recipe's policy on ``logits``
    [N], those at the decision boundary itself excused."""
    differ = ref.keep_policy(logits) != keep
    return int((differ & (logits != ref.boundary(logits))).sum())


def judge_request(ref: Reference, req: Request, keep_img: torch.Tensor,
                  keep_logits: torch.Tensor, first_logits: torch.Tensor,
                  served: Sequence[int]) -> Dict[str, float]:
    """The reference's reading of one served request: the program's keep
    set [N] and keep logits [N], its first logits [V] and its tokens."""
    st = ref.glimpse(req)
    m = st["keep_logits"]
    keep_prog = keep_img.to(m.device).bool()
    if keep_prog.shape != m.shape:
        raise ValueError(f"a keep set of {tuple(keep_prog.shape)} for {m.shape[0]} image tokens")
    differ = ref.keep_policy(m) != keep_prog
    tau = ref.boundary(m)
    keep_gap = float((m[differ] - tau).abs().max()) if bool(differ.any()) else 0.0
    own = policy_flips(ref, keep_logits.float().to(m.device), keep_prog)
    logits = ref.served_logits(st, keep_prog, served)
    tok = torch.as_tensor(list(served), device=logits.device)
    gaps = logits.max(-1).values - logits.gather(1, tok[:, None])[:, 0]
    return {"keep_policy_flips": own, "keep_gap": keep_gap, "token_gap": float(gaps.max()),
            "token_gap_mean": float(gaps.mean()),
            "keep_err": rel_rms(keep_logits, m), "logit_err": rel_rms(first_logits, logits[0]),
            "keep_flips": int(differ.sum()), "tokens": len(served), "kept": int(keep_prog.sum())}
