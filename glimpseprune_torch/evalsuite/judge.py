"""LLM-judge client over an OpenAI-compatible HTTP endpoint.

Prompt + score-extraction parity with the reference judge (utils.py:102-161):
system prompt asks for "score: <x>" in [0, 1]; failures degrade to 0.0.
Implemented with urllib (no OpenAI SDK dependency) so the judge can be any
vLLM / TGI / API host — it stays an external service exactly as in the
reference (scripts/vllm_serve.sh).

A copy of glimpseprune_tpu/evalsuite/judge.py (stdlib only);
tests/test_torch_evalsuite.py holds the two equal.
"""

from __future__ import annotations

import json
import re
import urllib.error
import urllib.request
from typing import List, Optional, Sequence

SYS_PROMPT = """
You are responsible for proofreading the answers, you need to give a score to the model's answer by referring to the standard answer, based on the given question. The full score is 1 point and the minimum score is 0 points. Please output the score in the form "score: <score>". The evaluation criteria require that the closer the model's answer is to the standard answer, the higher the score.
"""

PROMPT = """
question: {}
standard answer: {}
model's answer: {}
"""


def extract_score(text: str) -> float:
    lower = text.lower()
    if "score" not in lower:
        return 0.0
    found = re.findall(r"score: ([\d\.]+)", lower)
    if len(found) != 1:
        return 0.0
    return min(max(float(found[0]), 0.0), 1.0)


class LLMClient:
    """Minimal chat-completions client; score() mirrors the reference API.

    Scoring fans out over a thread pool (`concurrency`): the reference's
    judge endpoint is served by vLLM which batches concurrent requests
    (reference test_api.py:17-60 load-tests exactly this; the serial
    python-loop path in cal_cot_score.py is its bottleneck). Order of the
    returned scores always matches the input order.
    """

    def __init__(self, base_url: str, api_key: str = "EMPTY",
                 model_name: str = "judge", timeout: float = 20.0,
                 concurrency: int = 16):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.model_name = model_name
        self.timeout = timeout
        self.concurrency = max(int(concurrency), 1)

    def chat(self, messages: Sequence[dict], temperature: float = 0.0) -> str:
        body = json.dumps(
            {"model": self.model_name, "messages": list(messages), "temperature": temperature}
        ).encode()
        req = urllib.request.Request(
            f"{self.base_url}/chat/completions",
            data=body,
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.api_key}",
            },
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            data = json.loads(resp.read())
        return data["choices"][0]["message"]["content"]

    def _score_one(self, query: str, answer: str, completion: str) -> float:
        messages = [
            {"role": "system", "content": SYS_PROMPT},
            {"role": "user", "content": PROMPT.format(query, answer, completion)},
        ]
        try:
            return extract_score(self.chat(messages))
        except Exception:
            return 0.0  # judge failure -> 0 (reference utils.py:158-161)

    def score(
        self,
        query_texts: Sequence[str],
        completion_texts: Sequence[str],
        answer_texts: Sequence[str],
    ) -> List[float]:
        items = list(zip(query_texts, answer_texts, completion_texts))
        if len(items) <= 1 or self.concurrency == 1:
            return [self._score_one(q, a, c) for q, a, c in items]
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(self.concurrency, len(items))) as ex:
            return list(ex.map(lambda t: self._score_one(*t), items))
