"""The port's evaluation harness (glimpseprune_torch/evalsuite) against the
JAX package's: every host-side function (data mappers and sharding, the
scorers with their resume, the judge's score parsing, the official
protocols' loaders and scores, the short-form metrics and prompts) gives
exactly JAX's output on the same inputs and files; ``run_inference``
(generate and glimpse) on shared tiny weights writes JAX's jsonl record for
record; ``run_task`` (gqa) gives JAX's score; and ``LLMClient`` keeps the
input order against a local judge. Exact equality throughout."""

import dataclasses
import http.server
import importlib
import json
import os
import re
import socketserver
import threading
from types import SimpleNamespace

import numpy as np
import pytest

MODULES = ("data", "scorers", "judge", "protocols", "shortform")


@pytest.fixture(scope="module")
def packages():
    return {name: SimpleNamespace(**{m: importlib.import_module(f"{name}.evalsuite.{m}")
                                     for m in MODULES})
            for name in ("glimpseprune_tpu", "glimpseprune_torch")}


def plain(x):
    """Outputs of either package as comparable plain values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, plain(dataclasses.asdict(x)))
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


# --------------------------------------------------------------------------- #
# fixture files, written once and read by both packages

def write_viscot(root, n=4):
    """A VisCoT-format benchmark over PNG images (both packages read their
    size through PIL), boxes on all rows but the last."""
    from PIL import Image

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "images", "cot"), exist_ok=True)
    data = []
    for i in range(n):
        name = f"cot/{i}.png"
        shape = (64, 96, 3) if i % 2 == 0 else (56, 56, 3)
        Image.fromarray(rng.integers(0, 255, shape, dtype=np.uint8)).save(
            os.path.join(root, "images", name))
        image = [name, f"{name}###[10, 10, 40, {30 + i}]"] if i < n - 1 else [name]
        data.append({
            "dataset": "toy", "question_id": i, "image": image,
            "conversations": [
                {"from": "human", "value": f"<image>\nWhat is object {i}? Please provide the "
                 "bounding box coordinate of the region that can help you answer the "
                 "question better."},
                {"from": "gpt", "value": "[0.1, 0.1, 0.4, 0.4]"},
                {"from": "human", "value": "<image>"},
                {"from": "gpt", "value": f"thing{i}"},
            ],
        })
    path = os.path.join(root, "viscot.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return path, os.path.join(root, "images")


def write(root, name, content):
    path = os.path.join(root, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(content)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("evalsuite"))
    bench, img_dir = write_viscot(root)
    f = SimpleNamespace(root=root, bench=bench, img_dir=img_dir)
    for cat, sub in (("existence", ""), ("OCR", "questions_answers_YN/"),
                     ("code_reasoning", ""), ("artwork", "")):
        for img in ("a", "b"):
            write(root, f"mme/{cat}/{sub}{img}.txt",
                  f"Is there a {img}? Please answer yes or no.\tYes\n"
                  f"Is there no {img}? Please answer yes or no.\tNo\n\n")
    f.mme = os.path.join(root, "mme")
    base = 1_000_000
    f.mmbench = write(root, "mmbench.tsv", "\n".join([
        "index\tquestion\thint\tA\tB\tC\tD\tanswer\tcategory",
        "7\tWhat shape?\t\tcircle\tsquare\t\t\tA\tattribute",
        f"{7 + base}\tWhat shape?\t\tsquare\tcircle\t\t\tB\tattribute",
        "8\tWhich, of these, is red?\tA hint.\tapple, ripe\tsky\tgrass\tsnow\tA\tcolor",
        f"{8 + base}\tWhich, of these, is red?\tnan\tsky\tapple, ripe\tgrass\tsnow\tB\tcolor",
        "9\tHidden?\t\tyes\tno\t\t\t\tlogic"]))
    f.pope = [write(root, f"coco_pope_{s}.json", "\n".join(json.dumps(
        {"question_id": i, "image": f"{i}.jpg", "text": f"Is there a thing {i}?",
         "label": "yes" if i % 2 else "no"}) for i in range(5)) + "\n")
        for s in ("random", "adversarial")]
    f.pope_plain = write(root, "pope_x.json", json.dumps(
        {"question_id": 1, "image": "a.jpg", "question": "Is it?", "label": "yes"}))
    f.gqa = write(root, "gqa.json", json.dumps({
        "q2": {"question": "What color is the cat?", "answer": "black", "imageId": "i2",
               "fullAnswer": "The cat is black."},
        "q1": {"question": "Is the sky blue?", "answer": "yes", "imageId": "i1"},
        "q3": {"question": "How many?", "answer": "two", "imageId": "i3"}}))
    f.seed = write(root, "SEED-Bench.json", json.dumps({
        "question_type": {"Scene Understanding": 1, "Instance Counting": 2},
        "questions": [
            {"question_id": "s1", "question": "Where is this?", "choice_a": "beach",
             "choice_b": "city", "choice_c": "forest", "choice_d": "desert", "answer": "a",
             "question_type_id": 1, "data_id": "im.png", "data_type": "image"},
            {"question_id": "s2", "question": "How many?", "choice_a": "1", "choice_b": "2",
             "choice_c": "3", "choice_d": None, "answer": "C", "question_type_id": 2,
             "data_id": "im2.png"},
            {"question_id": "s3", "question": "Video?", "choice_a": "x", "choice_b": "y",
             "answer": "A", "question_type_id": 3, "data_id": "v.mp4", "data_type": "video"}]}))
    f.sqa = write(root, "problems.json", json.dumps({
        "11": {"question": "Which is bigger?", "choices": ["sun", "moon"], "answer": 0,
               "hint": "", "image": "y.png", "split": "test"},
        "10": {"question": "Which force?", "choices": ["push", "pull", "none"], "answer": 1,
               "hint": "See the arrow.", "image": "x.png", "split": "test"},
        "12": {"question": "Text only?", "choices": ["a", "b"], "answer": 0, "hint": "",
               "image": None, "split": "test"},
        "13": {"question": "Train row?", "choices": ["a", "b"], "answer": 1, "hint": "",
               "image": "z.png", "split": "train"}}))
    vstar_rows = [{"question_id": i, "image": f"v{i}.jpg",
                   "text": f"What is the color of item {i}?\n(A) red\n(B) blue\nB. ignored\n"
                           "Answer with the option's letter from the given choices directly.",
                   "label": "AB"[i % 2], "category": ("direct_attributes",
                                                      "relative_position")[i % 2]}
                  for i in range(4)]
    f.vstar_jsonl = write(root, "vstar.jsonl", "\n".join(json.dumps(r) for r in vstar_rows))
    f.vstar_list = write(root, "vstar.json", json.dumps(vstar_rows))
    f.vqa_q = write(root, "vqa_q.json", json.dumps({"questions": [
        {"question_id": 1, "image_id": 7, "question": "How many dogs?"},
        {"question_id": 2, "image_id": 8, "question": "What sport?"},
        {"question_id": 3, "image_id": 9, "question": "No annotation?"}]}))
    f.vqa_a = write(root, "vqa_a.json", json.dumps({"annotations": [
        {"question_id": 1, "answers": [{"answer": a} for a in ["2"] * 6 + ["two"] * 2
                                       + ["3"] * 2]},
        {"question_id": 2, "answers": [{"answer": "tennis"}] * 3}]}))
    f.vizwiz = write(root, "vizwiz.json", json.dumps([
        {"image": "v1.jpg", "question": "What is this?", "answers":
         [{"answer": "soda", "answer_confidence": "yes"}] * 10, "answerable": 1},
        {"image": "v2.jpg", "question": "Color?", "answers":
         [{"answer": "unanswerable"}] * 4 + [{"answer": "blue"}] * 6}]))
    f.results = write(root, "res/toy_generate.jsonl", "".join(json.dumps(r) + "\n" for r in [
        {"question_id": 1, "query": "q1", "answer": "B", "response": "The answer is B."},
        {"question_id": 2, "query": "q2", "answer": "cat", "response": "cat"},
        {"question_id": 3, "query": "q3", "answer": [10, 10, 50, 50],
         "response": "[10, 10, 50, 50]"},
        {"question_id": 4, "query": "q4", "answer": "C", "response": None}]))
    return f


RESPONSES = ["Yes", "no", "The answer is B.", "(C)", "A. apple, ripe", "2", "Two dogs.",
             "black", "tennis!", "Soda", "I think it's unanswerable", "", None, "B",
             "circle", "Answer: A", "the color is blue", "sky"]


def with_responses(items, shift=0):
    for i, it in enumerate(items):
        it.response = RESPONSES[(i + shift) % len(RESPONSES)]
    return items


def results_copy(f, out):
    """The results jsonl copied into this package's own output dir."""
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, os.path.basename(f.results))
    with open(f.results) as src, open(path, "w") as dst:
        dst.write(src.read())
    return path


class FakeJudge:
    def score(self, queries, completions, answers):
        return [0.25 * (len(str(c)) % 5) for c in completions]


def case_load_benchmark(P, f, out):
    d = P.data
    return [d.load_benchmark(f.bench, f.img_dir),
            d.load_benchmark(f.bench, f.img_dir, brief=False, use_box=False, num_samples=2),
            d.load_benchmark(f.bench, f.img_dir, image_size=(100, 50)),
            d.norm_bbox([1, 2, 3, 4], 10, 20), d.COT_BRIEF_PROMPT, d.CHOICE_BRIEF_PROMPT]


def case_other_mappers(P, f, out):
    m = P.data.DATASET_MAPPERS
    vrow = {"question_id": 3, "image": "a.jpg", "label": "B",
            "text": "Q?" + P.data.CHOICE_BRIEF_PROMPT}
    rrow = {"id": 5, "image": "r.jpg", "problem": "Find the dog.", "solution": [1, 2],
            "normalized_solution": [100, 200, 300, 900]}
    return [sorted(m.names()), m.get("vstar")(vrow, "imgs"),
            m.get("vstar")(vrow, "imgs", brief=False), m.get("refcoco")(rrow, "imgs"),
            m.get("refcoco")(rrow, "imgs", use_box=False),
            m.get("refcoco")({"id": 6, "image": "s.jpg", "problem": "P"}, "imgs")]


def case_shard_for_host(P, f, out):
    return [[P.data.shard_for_host(list(range(n)), h, k) for h in range(k)]
            for n in (0, 1, 4, 7) for k in (1, 2, 3, 5)]


def case_scorers(P, f, out):
    s = P.scorers
    gts = ["B", "b ", "C", None, "A", "[10, 10, 50, 50]", [10, 10, 50, 50], "5", "[1, 2]", "x"]
    preds = ["The answer is B.", "my choice: b", "(C)", "A", "a) yes", "[10, 10, 50, 50]",
             "box [12, 10, 50, 52]", "[1,2,3,4]", "[0.1, 0.2, 0.3, 0.4]", None]
    qs = [f"q{i}" for i in range(len(gts))]
    return [sorted(s.SCORERS.names()), s.precise_match(qs, gts, preds),
            s.single_choice(qs, [g if isinstance(g, str) or g is None else "A" for g in gts],
                            preds),
            s.one_box_iou05(qs, gts, [p or "" for p in preds]),
            s.dummy_score(qs, gts, preds),
            s.llm_judge(qs, gts, preds, client=FakeJudge())]


def case_bbox_and_iou(P, f, out):
    s = P.scorers
    texts = ["box: [10, 20, 50, 60] end", "[ 10, 20, 50, 60]", "[10 ,20,50,60]",
             "[0.1, 0.2, 0.5, 0.6]", "none", "", None, "[1,2,3,4] and [5,6,7,8]",
             "[99999999999999999999, 1, 2, 3]"]
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 100, (16, 4))
    b = rng.uniform(0, 100, (16, 4))
    return [[s.extract_one_bbox_from_str(t) for t in texts], s.paired_box_iou(a, b),
            [s._gt_box(g) for g in ([1, 2, 3, 4], "[1.5, 2, 3, 4]", "junk", "5", (1, 2), None)]]


def case_score_results(P, f, out):
    path = results_copy(f, out)
    runs = [P.scorers.score_results(path, scorer="precise_match", batch_size=3),
            P.scorers.score_results(path, scorer="dummy_score"),
            P.scorers.score_results(path, scorer="one_box_iou05", overwrite=True,
                                    batch_size=2)]
    for r in runs:
        r["score_path"] = os.path.basename(r["score_path"])
    with open(path.replace(".jsonl", "_score.jsonl")) as fh:
        return [runs, fh.read()]


def case_judge(P, f, out):
    j = P.judge
    texts = ["blah score: 0.75", "no score here", "score: 1.5", "Score: 0.2 and score: 0.3",
             "SCORE: 0.5", "score: -1", "score 0.4", "score: 0.", "score: 0.25\n"]
    return [[j.extract_score(t) for t in texts], j.SYS_PROMPT, j.PROMPT]


def case_vqa_normalization(P, f, out):
    p = P.protocols
    texts = ["The Cat.", "two dogs", "It's a dog!", "dont know", "1,000", "3.5 inches",
             "a/b test", "yes\n", "Ten\tthings", "an apple (red)", "  ", None, "none", "x-ray"]
    gt = [["2"] * 6 + ["two"] * 2 + ["3"] * 2, ["tennis"] * 3, ["yes"] * 10, []]
    return [[p.vqa_normalize(t) for t in texts],
            p.vqav2_accuracy(["2", "Tennis", "no", "x"], gt),
            p.vqav2_accuracy([], [])]


def case_mme(P, f, out):
    p = P.protocols
    items = with_responses(p.load_mme_dir(f.mme))
    return [items, p.score_mme(items), p.MME_PERCEPTION_CATEGORIES, p.MME_COGNITION_CATEGORIES]


def case_mmbench(P, f, out):
    p = P.protocols
    items = with_responses(p.load_mmbench_tsv(f.mmbench), 2)
    letters = [p.extract_choice_letter(r or "", items[3].options) for r in RESPONSES]
    return [items, [p.build_mmbench_prompt(it) for it in items], letters,
            p.score_mmbench(items)]


def case_pope(P, f, out):
    p = P.protocols
    items = with_responses(sum((p.load_pope_jsonl(x) for x in f.pope), []))
    one = with_responses(p.load_pope_jsonl(f.pope_plain, subset="random"))
    return [items, p.score_pope(items), p.score_pope(one), p.load_pope_jsonl(f.pope_plain)]


def case_gqa_seed_sqa(P, f, out):
    p = P.protocols
    gqa = with_responses(p.load_gqa_questions(f.gqa), 6)
    seed = with_responses(p.load_seedbench_json(f.seed), 13)
    seed_all = p.load_seedbench_json(f.seed, image_only=False)
    sqa = with_responses(p.load_scienceqa_problems(f.sqa), 15)
    sqa_all = p.load_scienceqa_problems(f.sqa, split=None, image_only=False)
    return [gqa, p.score_gqa(gqa), seed, seed_all, p.score_seedbench(seed),
            [p.build_seedbench_prompt(it) for it in seed], sqa, sqa_all,
            [p.build_scienceqa_prompt(it) for it in sqa], p.score_scienceqa(sqa)]


def case_vstar_vqa(P, f, out):
    p = P.protocols
    vs = with_responses(p.load_vstar_jsonl(f.vstar_jsonl), 12)
    vqa = with_responses(p.load_vqav2_questions(f.vqa_q, f.vqa_a), 5)
    viz = with_responses(p.load_vizwiz_annotations(f.vizwiz), 9)
    return [vs, p.load_vstar_jsonl(f.vstar_list), p.score_vstar(vs), vqa,
            p.load_vqav2_questions(f.vqa_q), p.score_vqa_open(vqa), viz, p.score_vqa_open(viz)]


def case_shortform_metrics(P, f, out):
    s = P.shortform
    resp = ["The Cat.", "dog", "Yes", "no", "Answer: C", "maybe", None, "(B)"]
    ans = ["cat", "bird", "yes", "yes", "C", "no", "no", "b"]
    scored = {t: s.score_shortform(t, resp, ans) for t in sorted(s.TASK_METRICS)}
    with pytest.raises(KeyError) as err:
        s.score_shortform("nope", [], [])
    return [[s.normalize_vqa_answer(r) for r in resp], s.exact_match_accuracy(resp, ans),
            s.yes_no_metrics(resp, ans), s.multiple_choice_accuracy(resp, ans), scored,
            str(err.value), s.exact_match_accuracy([], [])]


def case_score_task_and_prompts(P, f, out):
    p, s = P.protocols, P.shortform
    sets = {
        "mme": p.load_mme_dir(f.mme), "mmbench_en_test": p.load_mmbench_tsv(f.mmbench),
        "pope": p.load_pope_jsonl(f.pope[0]), "gqa": p.load_gqa_questions(f.gqa),
        "seedbench": p.load_seedbench_json(f.seed),
        "scienceqa_img": p.load_scienceqa_problems(f.sqa),
        "vstar_bench": p.load_vstar_jsonl(f.vstar_jsonl),
        "vqav2_val_lite": p.load_vqav2_questions(f.vqa_q, f.vqa_a),
        "vizwiz_vqa_val": p.load_vizwiz_annotations(f.vizwiz),
    }
    got = {}
    for i, (task, items) in enumerate(sets.items()):
        items = with_responses(items, i)
        got[task] = [[s.build_task_prompt(task, it) for it in items], s.score_task(task, items)]
    got["vqav2_pairs"] = s.score_task("vqav2", [("2", ["2"] * 10), ("no", ["yes"] * 3)])
    for bad in (lambda: s.score_task("nope", []), lambda: s.build_task_prompt("nope", None)):
        with pytest.raises(KeyError) as err:
            bad()
        got.setdefault("errors", []).append(str(err.value))
    return got


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pure_functions_match_jax(case, packages, files):
    want = plain(CASES[case](packages["glimpseprune_tpu"], files,
                             os.path.join(files.root, "out_jax", case)))
    got = plain(CASES[case](packages["glimpseprune_torch"], files,
                            os.path.join(files.root, "out_torch", case)))
    assert got == want


# --------------------------------------------------------------------------- #
# model-driven: run_inference and run_task on shared weights

def fake_tokenize(text):
    return [5 + (ord(c) % 200) for c in text[:12]]


def fake_detokenize(ids):
    return " ".join(str(i) for i in ids)


@pytest.mark.parametrize("task", ["generate", "glimpse"])
def test_run_inference_matches_jax(task, files, tmp_path):
    from glimpseprune_tpu.evalsuite import infer as jax_infer
    from glimpseprune_tpu.evalsuite.data import load_benchmark as jax_load
    from glimpseprune_tpu.models.qwen2_5_vl.runner import GlimpsePruneRunner as JaxRunner
    from test_torch_inputs import make_setup

    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.evalsuite import infer
    from glimpseprune_torch.evalsuite.data import load_benchmark
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    s = make_setup()
    kw = dict(task=task, max_new_tokens=4, batch_size=3, save_masks=True)
    want_path = jax_infer.run_inference(
        JaxRunner(s.cfg, s.params), jax_load(files.bench, files.img_dir)[:3],
        str(tmp_path / "jax"), "toy", jax_infer.InferenceConfig(**kw),
        tokenize=fake_tokenize, detokenize=fake_detokenize)
    got_path = infer.run_inference(
        GlimpsePruneRunner(tiny_test_config(), s.tmodel),
        load_benchmark(files.bench, files.img_dir)[:3], str(tmp_path / "torch"), "toy",
        infer.InferenceConfig(**kw), tokenize=fake_tokenize, detokenize=fake_detokenize)
    assert os.path.basename(got_path) == os.path.basename(want_path)
    with open(want_path) as a, open(got_path) as b:
        want, got = [json.loads(x) for x in a], [json.loads(x) for x in b]
    assert len(got) == 3 and "iou" in got[0] and "keep_mask" in got[0]
    assert got == want
    infos = []
    for path in (want_path, got_path):
        with open(path.replace(".jsonl", "_info.json")) as fh:
            infos.append(json.load(fh))
    for info in infos:
        info.pop("avg_call_time_s")
        stats = info.pop("logger_stats")
        info["timed"] = {k: v["count"] for k, v in stats["time_ms"].items()}
        assert stats["peak_memory_bytes"] == {}
    assert infos[1] == infos[0]
    assert infos[1]["timed"] == {f"GlimpsePruneRunner.{task}": 1}


def test_run_task_gqa_matches_jax(files):
    """gqa through the chat template: the released Qwen special ids
    (<|im_start|> 151644) need the full vocabulary, so the tiny config takes
    the 7B's vocab_size here."""
    import jax.numpy as jnp  # noqa: F401 (the JAX runner's backend)
    from glimpseprune_tpu.config import tiny_test_config as jax_tiny
    from glimpseprune_tpu.evalsuite import protocols as jax_p
    from glimpseprune_tpu.evalsuite.shortform import run_task as jax_run_task
    from glimpseprune_tpu.models.qwen2_5_vl import runner as jax_runner
    from glimpseprune_tpu.models.qwen2_5_vl.gp_model import Qwen2_5_VL_GP
    from test_torch_inputs import make_batch_args, random_params

    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import load_from_jax
    from glimpseprune_torch.evalsuite import protocols
    from glimpseprune_torch.evalsuite.shortform import run_task
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    def wide(cfg):
        return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, vocab_size=152064))

    jcfg, tcfg = wide(jax_tiny()), wide(tiny_test_config())
    prompts, images, kwargs = make_batch_args(jcfg, 3)
    params = random_params(Qwen2_5_VL_GP(jcfg),
                           jax_runner.prepare_inputs(jcfg, prompts, images, **kwargs), 3)
    model = load_from_jax(params, tcfg, device="cpu")

    def tokenize(t):
        return [5 + (ord(c) % 200) for c in t]

    def detokenize(ids):
        return "".join(chr(97 + (i % 26)) for i in ids)

    def load_image(item):
        rng = np.random.default_rng(int(item.question_id[1:]))
        return rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)

    run = dict(max_new_tokens=4, batch_size=3)
    want_items = jax_p.load_gqa_questions(files.gqa)
    want = jax_run_task(jax_runner.GlimpsePruneRunner(jcfg, params), "gqa", want_items,
                        tokenize, detokenize, load_image, **run)
    got_items = protocols.load_gqa_questions(files.gqa)
    got = run_task(GlimpsePruneRunner(tcfg, model), "gqa", got_items, tokenize, detokenize,
                   load_image, **run)
    assert [it.response for it in got_items] == [it.response for it in want_items]
    assert all(it.response for it in got_items)
    assert got == want


# --------------------------------------------------------------------------- #
# the judge client against a local server

class _Judge(http.server.BaseHTTPRequestHandler):
    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        m = re.search(r"model's answer: s(\d+)", body["messages"][1]["content"])
        if m is None:  # a failing judge: the client scores 0.0
            self.send_response(500)
            self.end_headers()
            return
        resp = json.dumps({"choices": [{"message": {
            "content": f"score: {int(m.group(1)) / 100}"}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(resp)))
        self.end_headers()
        self.wfile.write(resp)

    def log_message(self, *a):
        pass


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    request_queue_size = 64  # all concurrent connects queue at once


def test_llm_client_keeps_order(packages):
    with _Server(("127.0.0.1", 0), _Judge) as srv:
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            n = 12
            comps = [f"s{i}" if i % 5 else "broken" for i in range(n)]
            expect = [0.0 if i % 5 == 0 else i / 100 for i in range(n)]
            args = ([f"q{i}" for i in range(n)], comps, ["a"] * n)
            for name, pkg in packages.items():
                for conc in (8, 1):
                    client = pkg.judge.LLMClient(url, concurrency=conc, timeout=10.0)
                    assert client.score(*args) == expect, (name, conc)
            got = packages["glimpseprune_torch"].scorers.llm_judge(
                args[0], args[2], args[1],
                client=packages["glimpseprune_torch"].judge.LLMClient(url))
            assert got == expect
        finally:
            srv.shutdown()
