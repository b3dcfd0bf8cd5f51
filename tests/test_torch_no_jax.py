"""The card's machine has no jax: every glimpseprune_torch module imports
without loading the JAX package or jax, jaxlib, flax or optax, in a fresh
interpreter; chip_smoke.py imports none of them either; and chip_smoke.py
refuses to report a result where there is no card."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = """
import importlib, json, pkgutil, sys
import glimpseprune_torch
names = ["glimpseprune_torch"] + [
    m.name for m in pkgutil.walk_packages(glimpseprune_torch.__path__, "glimpseprune_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("glimpseprune_tpu", "jax", "jaxlib", "flax", "optax"))
print(json.dumps({"modules": names, "jax": loaded}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "glimpseprune_torch.models.qwen2_5_vl.runner" in out["modules"]
    assert "glimpseprune_torch.models.qwen2_5_vl.decode_graph" in out["modules"]
    assert "glimpseprune_torch.serving" in out["modules"]
    assert "glimpseprune_torch.ops.cuda.flash_attention" in out["modules"]
    assert "glimpseprune_torch.training.trainer" in out["modules"]
    assert "glimpseprune_torch.persistence" in out["modules"]
    assert "glimpseprune_torch.quantization" in out["modules"]
    assert "glimpseprune_torch.ops.cuda.int4_matmul" in out["modules"]
    for name in ("compressors", "compressors.visionzip", "compressors.divprune",
                 "compressors.cdpruner", "compressors.vscan", "compressors.staged",
                 "ops.cuda.window_attention", "parallel", "parallel.sequence",
                 "parallel.launch", "preprocessing.chat", "training.lora", "training.grpo",
                 "models.llava.clip", "models.llava.gp_model", "models.llava.runner",
                 "models.llava.convert", "models.qwen2_5_vl.convert"):
        assert f"glimpseprune_torch.{name}" in out["modules"]
    assert out["jax"] == []


def test_chip_smoke_imports_no_jax_package():
    """Every import statement in chip_smoke.py, at any depth, names neither
    the JAX package nor jax, jaxlib, flax or optax."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "glimpseprune_torch.config" in names
    banned = ("glimpseprune_tpu", "jax", "jaxlib", "flax", "optax")
    assert [n for n in names if n.split(".")[0] in banned] == []


def test_chip_smoke_refuses_without_card():
    """Without a CUDA card chip_smoke.py exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
