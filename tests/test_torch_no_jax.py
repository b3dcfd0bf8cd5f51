"""The card's machine has no jax: every glimpseprune_torch module imports
without loading jax (or flax), in a fresh interpreter; and chip_smoke.py
refuses to report a result where there is no card."""

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
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print(json.dumps({"modules": names, "jax": loaded}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "glimpseprune_torch.models.qwen2_5_vl.runner" in out["modules"]
    assert "glimpseprune_torch.ops.cuda.flash_attention" in out["modules"]
    assert out["jax"] == []


def test_chip_smoke_refuses_without_card():
    """Without a CUDA card chip_smoke.py exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
