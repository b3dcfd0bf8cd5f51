"""No module of the benchmark loads JAX or the JAX package, and the
reference loads nothing of the program: top-level module names compared
whole, in a fresh interpreter."""

import json
import subprocess
import sys

import pytest

from gpbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "glimpseprune_tpu"}
MODULES = ["gpbench.run", "gpbench.harness", "gpbench.calibrate", "gpbench.faults", "gpbench.weights",
           "gpbench.traffic", "gpbench.flops", "gpbench.trace", "gpbench.stats",
           "gpbench.reference.model", "gpbench.reference.judge"]


def _loaded(code: str):
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                       cwd=harness.ROOT.parent, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_benchmark_loads_no_jax():
    # the program's modules a run reaches, and every metric reader
    code = "\n".join(f"import {m}" for m in MODULES) + """
import glimpseprune_torch.serving, glimpseprune_torch.convert
import glimpseprune_torch.models.qwen2_5_vl.runner, glimpseprune_torch.models.qwen2_5_vl.inputs
import glimpseprune_torch.models.qwen2_5_vl.convert, glimpseprune_torch.quantization
from gpbench import harness
harness.readers()"""
    loaded = _loaded(code)
    assert not loaded & FORBIDDEN
    assert "glimpseprune_torch" in loaded


@pytest.mark.parametrize("module", ["gpbench.reference.model", "gpbench.reference.judge"])
def test_the_reference_loads_nothing_of_the_program(module):
    loaded = _loaded(f"import {module}")
    assert not loaded & (FORBIDDEN | {"glimpseprune_torch"})
