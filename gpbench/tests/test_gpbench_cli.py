"""The command fails, and prints no result, without a card."""

import os
import subprocess
import sys

from gpbench import harness


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "gpbench.run", "--workload",
                        "qwen2_5_vl_7b.q8.hires_vqa", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=harness.ROOT.parent, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr
