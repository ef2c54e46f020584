"""No run loads JAX or the JAX package; no module of benchmark/reference/
loads anything of the program, nor does running each configuration's
reference through its hooks. Each check runs in a fresh interpreter, so
that what this test process imported counts for nothing."""

import json
import subprocess
import sys

from benchmark.harness import ROOT

REHEARSAL = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from benchmark import harness
for config in ("scale2x", "noise2_scale2x"):
    wl = {"name": "tiny", "config": config, "chips": 1, "depth": 2,
          "env": {}, "limits": {"row_psnr_min_db": 0.0,
                                "noise_y_maxabs": 1.0},
          "groups": [{"h": 16, "w": 16, "per_dispatch": 1, "frames": 2,
                      "check_per_group": 1}]}
    harness.run_cell(wl, 5, 0.01, True, "cpu", time.perf_counter(),
                     log=lambda line: None)
import benchmark.readings, benchmark.run
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = r"""
import importlib, json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path.insert(0, str(root))
import torch
from benchmark.reference import vgg7
layers = vgg7.load_model(sys.argv[1] + "/models/scale2.0x_demo.json")
vgg7.convert(torch.zeros((1, 8, 8, 3), dtype=torch.uint8), layers, layers)
for path in sorted((root / "benchmark" / "reference").glob("*.py")):
    importlib.import_module("benchmark.reference." + path.stem)
for path in sorted((root / "benchmark" / "configs").glob("*.json")):
    cfg = json.loads(path.read_text())
    ref = importlib.import_module(cfg["reference"][:-3].replace("/", "."))
    weights = {s["role"]: ref.weights(s, root) for s in cfg["stacks"]}
    ref.convert_by_role(torch.zeros((1, 8, 8, 3), dtype=torch.uint8),
                        weights)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level_names(script):
    p = subprocess.run([sys.executable, "-c", script, str(ROOT)],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = top_level_names(REHEARSAL)
    assert "waifu2x_torch" in names and "benchmark" in names
    assert not names & {"jax", "jaxlib", "flax", "waifu2x_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = top_level_names(REFERENCE)
    assert "benchmark" in names
    assert not names & {"waifu2x_torch", "waifu2x_tpu", "jax", "jaxlib",
                        "flax"}
