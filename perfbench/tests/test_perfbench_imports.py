"""What the harness loads: never JAX or the JAX package (top-level names
compared whole), never the repo's older benchmark scripts; and a run without
a card, or without the port beside the harness, exits non-zero with no
result."""

import json
import os
import shutil
import subprocess
import sys

from perfbench import harness

ROOT = harness.ROOT
PROBE = """
import json, sys, time
sys.path.insert(0, {root!r})
from perfbench import harness
from perfbench.tests.conftest import CELLS, run_small
for cell in CELLS:
    run_small(cell, seconds=0.2)
    run_small(cell, seconds=0.2, trace=True)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""
OLD_BENCHMARKS = ("bench", "chip_smoke", "benchmarks", "chip_scripts", "tools")


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "clownresampler_tpu_torch.farm", None)
    monkeypatch.setitem(sys.modules, "jaxlib_lookalike", None)
    assert "clownresampler_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "clownresampler_tpu.ops", None)
    assert "clownresampler_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_jax_and_no_old_benchmark():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & set(harness.FORBIDDEN_MODULES)
    assert not loaded & set(OLD_BENCHMARKS)
    assert "clownresampler_tpu_torch" in loaded


def _run_py(cwd: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "fleet_mixed4.stream", "--seed", "5",
         "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_exits_non_zero_with_no_result():
    out = _run_py(ROOT)
    assert out.returncode != 0 and '"correct"' not in out.stdout


def test_harness_alone_exits_non_zero(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(str(tmp_path))
    assert out.returncode != 0 and '"correct"' not in out.stdout
    probe = subprocess.run([sys.executable, "-c", ALONE.format(root=str(tmp_path))],
                           cwd=str(tmp_path), capture_output=True, text=True, timeout=120)
    assert probe.returncode == 0 and probe.stdout.strip() in ("missing", "refused"), probe.stderr


ALONE = """
import sys
sys.path.insert(0, {root!r})
from perfbench import harness
try:
    import clownresampler_tpu_torch
except ImportError:
    print("missing")
else:
    try:
        harness.check_port_location({root!r})
    except harness.SetupError:
        print("refused")
"""


def test_sources_name_no_old_benchmark():
    for folder, _, files in os.walk(os.path.join(ROOT, "perfbench")):
        for name in files:
            if name.endswith(".py") and "tests" not in folder:
                text = open(os.path.join(folder, name)).read()
                for old in ("import jax", "from jax", "clownresampler_tpu.", "chip_smoke",
                            "chip_scripts", "from benchmarks", "import bench"):
                    assert old not in text, (name, old)
