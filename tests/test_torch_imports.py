"""Import hygiene of the port: no JAX, and no library kernels on the kernel path."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "clownresampler_tpu_torch"
MODULES = [
    "clownresampler_tpu_torch",
    "clownresampler_tpu_torch.fixedpoint",
    "clownresampler_tpu_torch.configure",
    "clownresampler_tpu_torch.models",
    "clownresampler_tpu_torch.ops.convolve",
    "clownresampler_tpu_torch.ops.resample",
    "clownresampler_tpu_torch.ops._build",
    "clownresampler_tpu_torch.lowlevel",
    "clownresampler_tpu_torch.highlevel",
    "clownresampler_tpu_torch.farm",
    "clownresampler_tpu_torch.interop",
    "clownresampler_tpu_torch.utils.native",
    "clownresampler_tpu_torch.utils.audio_io",
]


def test_torch_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'clownresampler_tpu' or m.startswith('clownresampler_tpu.'))\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_torch_kernel_path_calls_no_library_kernels():
    """The port's kernel path is its own CUDA source: no torch.compile, no
    convolution, window-view or matrix-product library calls."""
    banned = re.compile(r"torch\.compile|conv1d|\bunfold\b|matmul|cublas|cudnn", re.IGNORECASE)
    sources = sorted(PACKAGE.rglob("*.py")) + sorted(PACKAGE.rglob("*.cu"))
    assert any(p.suffix == ".cu" for p in sources)
    hits = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
            for p in sources
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if banned.search(line)]
    assert not hits, hits
