"""Shared helpers of the benchmark's CPU tests: cells shrunk to a size the
CPU runs in well under a second (the port's plain versions stand in for its
kernels there)."""

import os
import time

import pytest

from perfbench import harness

BENCHMARKED = tuple(w["name"] for w in harness.load_json(
    os.path.join(harness.ROOT, "BENCHMARK.json"))["workloads"])
# The farm entry's one-ratio path (UniformStreamFarm), which the queued cell
# fleet_48k_44k1.stream drives (PERF.md, Open questions): its runs here take
# the mixed fleet's cell with the one-ratio configuration, so that the cell
# can come back as a manifest entry alone.
UNIFORM = "fleet_48k_44k1.stream"
CELLS = BENCHMARKED + (UNIFORM,)


def shrink(spec: dict) -> None:
    """A few streams a group, 200-frame chunks, a moved stream that
    exists, three 256-frame chunks a file."""
    config, traffic = spec["config"], spec["traffic"]
    for group in config["groups"]:
        group["streams"] = max(2, group["streams"] // 128)
    for move in config.get("moves", ()):
        move["stream"] = 1
    config["chunk_frames"] = 200
    traffic["warmup_calls"] = min(traffic["warmup_calls"], 3)
    if "chunks_per_file" in traffic:
        traffic.update(chunks_per_file=3, chunk_frames=256, sampled_lanes=4, kept_window=2)


def uniform(spec: dict) -> None:
    spec["config"] = harness.load_json(os.path.join(harness.ROOT, "perfbench", "configs",
                                                    "fleet_48k_44k1.json"))
    shrink(spec)


def run_small(workload: str, seed: int = 2**31 + 11, seconds: float = 0.3, trace=False,
              **hooks) -> dict:
    """One run of ``workload`` on the CPU at the shrunk size."""
    adjust = shrink
    if workload == UNIFORM:
        workload, adjust = "fleet_mixed4.stream", uniform
    return harness.run(workload, seed, seconds, trace, started=time.perf_counter(),
                       device="cpu", adjust=adjust, log=lambda line: None, **hooks)


@pytest.fixture
def cuda_card():
    """Skip where there is no CUDA card (decided inside the test)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
