"""The batched chunk call of one tree of the repo, timed on one CUDA card.

    python3 chip_scripts/batch_ab.py TREE LABEL

Imports chip_smoke and the port from TREE (this checkout, or a `git archive`
of another commit unpacked inside it), builds the kernels there, and times
by CUDA events (chip_smoke.cuda_ms, 20 calls after 20 untimed) the whole
entry at config 5's fleet (resample_batch at chip_smoke.FLEET), at
chip_smoke.BATCH and at the oracle-scan step (the BATCH_CASES 2-D call at C =
2048, as resample_streams), and the tree's batch_mac_kernel alone at the
same three (its C entry back to back, no host work between launches); each
output is checked against the plain version once. Prints one JSON line with
LABEL and the card. compare.sh runs
it parent, change, change, parent, each a fresh process.
"""
import json
import os
import subprocess
import sys

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from clownresampler_tpu_torch.batch import resample_batch, resample_batch_reference  # noqa: E402
from clownresampler_tpu_torch.batch import stack_states  # noqa: E402
from clownresampler_tpu_torch.lowlevel import resample_chunk_reference  # noqa: E402
from clownresampler_tpu_torch.ops import _build  # noqa: E402
from clownresampler_tpu_torch.ops import resample as rs  # noqa: E402

STEP = "2-D C=2048 44.1k->8k (an oracle-scan step)"


def i32(v):
    return torch.tensor([v], dtype=torch.int32, device="cuda")


def kernel_ms(table, x, totals, states, quotas, *, max_taps: int, n_out: int) -> float:
    """The tree's batch_mac_kernel alone: its C entry called back to back
    with checked arguments into one set of outputs (chip_smoke._entry_ms)."""
    args = _build.batch_launch_args(x, table, totals, quotas, states.position_integer,
                                    states.position_fractional, states.cfg, max_taps=max_taps,
                                    n_out=n_out)
    b, _, c = x.shape
    outs = [torch.empty((b, n_out, c), dtype=torch.int32, device=x.device),
            *torch.empty((4, b), dtype=torch.int32, device=x.device),
            torch.empty(b, dtype=torch.bool, device=x.device)]
    args.update(zip(("out", "produced", "consumed", "p_out", "f_out", "exhausted"),
                    (t.data_ptr() for t in outs)))
    return cs._entry_ms("crt_batch_mac", args)


def main() -> int:
    assert os.path.dirname(os.path.abspath(cs.__file__)) == tree, cs.__file__
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    fleet = cs.batch_case(np.random.default_rng(cs.SEED), cs.FLEET)
    small = cs.batch_case(np.random.default_rng(cs.SEED), cs.BATCH)
    step = cs.batch_case_inputs(dict(cs.BATCH_CASES)[STEP], gen)
    calls = dict(
        fleet=(lambda: resample_batch(*fleet["args"], **fleet["kw"]),
               lambda: resample_batch_reference(*fleet["args"], **fleet["kw"])),
        batch=(lambda: resample_batch(*small["args"], **small["kw"]),
               lambda: resample_batch_reference(*small["args"], **small["kw"])),
        oracle_scan_step=(lambda: rs.resample_streams(*step[:5], **step[5]),
                          lambda: resample_chunk_reference(*step[:5], **step[5])))
    step_case = (step[0], step[1][None], i32(step[2]), stack_states([step[3]]), i32(step[4]))
    kernel_args = dict(fleet=fleet["args"], batch=small["args"], oracle_scan_step=step_case)
    res, kernel = {}, {}
    for name, (call, plain) in calls.items():
        if not torch.equal(call()[0], plain()[0]):
            raise AssertionError(f"{name}: the entry != its plain version")
        res[name] = cs.cuda_ms(lambda: call()[0])
        kernel[name] = kernel_ms(*kernel_args[name], **(step[5] if name == "oracle_scan_step"
                                                         else fleet["kw"] if name == "fleet"
                                                         else small["kw"]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(tree=sys.argv[2], nvidia_smi=smi, entry_ms=res, kernel_ms=kernel)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
