"""The card's and the link's peaks, and the least time a piece of work needs.

Published rates only, so that a share moves with the program and not with
the machine it ran on:

* HBM: 3.35 TB/s, NVIDIA's H100 SXM data sheet.
* int32 operations: the SMs x 64 int32 lanes an SM x the card's max SM
  clock. Derived, not published: the per-tap truncation keeps the taps off
  the tensor cores, so the CUDA cores' integer rate is the one that binds.
* The host-card link: PCIe at the generation and width nvidia-smi reports,
  GT/s x lanes / 8 bytes a second in each direction (Gen5 x16: 64 GB/s),
  before the line code's overhead, so a share stays under 100%.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
# Integer instructions of one tap for one lane: multiply, sign shift, bias
# multiply-add, shift-add (the per-tap truncation of x * K / 2^16).
OPS_PER_TAP = 4
PCIE_GT_PER_S = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0, 6: 64.0}
# The host interface a card's data sheet gives (generation, lanes), for a
# machine whose nvidia-smi reports no link: the H100 SXM5's PCIe Gen5 x16.
PUBLISHED_LINKS = {"NVIDIA H100 80GB HBM3": (5, 16)}
SMI_FIELDS = ("name", "power.limit", "clocks.max.sm", "pcie.link.gen.current",
              "pcie.link.width.current", "pcie.link.gen.max", "pcie.link.width.max")


def read_smi() -> dict:
    """What nvidia-smi says of card 0 (SMI_FIELDS), or {} without it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", f"--query-gpu={','.join(SMI_FIELDS)}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    values = [v.strip() for v in out.strip().splitlines()[0].split(",")]
    return dict(zip(SMI_FIELDS, values)) if len(values) == len(SMI_FIELDS) else {}


def _number(smi: dict, key: str):
    try:
        return float(smi[key])
    except (KeyError, ValueError):
        return None


def card_peaks(smi: dict, sms: int) -> dict:
    """The rates the bounds divide by. The link rate is taken from the
    link's generation and width at their ``max`` (an idle link may report a
    lower ``current`` generation while it saves power), or from the card's
    data sheet where nvidia-smi reports none."""
    mhz = _number(smi, "clocks.max.sm")
    gen, width = _number(smi, "pcie.link.gen.max"), _number(smi, "pcie.link.width.max")
    if (gen is None or width is None) and smi.get("name") in PUBLISHED_LINKS:
        gen, width = PUBLISHED_LINKS[smi["name"]]
    link = None
    if gen is not None and width is not None and int(gen) in PCIE_GT_PER_S:
        link = PCIE_GT_PER_S[int(gen)] * 1e9 * width / 8
    return dict(hbm_bytes_per_s=HBM_BYTES_PER_S,
                int32_ops_per_s=None if mhz is None else sms * INT32_LANES_PER_SM * mhz * 1e6,
                link_bytes_per_s=link, power_limit_w=_number(smi, "power.limit"))


def device_bound_s(work: dict, peaks: dict):
    """The least device time of ``work`` (bytes_in int16 read once, bytes_out
    int32 written once, live tap-lanes): the larger of its bytes over HBM and
    its operations over the int32 rate; None without the rates."""
    if peaks.get("int32_ops_per_s") is None:
        return None
    return max((work["bytes_in"] + work["bytes_out"]) / peaks["hbm_bytes_per_s"],
               OPS_PER_TAP * work["tap_lanes"] / peaks["int32_ops_per_s"])


def link_bound_s(work: dict, peaks: dict):
    """The least link time of ``work``: the larger of its upload and its
    download, each at the link's rate in one direction."""
    if peaks.get("link_bytes_per_s") is None or not work.get("over_link"):
        return None
    return max(work["bytes_in"], work["bytes_out"]) / peaks["link_bytes_per_s"]
