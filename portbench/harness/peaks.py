"""The card's peaks that the roofline shares and MFUs divide by, each with
its source.

* TF32: 494.7 TFLOP/s, NVIDIA H100 SXM data sheet, dense tensor-core rate
  without sparsity.  It is the card's fastest rate on float32 operands, so
  no float32 implementation can read above 100% of it.
* HBM: 3.35 TB/s, the same data sheet.
"""

from __future__ import annotations

import subprocess

PEAK_TF32 = 494.7e12
PEAK_BYTES = 3.35e12


def nvidia_smi(fields):
    """``nvidia-smi``'s values of ``fields`` for card 0 as strings, or None
    where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    vals = [v.strip() for v in out.strip().splitlines()[0].split(",")]
    return vals if len(vals) == len(fields) else None


def card_peaks(torch):
    """The peaks of card 0 and its power limit."""
    smi = nvidia_smi(["power.limit"])
    return {
        "tf32_flops": PEAK_TF32,
        "bytes": PEAK_BYTES,
        "power_limit_w": float(smi[0]) if smi else None,
    }
