"""The table of peaks: one NVIDIA H100 SXM.

The int32 rate is 64 INT32 lanes per SM times the SMs times the SM's
maximum clock as ``nvidia-smi`` reads it; the memory's rate is the data
sheet's 3.35 TB/s of HBM3. Both hold at the card's full power limit of
700 W; ``power_limit_w`` is read beside them.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass
from typing import Optional

INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12


@dataclass
class Peaks:
    int32_ops_per_s: float
    hbm_bytes_per_s: float
    sm_count: int
    max_sm_mhz: float
    power_limit_w: Optional[float]


def _smi(field: str) -> Optional[float]:
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={field}",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=60,
                           check=True)
        return float(r.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def read(device) -> Peaks:
    """The peaks of the card ``device`` (index 0 of the machine)."""
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = _smi("clocks.max.sm")
    if mhz is None:
        raise RuntimeError("nvidia-smi gave no maximum SM clock")
    return Peaks(INT32_LANES_PER_SM * sms * mhz * 1e6, HBM_BYTES_PER_S,
                 sms, mhz, _smi("power.limit"))


def power_limit_w() -> Optional[float]:
    return _smi("power.limit")
