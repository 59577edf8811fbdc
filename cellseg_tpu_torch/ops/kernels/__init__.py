"""Hand-written CUDA kernels of the port, each beside its plain version.

| module    | kernel                                         | replaces                        |
|-----------|------------------------------------------------|---------------------------------|
| scans.py  | row_segmented_min_scan, col_segmented_min_scan | ops/pallas/scans.py (B1, B2)    |
| sweeps.py | fused_sweeps                                   | ops/pallas/sweeps.py (B3)       |
"""

from __future__ import annotations

from . import scans, sweeps

_COUNTERS = (scans.LAUNCHES, sweeps.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    out: dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for name in c:
            c[name] = 0
