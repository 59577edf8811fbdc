"""Hand-written CUDA kernels of the port, each beside its plain version.

| module       | kernel                                         | replaces                        |
|--------------|------------------------------------------------|---------------------------------|
| scans.py     | row_segmented_min_scan, col_segmented_min_scan | ops/pallas/scans.py (B1, B2)    |
| sweeps.py    | fused_sweeps                                   | ops/pallas/sweeps.py (B3)       |
| local_cc.py  | stripe_converge                                | ops/pallas/local_cc.py (B4)     |
| ws_local.py  | stripe_ws_converge                             | ops/pallas/ws_local.py (B5)     |
| ws_sweeps.py | fused_ws_sweeps                                | ops/pallas/ws_sweeps.py (B6)    |
"""

from __future__ import annotations

from . import local_cc, scans, sweeps, ws_local, ws_sweeps

_COUNTERS = (scans.LAUNCHES, sweeps.LAUNCHES, local_cc.LAUNCHES,
             ws_local.LAUNCHES, ws_sweeps.LAUNCHES)


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
