"""The benchmark's fixed arithmetic: percentiles and rates, the spread
that bounds are set from, the card's published peaks and the FAST
kernel's byte and operation counts, and the host-sync count.

The peaks, `bound`, the FAST operation counts and `count_syncs` are
frozen copies of chip_smoke.py at commit d6d14bc (`PEAK_BYTES_S`,
`PEAK_F32_OPS_S`, `OPS_COMPASS`, `OPS_FULL`, `bound`, `count_syncs`,
and the byte count of `check_cell_kernel`), so that a change to the
program cannot change what a roofline share is measured against.
"""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence, Tuple

# The card's published peaks (H100 SXM data sheet): memory rate, and
# float32 rate outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# float32 operations FAST needs: every pixel, the 4-pixel compass test at
# the low threshold (2 + 4 x 2 compares + 2 to combine); every pixel whose
# score comes out non-zero, per threshold, the full test (2 + 16 x 8 + 3)
# and 10 for the 3x3 NMS.
OPS_COMPASS = 2 + 4 * 2 + 2
OPS_FULL = 2 + 16 * 8 + 3 + 10


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: int, seconds: float) -> float:
    """Work completed per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles as a share of the
    median (`statistics.quantiles(values, n=4)`, its default method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def pyramid_shapes(height: int, width: int, n_levels: int,
                   scale_factor: float) -> List[Tuple[int, int]]:
    """(H, W) of each level of an ORB pyramid."""
    return [(int(round(height / scale_factor**l)), int(round(width / scale_factor**l)))
            for l in range(n_levels)]


def fast_cells_bytes(shapes: Iterable[Tuple[int, int]], cell: int) -> Tuple[int, int]:
    """(bytes, pixels) one launch of the fused FAST kernel needs for one
    frame's pyramid: each float32 pixel read once, and per cell its best
    score, y and x (4 bytes each) written once."""
    n_pixels = n_cells = 0
    for h, w in shapes:
        n_pixels += h * w
        n_cells += -(-h // cell) * -(-w // cell)
    return 4 * n_pixels + 12 * n_cells, n_pixels


def bound(n_bytes: float, n_pixels: int, n_scored: int):
    """(least ms the card could take, what sets it): the larger of the
    bytes (each input read once, each output written once) over the memory
    rate and the operations (compass test on `n_pixels`, full test on the
    `n_scored` non-zero scores of this run) over the float32 rate."""
    n_ops = OPS_COMPASS * n_pixels + OPS_FULL * n_scored
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def count_syncs(caught) -> int:
    """Host syncs among the warnings of torch's sync debug mode ("warn")."""
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)
