"""fast_cell_best.roofline: the least time one launch of the fused FAST
kernel could take on one frame's pyramid (bytes over the memory rate, or
the compass test's operations over the float32 rate, the larger) over
the kernel's mean device time in the profiled slice, in %."""

from slam_bench.yardstick import bound, fast_cells_bytes, pyramid_shapes

KERNEL = "fast_cell_best_kernel"


def read(run):
    if run.trace is None:
        return None
    launches = [v for name, v in run.trace["kernels"].items() if KERNEL in name]
    count = sum(c for c, _ in launches)
    seconds = sum(s for _, s in launches)
    if not count or seconds <= 0:
        return None
    s = run.shape
    n_bytes, n_pixels = fast_cells_bytes(
        pyramid_shapes(s["height"], s["width"], s["n_levels"], s["scale_factor"]), s["cell"])
    # the operations of the compass test alone: the full test's depend on
    # the frame and only raise the bound
    bound_ms, _ = bound(n_bytes, n_pixels, 0)
    return 100.0 * bound_ms / (seconds * 1e3 / count)
