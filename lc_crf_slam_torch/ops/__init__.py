"""Per-frame compute: pyramid, FAST (+ its CUDA kernel), selection, ORB, matching."""
