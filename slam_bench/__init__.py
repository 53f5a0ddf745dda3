"""The benchmark of lc_crf_slam_torch (see run.py)."""
