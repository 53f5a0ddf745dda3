"""lc_crf_slam_torch — the dynamic SLAM pipeline (RGB-D, stereo, monocular) in
PyTorch, for NVIDIA Hopper.

A port of `lc_crf_slam_tpu` (the JAX reference, which stays beside it and
which the port's tests hold it to). It imports torch and numpy only:
nothing of jax and nothing of the JAX package (`config.py` is a copy of
the reference's dataclasses).

Layout mirrors the reference:
  geometry/  SE3 Lie ops, pinhole camera, Umeyama alignment
  ops/       pyramid, FAST (+ CUDA kernel), keypoint selection, ORB, matching,
             stereo row matching
  models/    frame front-end, map state, motion-only BA, tracking, mapping,
             CRF, loop closing (SE3 and Sim3), two-view initialisation,
             SLAMSystem
  utils/     synthetic RGB-D worlds, TUM sequences and trajectories (PNG on
             numpy + zlib, the native prefetching loader), ATE/RPE,
             checkpoints, the stage timer and profiler trace, map plots
  run_slam   the command line (`python -m lc_crf_slam_torch.run_slam`)
  csrc/      CUDA C++ kernel sources; kernels/ builds and loads them
"""
