"""Synthetic worlds, TUM I/O, evaluation, checkpoints, profiling, plots."""
