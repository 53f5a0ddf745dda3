"""Hand-written CUDA kernels of the port: build and load (`build.py`)."""
