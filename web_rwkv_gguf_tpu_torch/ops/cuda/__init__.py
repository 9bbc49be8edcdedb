"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), built by
``build.py`` at first use and bound with ctypes, each beside its plain
PyTorch version and with a launch counter on its wrapper."""
