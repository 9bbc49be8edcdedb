"""Plain PyTorch ops (``basic``, ``wkv``) and the CUDA kernels (``cuda``)."""
