"""Hand-written CUDA kernels for Hopper (``csrc/``), their ``ctypes``
wrappers, the plain PyTorch versions, and the public ops."""
