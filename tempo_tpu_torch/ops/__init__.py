"""Packed-array operations of the port: the three CUDA kernel wrappers
(``merge``, ``window``, ``scan``), each beside its plain PyTorch
version, and the dispatchers above them."""
