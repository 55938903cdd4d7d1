"""The kernels: hand-written CUDA (``csrc/``) behind ``ops``, with their
plain PyTorch versions in ``ref``."""
