"""FedKT's one-shot federated round in PyTorch, for an NVIDIA H100.

This package mirrors ``repro`` (the JAX reference) module for module,
with the same public names, so each counterpart can be read side by
side.  It imports ``torch`` and ``numpy`` only.  The two kernels of the
round (``kernels/vote_aggregate.py`` and ``kernels/tree_hist.py``) are
hand-written CUDA C++ for ``sm_90a`` (``csrc/``), built with ``nvcc``
at first use and bound with ``ctypes``.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); asking for CUDA where there is none raises
(``device.resolve``).  On a CPU tensor every kernel wrapper runs its
plain PyTorch version instead.
"""
