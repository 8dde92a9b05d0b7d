"""Kernels of the port: hand-written CUDA for sm_90a (``csrc/``), their
plain PyTorch versions (:mod:`.ref`) and the wrappers that choose between
them by device (:mod:`.ops`)."""
