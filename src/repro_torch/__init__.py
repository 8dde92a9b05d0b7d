"""PyTorch/CUDA port of the MOO-STAGE 3D NoC design optimizer.

A package of its own beside the JAX reference ``repro``: it imports
``torch`` and ``numpy`` and nothing of ``repro`` or ``jax``. Entry points
run on ``device="cuda"`` unless the caller asks for ``"cpu"``; the four NoC
kernels (``csrc/*.cu``) are hand-written CUDA for ``sm_90a`` and built at
first use."""
