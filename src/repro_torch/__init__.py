"""FedHC on PyTorch and CUDA: the port of the ``repro`` JAX package to one
NVIDIA H100.

Sub-packages mirror ``repro``'s (``core``, ``data``, ``fed``, ``kernels``,
``models``, ``obs``, ``optim``) so each module's counterpart is found by
name.  The port imports ``torch`` and numpy, never ``jax`` or ``repro``;
entry points run on the CUDA card unless given ``device="cpu"``.
"""
