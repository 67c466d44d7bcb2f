"""DEFER on PyTorch and CUDA: the port of the ``repro`` package.

Same layout and public names as the JAX package (``core/``, ``models/``,
``kernels/``, ``runtime/``); the compute runs on a ``torch.device`` chosen
by :mod:`repro_torch.device` (CUDA unless the caller asks for the CPU).
"""
