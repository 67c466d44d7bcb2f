"""The port's hand-written CUDA kernels, their wrappers and plain
versions.  None of the kernels has a backward pass: a wrapper given CUDA
tensors under autograd refuses them (:func:`refuse_grad`) rather than
return an output that would silently drop its inputs' gradients."""
from __future__ import annotations

import torch


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise if grad is enabled and any of ``tensors`` requires grad: the
    CUDA kernel behind ``what`` has no backward, and its plain version is
    reached only through CPU tensors (there is no fallback)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward pass; call it under "
            "torch.no_grad() / inference_mode, or take the plain path "
            "(use_kernel=False) where gradients are needed")
