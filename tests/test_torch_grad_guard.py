"""The CUDA kernels have no backward pass, so their wrappers refuse
tensors off the CPU under autograd when an input requires grad: a
RuntimeError before any launch, never an output without a ``grad_fn``
and never the plain version in the kernel's place.  Shown here with meta
tensors (not the CPU, so the wrapper is past its plain branch; no card
needed); a ``cuda`` test drives ``forward(use_kernel=True)`` under grad
on the card.  The CPU path is unchanged and differentiable."""
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.kernels import block_quant as bq
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import transformer as TT

torch.set_num_threads(1)


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def _ssd_args(grad: bool):
    B, nc, Q, H, P, N = 1, 2, 16, 2, 16, 8
    return (_meta(B, nc, Q, H, P, grad=grad), _meta(B, nc, Q, H),
            _meta(H), _meta(B, nc, Q, N), _meta(B, nc, Q, N),
            _meta(B, H, P, N))


def _da_args(grad: bool):
    return (_meta(1, 1, 4, 64, grad=grad), _meta(1, 32, 2, 64),
            _meta(1, 32, 2, 64), _meta(1, 32, dtype=torch.int32),
            _meta(1, dtype=torch.int32), None, 0.125)


CALLS = {
    "ssd_scan": lambda g: ssd.ssd_scan(*_ssd_args(g)),
    "decode_attention": lambda g: da.decode_attention(*_da_args(g)),
    "quantize_blocks": lambda g: bq.quantize_blocks(_meta(8, 128, grad=g)),
    "quantize_ragged": lambda g: bq.quantize_ragged(_meta(1000, grad=g), 1),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_kernel_wrappers_refuse_grad_off_the_cpu(name):
    with pytest.raises(RuntimeError, match="no backward"):
        CALLS[name](True)
    # without grad the same tensors pass the refusal and fail on the
    # device check instead (meta is not cuda)
    with torch.no_grad(), pytest.raises(ValueError):
        CALLS[name](True)
    with pytest.raises(ValueError):
        CALLS[name](False)


def test_cpu_kernel_paths_keep_their_gradients():
    cfg = treg.get_smoke("mamba2-2.7b")
    p = TT.init_lm(cfg, 0, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    for leaf in (p["units"]["pos0"]["mamba"]["in_proj"],):
        leaf.requires_grad_(True)
    logits, _ = TT.forward(p, cfg, toks, use_kernel=True)
    assert logits.grad_fn is not None
    logits.sum().backward()
    assert p["units"]["pos0"]["mamba"]["in_proj"].grad is not None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_forward_under_grad_raises(cuda_device):
    cfg = treg.get_smoke("mamba2-2.7b")
    p = TT.init_lm(cfg, 0, device=cuda_device)
    p["units"]["pos0"]["mamba"]["in_proj"].requires_grad_(True)
    toks = torch.zeros((1, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        TT.forward(p, cfg, toks, use_kernel=True)
    with torch.no_grad():
        logits, _ = TT.forward(p, cfg, toks, use_kernel=True)
    assert logits.grad_fn is None
