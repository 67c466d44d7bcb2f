"""Block quantization in the port against the JAX reference.

On the CPU the port's wrappers run their plain PyTorch version; it must be
byte-identical to ``repro.kernels.ref`` / ``repro.kernels.block_quant``
(the Pallas kernel in interpret mode) / ``repro.core.codecs.Q8Codec``.
The CUDA kernel is held against the plain version in the ``cuda`` tests,
which skip without a card (``chip_smoke.py`` runs the same checks there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codecs as jcodecs
from repro.kernels import block_quant as jbq
from repro.kernels import ref as jref
from repro_torch.core import codecs as tcodecs
from repro_torch.kernels import block_quant as tbq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

GRID_SHAPES = [(8, 128), (16, 128), (64, 256), (24, 384), (2048, 128)]
WIRE_SHAPES = [(1,), (5, 7), (1, 16, 16, 64), (2, 9, 9, 33), (1, 1000),
               (1, 8, 8, 2048)]


def _data(shape, seed):
    """float32 values spread over several decades, so tiles differ in
    scale."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 4, size=shape)
    return x.astype(np.float32)


def _edge_tiles() -> np.ndarray:
    """[32, 128]: an all-zero tile, a tile of exact .5 ties (absmax 127 ->
    scale 1.0), a tile with ±127 and values that clip-round at the top,
    and a tile of one large value beside tiny ones."""
    x = np.zeros((32, 128), np.float32)
    t = x[8:16]
    t[0, 0] = 127.0
    t[0, 1:9] = [2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5, -1.5]
    t = x[16:24]
    t[0, :4] = [127.0, -127.0, 126.5, -126.5]
    t = x[24:32]
    t[0, 0] = 1e6
    t[1, :3] = [1e-3, -1e-3, 3e3]
    return x


_jax_quant_jit = jax.jit(jref.quantize_blocks_ref)


def _jax_quant(x):
    """The JAX oracle as it runs compiled (jit, like the Pallas kernel
    behind the q8 wire): its scale is absmax·f32(1/127)."""
    q, s = _jax_quant_jit(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def _torch_quant(x):
    q, s = tref.quantize_blocks_ref(torch.from_numpy(x))
    return q.numpy(), s.numpy()


@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_quantize_ref_byte_identical_to_jax(shape):
    x = _data(shape, seed=shape[0] + shape[1])
    qj, sj = _jax_quant(x)
    qt, st = _torch_quant(x)
    assert qt.tobytes() == qj.tobytes()
    assert st.tobytes() == sj.tobytes()


def test_quantize_edge_tiles_byte_identical_to_jax():
    x = _edge_tiles()
    qj, sj = _jax_quant(x)
    qt, st = _torch_quant(x)
    assert qt.tobytes() == qj.tobytes() and st.tobytes() == sj.tobytes()
    # the pinned values themselves: zero tile -> scale 1.0; ties round
    # half to even; the clip holds at ±127
    assert st[0, 0] == 1.0 and not qt[:8].any()
    assert st[1, 0] == 1.0
    assert list(qt[8, :9]) == [127, 2, -2, 4, -4, 0, 0, 2, -2]
    assert list(qt[16, :4]) == [127, -127, 126, -126]


@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_dequantize_ref_byte_identical_to_jax(shape):
    x = _data(shape, seed=7 * shape[0])
    qj, sj = _jax_quant(x)
    dj = np.asarray(jref.dequantize_blocks_ref(jnp.asarray(qj),
                                               jnp.asarray(sj)))
    dt = tref.dequantize_blocks_ref(torch.from_numpy(qj.copy()),
                                    torch.from_numpy(sj.copy())).numpy()
    assert dt.tobytes() == dj.tobytes()


def test_scale_is_the_compiled_reference_not_the_eager_one():
    """XLA compiles ``absmax / 127.0`` as ``absmax * f32(1/127)``; op by op
    JAX divides.  The port (and the q8 wire) follow the compiled form, and
    on this data the eager oracle's scales differ from it in the last bit
    for a few tiles while q stays equal."""
    x = _data((4096, 128), seed=1)
    qt, st = _torch_quant(x)
    absmax = np.abs(x.reshape(512, 8, 1, 128)).max(axis=(1, 3))
    assert st.tobytes() == (absmax * np.float32(tref.INV127)).tobytes()
    qe, se = jref.quantize_blocks_ref(jnp.asarray(x))
    se = np.asarray(se)
    assert se.tobytes() == (absmax / np.float32(127.0)).tobytes()
    assert 0 < int((se != st).sum()) < se.size // 10
    assert np.abs(se - st).max() <= np.spacing(st).max()
    assert np.asarray(qe).tobytes() == qt.tobytes()


def test_subnormal_absmax_differs_from_jax_on_cpu():
    """A tile whose absmax is subnormal: absmax/127 underflows to 0.  The
    port keeps subnormals (as the CUDA kernel does), so its scale is 0.0,
    x/0 gives ±inf -> ±127 and 0/0 gives NaN -> 0.  XLA on the CPU flushes
    the subnormal to zero, so the reference sees an all-zero tile (scale
    1.0, q = 0).  Recorded here, not hidden (ROADMAP queue 3)."""
    x = np.zeros((8, 128), np.float32)
    x[0, :3] = [1e-44, -1e-44, 5e-45]
    qt, st = _torch_quant(x)
    qj, sj = _jax_quant(x)
    assert st.tolist() == [[0.0]]
    assert list(qt[0, :4]) == [127, -127, 127, 0] and not qt[1:].any()
    assert sj.tolist() == [[1.0]] and not qj.any()


@pytest.mark.parametrize("shape", GRID_SHAPES[:3])
def test_wrappers_take_the_plain_path_on_cpu(shape):
    x = _data(shape, seed=3)
    tbq.reset_counts()
    q, s = tbq.quantize_blocks(torch.from_numpy(x))
    out = tbq.dequantize_blocks(q, s)
    assert tbq.plain_calls == {"quantize_blocks": 1, "dequantize_blocks": 1}
    assert tbq.launches == {"quantize_blocks": 0, "dequantize_blocks": 0}
    qj, sj = jbq.quantize_blocks(jnp.asarray(x), interpret=True)
    assert q.numpy().tobytes() == np.asarray(qj).tobytes()
    assert s.numpy().tobytes() == np.asarray(sj).tobytes()
    dj = jbq.dequantize_blocks(qj, sj, interpret=True)
    assert out.numpy().tobytes() == np.asarray(dj).tobytes()


def test_wrapper_checks_shape_and_dtype():
    with pytest.raises(ValueError):
        tbq.quantize_blocks(torch.zeros(8, 100))
    with pytest.raises(ValueError):
        tbq.quantize_blocks(torch.zeros(12, 128))
    with pytest.raises(ValueError):
        tbq.dequantize_blocks(torch.zeros(8, 128, dtype=torch.int8),
                              torch.ones(2, 1))


@pytest.mark.parametrize("shape", WIRE_SHAPES)
def test_quantize_wire_byte_identical_to_jax(shape):
    x = _data(shape, seed=sum(shape))
    qj, sj = jbq.quantize_wire(x, interpret=True)
    qt, st = tbq.quantize_wire(x, device="cpu")
    assert qt.tobytes() == qj.tobytes() and st.tobytes() == sj.tobytes()
    n = x.size
    back_t = tbq.dequantize_wire(qt[:n], st, n, shape, np.float32,
                                 device="cpu")
    back_j = jbq.dequantize_wire(qj[:n], sj, n, shape, np.float32,
                                 interpret=True)
    assert back_t.tobytes() == back_j.tobytes()


@pytest.mark.parametrize("shape", WIRE_SHAPES)
def test_q8_codec_blob_byte_identical_and_cross_decodes(shape):
    x = _data(shape, seed=11 + sum(shape))
    blob_j = jcodecs.Q8Codec().encode(x)
    port = tcodecs.Q8Codec(device="cpu")
    blob_t = port.encode(x)
    assert blob_t == blob_j
    # decode runs across the packages in both directions
    from_j = port.decode(blob_j)
    from_t = jcodecs.Q8Codec().decode(blob_t)
    assert from_j.shape == x.shape and from_j.dtype == x.dtype
    assert from_j.tobytes() == from_t.tobytes()
    err = np.abs(from_j - x).max()
    assert err <= port.error_bound(np.abs(x).max())


def test_q8_codec_edge_tiles_byte_identical():
    x = _edge_tiles()
    port = tcodecs.Q8Codec(device="cpu")
    assert port.encode(x) == jcodecs.Q8Codec().encode(x)
    assert port.decode(port.encode(x)).tobytes() == \
        jcodecs.Q8Codec().decode(port.encode(x)).tobytes()


@pytest.mark.parametrize("shape", [(3, 5), (1, 8, 8, 200), (1000,)])
def test_ops_any_rank_padding_matches_jax(shape):
    from repro.kernels import ops as jops
    x = _data(shape, seed=5)
    qj, sj, mj = jops.quantize_blocks(jnp.asarray(x))
    qt, st, mt = tops.quantize_blocks(torch.from_numpy(x))
    assert mt == (tuple(mj[0]), mj[1], mj[2])
    assert qt.numpy().tobytes() == np.asarray(qj).tobytes()
    assert st.numpy().tobytes() == np.asarray(sj).tobytes()
    back = tops.dequantize_blocks(qt, st, mt).numpy()
    assert back.tobytes() == np.asarray(
        jops.dequantize_blocks(qj, sj, mj)).tobytes()


@pytest.mark.parametrize("shape,dtype", [((4, 128, 128), jnp.bfloat16),
                                         ((1, 56, 56, 256), jnp.float32)])
def test_quant_bytes_matches_jax(shape, dtype):
    from repro.kernels import ops as jops
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    assert tops.quant_bytes(shape, tdtype) == jops.quant_bytes(shape, dtype)
    assert tops.quant_bytes(shape, np.float32) == \
        jops.quant_bytes(shape, jnp.float32)


# -- the CUDA kernel against its plain version (needs a card) ------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128), (2048, 128), (4096, 128),
                                   (32768, 128), (64, 512)])
def test_cuda_kernel_matches_plain_version(cuda_device, shape):
    x = torch.from_numpy(_data(shape, seed=shape[0]))
    tbq.reset_counts()
    q, s = tbq.quantize_blocks(x.to(cuda_device))
    out = tbq.dequantize_blocks(q, s)
    torch.cuda.synchronize()
    assert tbq.launches == {"quantize_blocks": 1, "dequantize_blocks": 1}
    qr, sr = tref.quantize_blocks_ref(x.to(cuda_device))
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(out, tref.dequantize_blocks_ref(qr, sr))


@pytest.mark.cuda
def test_cuda_kernel_edge_tiles(cuda_device):
    x = np.concatenate([_edge_tiles(), np.zeros((8, 128), np.float32)])
    x[32, :3] = [1e-44, -1e-44, 5e-45]
    xt = torch.from_numpy(x).to(cuda_device)
    q, s = tbq.quantize_blocks(xt)
    qr, sr = tref.quantize_blocks_ref(xt)
    assert torch.equal(q, qr) and torch.equal(s, sr)
