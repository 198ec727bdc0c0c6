"""PyTorch port of the run-length kernel
(smallz4_tpu_torch/ops/pallas_kernels.py).

The port's plain path must return the reference's run lengths exactly
(integers, tolerance 0): the reference (smallz4_tpu/ops/pallas_kernels.py
``run_lengths``) runs its Pallas kernel in interpret mode on the same numpy
inputs.  Tests marked ``cuda`` hold the CUDA kernel against the plain
version and skip without a card.
"""
import numpy as np
import pytest
import torch

from smallz4_tpu_torch.ops import _cuda
from smallz4_tpu_torch.ops import pallas_kernels as tpk

SIZES = [1024, 4096, 5000, 6000]


def _data(n, seed):
    """Text, a 500-byte run and random bytes (the reference tests' mix),
    plus short runs of few symbols."""
    rng = np.random.default_rng(seed)
    parts = [b"abcabcabc run starts here: ", b"x" * 500,
             rng.integers(0, 256, n // 2, dtype=np.uint8).tobytes(),
             rng.integers(0, 2, n, dtype=np.uint8).tobytes()]
    return np.frombuffer(b"".join(parts)[:n], np.uint8).copy()


def _rows():
    """Three rows of one length: mixed data, a pure run, a run broken at
    the last byte."""
    a = _data(3000, seed=11)
    b = np.full(3000, 7, np.uint8)
    c = np.zeros(3000, np.uint8)
    c[-1] = 1
    return np.stack([a, b, c])


@pytest.fixture(scope="module")
def ref():
    """Reference outputs (interpret mode), computed once per module."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from smallz4_tpu.ops import pallas_kernels

    out = {}
    with pltpu.force_tpu_interpret_mode():
        for n in SIZES:
            out[n] = np.asarray(pallas_kernels.run_lengths(
                jnp.asarray(_data(n, seed=n))))
        out["pure"] = np.asarray(pallas_kernels.run_lengths(
            jnp.asarray(np.full(3072, 65, np.uint8))))
        out["rows"] = [np.asarray(pallas_kernels.run_lengths(jnp.asarray(r)))
                       for r in _rows()]
    jax.clear_caches()
    return out


@pytest.mark.parametrize("n", SIZES)
def test_run_lengths_equals_reference(ref, n):
    got = tpk.run_lengths(torch.from_numpy(_data(n, seed=n)))
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), ref[n])


def test_run_lengths_pure_run_equals_reference(ref):
    got = tpk.run_lengths(torch.full((3072,), 65, dtype=torch.uint8))
    np.testing.assert_array_equal(got.numpy(), ref["pure"])
    np.testing.assert_array_equal(got.numpy(), np.arange(3072, 0, -1))


def test_run_lengths_batched_rows_equal_reference(ref):
    """One call over a [B, n] batch: each row on its own (runs never
    continue into the next row)."""
    got = tpk.run_lengths(torch.from_numpy(_rows()))
    assert got.shape == (3, 3000)
    for row, want in zip(got.numpy(), ref["rows"]):
        np.testing.assert_array_equal(row, want)


def test_run_lengths_rejects_bad_input():
    with pytest.raises(ValueError):
        tpk.run_lengths(torch.zeros(16, dtype=torch.int32))
    with pytest.raises(ValueError):
        tpk.run_lengths(torch.zeros(2, 2, 16, dtype=torch.uint8))
    with pytest.raises(ValueError):
        tpk.run_lengths(torch.zeros(0, dtype=torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (3, 1023), (2, 1025), (8, 1 << 17),
                                   (2, (1 << 21) + 7)], ids=str)
def test_run_lengths_kernel_equals_plain_cuda(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(0, 2, shape, dtype=np.uint8)
    x[0, : shape[1] // 2] = 0  # a long run across many tiles
    xd = torch.from_numpy(x).cuda()
    before = _cuda.LAUNCHES["run_lengths"]
    got = tpk.run_lengths(xd)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["run_lengths"] == before + 1
    assert torch.equal(got, tpk.run_lengths_plain(xd))
