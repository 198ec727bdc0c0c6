"""PyTorch port of the gram-hash and run-length kernels
(smallz4_tpu_torch/ops/pallas_kernels.py).

The port's plain path must return the reference's grams, hashes and run
lengths exactly (integers, tolerance 0), the gram kernel's last three
entries included: the reference (smallz4_tpu/ops/pallas_kernels.py
``gram_hash`` and ``run_lengths``) runs its Pallas kernels in interpret
mode on the same numpy inputs.  Tests marked ``cuda`` hold the CUDA kernel against the plain
version and skip without a card.
"""
import numpy as np
import pytest
import torch

from smallz4_tpu_torch.ops import _cuda
from smallz4_tpu_torch.ops import pallas_kernels as tpk

SIZES = [1024, 4096, 5000, 6000]
GH_SIZES = [1024, 4096, 5000, 32767, 32768]


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


def _edge_row(spacing, offset):
    """Runs whose last byte is at k * spacing - 1 + offset (k = 1, 2, 3):
    offset 0 ends them exactly at a multiple of ``spacing``, offset 1 one
    past it; a random stretch in the middle of each run."""
    rng = np.random.default_rng(spacing + offset)
    n = 3 * spacing + 300
    ends = [k * spacing - 1 + offset for k in (1, 2, 3)]
    x = np.searchsorted(ends, np.arange(n), side="left") % 2
    x = x.astype(np.uint8)
    for e in ends:
        x[e - 600: e - 500] = rng.integers(2, 5, 100, dtype=np.uint8)
    return x


EDGE_CASES = [(spacing, offset) for spacing in (1024, 2048, 4096)
              for offset in (0, 1)]


def _gh_data(n, seed):
    """Random bytes 1..255 (so the tail grams show what they read past the
    end), with runs and repeats in the first half."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 256, n, dtype=np.uint8)
    x[: n // 2] = np.frombuffer((b"gram hash " * (n // 20 + 1))[: n // 2],
                                np.uint8)
    return x


def _gh_rows():
    """Three rows of 32767 bytes: the tail reads the last tile's head."""
    return np.stack([_gh_data(32767, seed=s) for s in (1, 2, 3)])


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
        for case in EDGE_CASES:
            out["edge", case] = np.asarray(pallas_kernels.run_lengths(
                jnp.asarray(_edge_row(*case))))
        out["one_run"] = np.asarray(pallas_kernels.run_lengths(
            jnp.asarray(np.full(9000, 3, np.uint8))))
        for n in GH_SIZES:
            out["gh", n] = [np.asarray(a) for a in pallas_kernels.gram_hash(
                jnp.asarray(_gh_data(n, seed=n)))]
        out["gh_rows"] = [[np.asarray(a) for a in pallas_kernels.gram_hash(
            jnp.asarray(r))] for r in _gh_rows()]
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


@pytest.mark.parametrize("case", EDGE_CASES, ids=str)
def test_run_lengths_plain_tile_edges_equal_reference(ref, case):
    """Runs that end exactly at, and one past, multiples of 1,024, 2,048
    and 4,096 (the CUDA kernel's tile is 4,096 bytes)."""
    x = _edge_row(*case)
    got = tpk.run_lengths_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref["edge", case])
    for e in (k * case[0] - 1 + case[1] for k in (1, 2)):
        assert int(got[e]) == 1 and int(got[e - 499]) == 500


def test_run_lengths_plain_one_run_equals_reference(ref):
    got = tpk.run_lengths_plain(torch.full((9000,), 3, dtype=torch.uint8))
    np.testing.assert_array_equal(got.numpy(), ref["one_run"])
    np.testing.assert_array_equal(got.numpy(), np.arange(9000, 0, -1))


@pytest.mark.parametrize("n", GH_SIZES)
def test_gram_hash_equals_reference(ref, n):
    """All n entries, bit for bit: the last three read zero padding, or at a
    tile edge the last tile's first bytes, as the reference kernel does."""
    x = _gh_data(n, seed=n)
    g, h = tpk.gram_hash(torch.from_numpy(x))
    assert g.dtype == h.dtype == torch.int32 and g.shape == h.shape == (n,)
    want_g, want_h = ref["gh", n]
    np.testing.assert_array_equal(g.numpy(), want_g)
    np.testing.assert_array_equal(h.numpy(), want_h)
    assert (h.numpy() >= 0).all() and (h.numpy() < 1 << 20).all()
    if n % tpk.GH_TILE == 0:  # the tail wraps to the tile's head
        b = [int(v) for v in (x[n - 1], x[0], x[1], x[2])]
        want = b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24
        assert int(g[-1]) & 0xFFFFFFFF == want


def test_gram_hash_batched_rows_equal_reference(ref):
    """One call over a [B, n] batch equals the reference on each row."""
    g, h = tpk.gram_hash(torch.from_numpy(_gh_rows()))
    assert g.shape == h.shape == (3, 32767)
    for gr, hr, (want_g, want_h) in zip(g.numpy(), h.numpy(), ref["gh_rows"]):
        np.testing.assert_array_equal(gr, want_g)
        np.testing.assert_array_equal(hr, want_h)


def test_run_lengths_rejects_bad_input():
    with pytest.raises(ValueError):
        tpk.run_lengths(torch.zeros(16, dtype=torch.int32))
    with pytest.raises(ValueError):
        tpk.run_lengths(torch.zeros(2, 2, 16, dtype=torch.uint8))
    with pytest.raises(ValueError):
        tpk.run_lengths(torch.zeros(0, dtype=torch.uint8))
    with pytest.raises(ValueError, match="gram_hash"):
        tpk.gram_hash(torch.zeros(16, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (3, 1023), (2, 1025), (8, 1 << 17),
                                   (2, (1 << 21) + 7), (8, 133119), (2, 4095),
                                   (2, 4096), (2, 4097), (5, 3)], ids=str)
@pytest.mark.parametrize("kind", ["mixed", "one_run", "tile_runs"])
def test_run_lengths_kernel_equals_plain_cuda(shape, kind):
    """Mixed bytes with a long run across many tiles, rows that are one run,
    and alternating runs of the kernel's tile length that each cross a tile
    edge; each call is one launch, and repeated calls (the status words'
    epochs, the tile counter) stay exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(sum(shape))
    if kind == "mixed":
        x = rng.integers(0, 2, shape, dtype=np.uint8)
        x[0, : shape[1] // 2] = 0  # a long run across many tiles
    elif kind == "one_run":
        x = np.full(shape, 9, np.uint8)
    else:
        tile = _cuda.lib().s4_run_lengths_tile()
        alt = (np.arange(shape[1]) + tile // 2) // tile % 2
        x = np.broadcast_to(alt.astype(np.uint8), shape).copy()
    xd = torch.from_numpy(x).cuda()
    want = tpk.run_lengths_plain(xd)
    before = _cuda.LAUNCHES["run_lengths"]
    for _ in range(3):
        assert torch.equal(tpk.run_lengths(xd), want)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["run_lengths"] == before + 3


@pytest.mark.cuda
def test_run_lengths_kernel_unaligned_view_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(_data(5000, seed=3)).cuda()[1:]  # starts off 16 B
    assert torch.equal(tpk.run_lengths(x), tpk.run_lengths_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (3, 32767), (2, 32768),
                                   (8, 133119)], ids=str)
def test_gram_hash_kernel_equals_plain_cuda(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(sum(shape))
    xd = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
    before = _cuda.LAUNCHES["gram_hash"]
    got = tpk.gram_hash(xd)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["gram_hash"] == before + 1
    for g, w in zip(got, tpk.gram_hash_plain(xd)):
        assert torch.equal(g, w)
