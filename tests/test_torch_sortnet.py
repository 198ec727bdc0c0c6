"""PyTorch port of the record sort and merge (smallz4_tpu_torch/ops/sortnet.py).

The port's plain path must return the reference's arrays bit for bit: the
reference (smallz4_tpu/ops/sortnet.py) runs its Pallas networks in
interpret mode on the same numpy inputs.  Tests marked ``cuda`` hold the
CUDA kernels against the plain version and skip without a card.
"""
import numpy as np
import pytest
import torch

from smallz4_tpu_torch.ops import sortnet as tsn

# (name, n, n_keys, unique, n_planes): the first n_keys planes are keys
# (full 32-bit range, so the unsigned compare matters), then a distinct pos
# plane, then payload
SORT_CASES = [
    ("unique6_n1024", 1 << 10, 6, True, 6),
    ("tiebreak2_n2048", 1 << 11, 2, False, 4),
    ("unique1_n4096", 1 << 12, 1, True, 2),
]
MERGE_CASES = [
    ("unique6_n2048", 1 << 11, 6, True, 6),
    ("tiebreak1_n4096", 1 << 12, 1, False, 3),
]


def _planes(seed, n, n_keys, unique, n_planes):
    """uint32 planes; tiebreak cases draw keys from a few values so equal
    keys are common and the pos plane decides."""
    rng = np.random.default_rng(seed)
    hi = 1 << 32 if unique else 4
    keys = [rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)
            for _ in range(n_keys)]
    keys[rng.integers(0, n_keys)][: n // 8] |= np.uint32(1 << 31)
    if unique:  # last key embeds pos, as combo does
        keys[-1] = (keys[-1] & np.uint32(0xFFFF0000)) | np.arange(
            n, dtype=np.uint32)
        rest = []
    else:
        rest = [rng.permutation(n).astype(np.uint32)]
    while n_keys + len(rest) < n_planes:
        rest.append(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                    .astype(np.uint32))
    return keys + rest


def _halves_sorted(planes, n_keys, unique):
    n = len(planes[0])
    out = [np.empty_like(p) for p in planes]
    for lo in (0, n // 2):
        sl = slice(lo, lo + n // 2)
        cols = [p[sl] for p in planes[: n_keys + (0 if unique else 1)]]
        order = np.lexsort(cols[::-1])
        for o, p in zip(out, planes):
            o[sl] = p[sl][order]
    return out


def _t(planes):
    return torch.from_numpy(np.stack([p.view(np.int32) for p in planes]))


@pytest.fixture(scope="module")
def ref():
    """Reference outputs (interpret mode), computed once per module."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from smallz4_tpu.ops import sortnet

    out = {}
    with pltpu.force_tpu_interpret_mode():
        for name, n, k, u, p in SORT_CASES:
            planes = _planes(1, n, k, u, p)
            got = sortnet.sort_records(*map(jnp.asarray, planes), n_keys=k,
                                       unique=u)
            out["sort", name] = (planes, [np.asarray(g) for g in got])
        for name, n, k, u, p in MERGE_CASES:
            planes = _halves_sorted(_planes(2, n, k, u, p), k, u)
            got = sortnet.merge_sorted(*map(jnp.asarray, planes), n_keys=k,
                                       unique=u)
            out["merge", name] = (planes, [np.asarray(g) for g in got])
    jax.clear_caches()
    return out


@pytest.mark.parametrize("case", SORT_CASES, ids=[c[0] for c in SORT_CASES])
def test_sort_records_equals_reference(ref, case):
    name, n, k, u, p = case
    planes, want = ref["sort", name]
    got = tsn.sort_records(_t(planes), n_keys=k, unique=u)
    assert got.dtype == torch.int32 and got.shape == (p, n)
    np.testing.assert_array_equal(got.numpy(), _t(want).numpy())


@pytest.mark.parametrize("case", MERGE_CASES, ids=[c[0] for c in MERGE_CASES])
def test_merge_sorted_equals_reference(ref, case):
    name, n, k, u, p = case
    planes, want = ref["merge", name]
    got = tsn.merge_sorted(_t(planes), n_keys=k, unique=u)
    np.testing.assert_array_equal(got.numpy(), _t(want).numpy())


def test_plain_sort_production_size_matches_lexsort():
    """2^16 records x 6 planes, two rows in one batched call, against
    np.lexsort on the unsigned words (no JAX)."""
    rows = [_planes(s, 1 << 16, 6, True, 6) for s in (3, 4)]
    got = tsn.sort_records(torch.stack([_t(r) for r in rows]), n_keys=6,
                           unique=True)
    for b, planes in enumerate(rows):
        order = np.lexsort(planes[::-1])
        want = np.stack([p[order].view(np.int32) for p in planes])
        np.testing.assert_array_equal(got[b].numpy(), want)


def test_sort_rejects_bad_input():
    with pytest.raises(ValueError):
        tsn.sort_records(torch.zeros(2, 1000, dtype=torch.int32))
    with pytest.raises(ValueError):
        tsn.merge_sorted(torch.zeros(2, 1024, dtype=torch.int32))
    with pytest.raises(TypeError):
        tsn.sort_records(torch.zeros(2, 1024, dtype=torch.int64))
    with pytest.raises(ValueError):  # no plane left for the tiebreak
        tsn.sort_records(torch.zeros(2, 1024, dtype=torch.int32), n_keys=2)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", SORT_CASES + [
    ("unique6_n65536", 1 << 16, 6, True, 6),
    ("tiebreak2_n8192", 1 << 13, 2, False, 5)], ids=lambda c: c[0])
def test_sort_kernel_equals_plain_cuda(case):
    dev = _cuda_or_skip()
    name, n, k, u, p = case
    x = torch.stack([_t(_planes(s, n, k, u, p)) for s in (5, 6, 7)]).to(dev)
    got = tsn.sort_records(x, n_keys=k, unique=u)
    torch.cuda.synchronize()
    assert torch.equal(got, tsn.sort_records_plain(x, n_keys=k, unique=u))


@pytest.mark.cuda
@pytest.mark.parametrize("case", MERGE_CASES + [
    ("unique6_n131072", 1 << 17, 6, True, 6)], ids=lambda c: c[0])
def test_merge_kernel_equals_plain_cuda(case):
    dev = _cuda_or_skip()
    name, n, k, u, p = case
    x = torch.stack([_t(_halves_sorted(_planes(s, n, k, u, p), k, u))
                     for s in (8, 9)]).to(dev)
    got = tsn.merge_sorted(x, n_keys=k, unique=u)
    torch.cuda.synchronize()
    assert torch.equal(got, tsn.merge_sorted_plain(x, n_keys=k, unique=u))
