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


# --- the stability contract and the production shapes -----------------------

def _tied(seed, B, n, n_keys, n_planes, values=3):
    """[B, n_planes, n] int32: keys drawn from a few values (sign bit set on
    some, so the unsigned compare matters), then the input index as payload
    (it shows the order that ties keep), then random words."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, (B, n_planes, n), dtype=np.uint64) \
        .astype(np.uint32)
    x[:, :n_keys] = rng.integers(0, values, (B, n_keys, n)).astype(np.uint32)
    x[:, :n_keys] |= (rng.random((B, n_keys, n)) < 0.5).astype(np.uint32) << 31
    if n_keys < n_planes:
        x[:, n_keys] = np.arange(n, dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32))


def _sort_engine_records(seed, B=8, n=1 << 17):
    """Records shaped as sortmatch.segment_records makes them: two key words
    with ties, pos_t (a permutation of positions, invalid ones offset by
    INVALID_POS) as the signed tiebreak, two payload words."""
    rng = np.random.default_rng(seed)
    x = np.empty((B, 5, n), np.int64)
    x[:, 0] = rng.integers(0, 1 << 12, (B, n)) << 20  # grams: many repeats
    x[:, 1] = rng.integers(0, 1 << 32, (B, n)) & 0xFFFF0FFF
    x[:, 1, ::7] = 0x80000000  # whole-key ties, some with the top bit set
    pos = np.stack([rng.permutation(n) for _ in range(B)])
    x[:, 2] = np.where(rng.random((B, n)) < 0.1, pos + (1 << 30), pos)
    x[:, 3:] = rng.integers(0, 1 << 32, (B, 2, n))
    return torch.from_numpy(x.astype(np.uint32).view(np.int32))


def _lexsorted(row: np.ndarray, n_keys: int, unique: bool) -> np.ndarray:
    cols = [row[c].view(np.uint32) for c in range(n_keys)]
    if not unique:
        cols.append(row[n_keys])  # signed tiebreak
    return row[:, np.lexsort(cols[::-1])]  # stable: ties keep input order


@pytest.mark.parametrize("n_keys", [1, 3])
def test_plain_sort_keeps_input_order_on_ties(n_keys):
    x = _tied(11, 2, 4096, n_keys, n_keys + 2)
    got = tsn.sort_records_plain(x, n_keys=n_keys, unique=True)
    for b in range(2):
        np.testing.assert_array_equal(
            got[b].numpy(), _lexsorted(x[b].numpy(), n_keys, True))
        idx = got[b, n_keys].numpy()
        keys = got[b, :n_keys].numpy().T
        same = (keys[1:] == keys[:-1]).all(1)
        assert same.sum() > 1000 and (idx[1:][same] > idx[:-1][same]).all()


def test_plain_merge_puts_first_half_first_on_ties():
    n = 4096
    x = _tied(12, 2, n, 2, 4).numpy()
    for b in range(2):  # sort each half; the payload keeps the input index
        x[b, :, : n // 2] = _lexsorted(x[b, :, : n // 2], 2, True)
        x[b, :, n // 2:] = _lexsorted(x[b, :, n // 2:], 2, True)
    got = tsn.merge_sorted_plain(torch.from_numpy(x), n_keys=2, unique=True)
    for b in range(2):
        np.testing.assert_array_equal(got[b].numpy(),
                                      _lexsorted(x[b], 2, True))
        first = got[b, 2].numpy() < n // 2
        keys = got[b, :2].numpy().T
        same = (keys[1:] == keys[:-1]).all(1)
        assert not (same & ~first[:-1] & first[1:]).any()


def test_plain_sort_engine_shape_matches_lexsort():
    """[8, 5, 2^17], two key words + the signed pos_t tiebreak."""
    x = _sort_engine_records(13)
    got = tsn.sort_records(x, n_keys=2)
    for b in range(x.shape[0]):
        np.testing.assert_array_equal(got[b].numpy(),
                                      _lexsorted(x[b].numpy(), 2, False))


# (name, B, P, n, n_keys, unique, key values): around the kernel's 4096-record
# tile (the tile clamped to n = 2048; 0, 1 and 2 merge passes at T, 2T, 4T),
# B = 1, one and eight planes, and keys with many ties under unique=True
KERNEL_EDGE_CASES = [
    ("below_tile_n2048", 3, 6, 1 << 11, 6, True, 1 << 32),
    ("at_tile_n4096", 3, 6, 1 << 12, 6, True, 1 << 32),
    ("twice_tile_n8192", 3, 6, 1 << 13, 6, True, 1 << 32),
    ("four_tiles_n16384", 2, 6, 1 << 14, 6, True, 1 << 32),
    ("one_row", 1, 5, 1 << 14, 2, False, 1 << 32),
    ("one_plane", 2, 1, 1 << 13, 1, True, 1 << 32),
    ("eight_planes_tiebreak", 2, 8, 1 << 14, 3, False, 3),
    ("ties_unique2", 2, 4, 1 << 14, 2, True, 3),
    ("ties_unique6", 2, 8, 1 << 13, 6, True, 2),
    ("ties_unique1", 2, 2, 1 << 14, 1, True, 5),
]


def _edge_input(case, seed):
    name, B, P, n, k, u, values = case
    x = _tied(seed, B, n, k, P, values)
    if not u:  # signed tiebreak with negative values and no ties
        x[:, k] = torch.from_numpy(np.stack(
            [np.random.default_rng(seed + b).permutation(n) - n // 2
             for b in range(B)]).astype(np.int32))
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_EDGE_CASES, ids=lambda c: c[0])
def test_sort_kernel_edge_cases_cuda(case):
    dev = _cuda_or_skip()
    name, B, P, n, k, u, _ = case
    x = _edge_input(case, 21).to(dev)
    got = tsn.sort_records(x, n_keys=k, unique=u)
    torch.cuda.synchronize()
    assert torch.equal(got, tsn.sort_records_plain(x, n_keys=k, unique=u))


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_EDGE_CASES, ids=lambda c: c[0])
def test_merge_kernel_edge_cases_cuda(case):
    dev = _cuda_or_skip()
    name, B, P, n, k, u, _ = case
    x = _edge_input(case, 22).to(dev)
    h = n // 2
    x = torch.cat([tsn.sort_records_plain(x[..., :h], k, u),
                   tsn.sort_records_plain(x[..., h:], k, u)], -1)
    got = tsn.merge_sorted(x, n_keys=k, unique=u)
    torch.cuda.synchronize()
    assert torch.equal(got, tsn.merge_sorted_plain(x, n_keys=k, unique=u))


@pytest.mark.cuda
def test_sort_kernel_unaligned_view_cuda():
    """A contiguous view that starts off a 16-byte boundary."""
    dev = _cuda_or_skip()
    x = _edge_input(KERNEL_EDGE_CASES[2], 23).to(dev)
    flat = torch.empty(x.numel() + 1, dtype=torch.int32, device=dev)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    got = tsn.sort_records(view, n_keys=6, unique=True)
    torch.cuda.synchronize()
    assert torch.equal(got, tsn.sort_records_plain(x, n_keys=6, unique=True))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["chunk_sort", "sort_engine", "chunk_merge"])
def test_kernel_production_shapes_cuda(shape):
    """The main path's three calls: the chunk group's sort [64, 6, 65536]
    and merge [64, 6, 131072] (6 keys, unique) and the sort engine's
    dispatch [8, 5, 2^17] (2 keys + tiebreak)."""
    dev = _cuda_or_skip()
    if shape == "sort_engine":
        x = _sort_engine_records(31).to(dev)
        got = tsn.sort_records(x, n_keys=2)
        want = tsn.sort_records_plain(x, n_keys=2)
    else:
        n = 1 << 16 if shape == "chunk_sort" else 1 << 17
        rng = np.random.default_rng(32)
        x = rng.integers(0, 1 << 32, (64, 6, n), dtype=np.uint64) \
            .astype(np.uint32)
        x[:, 0] >>= rng.integers(0, 32, (64, 1)).astype(np.uint32)  # ties
        x[:, 5] = (x[:, 5] & 0xFFFE0000) | np.arange(n, dtype=np.uint32)
        x = torch.from_numpy(x.view(np.int32)).to(dev)
        if shape == "chunk_sort":
            got = tsn.sort_records(x, n_keys=6, unique=True)
            want = tsn.sort_records_plain(x, n_keys=6, unique=True)
        else:
            h = n // 2
            x = torch.cat([tsn.sort_records_plain(x[..., :h], 6, True),
                           tsn.sort_records_plain(x[..., h:], 6, True)], -1)
            got = tsn.merge_sorted(x, n_keys=6, unique=True)
            want = tsn.merge_sorted_plain(x, n_keys=6, unique=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
