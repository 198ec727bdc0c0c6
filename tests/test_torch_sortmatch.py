"""PyTorch port of the sort search engine (smallz4_tpu_torch/ops/sortmatch.py).

The port's plain path must return the reference's arrays exactly (integers,
tolerance 0): the reference (smallz4_tpu/ops/sortmatch.py) runs its Pallas
kernels in interpret mode on the same numpy inputs.  The port's scan stores
its results at each record's raw position; the reference follows its scan
with a second sort keyed by that position, so the two must agree.  Tests
marked ``cuda`` hold the CUDA kernels against the plain versions and skip
without a card.
"""
import numpy as np
import pytest
import torch

from chip_smoke import SCAN_CASES, scan_rows
from smallz4_tpu_torch.ops import _cuda, sortnet
from smallz4_tpu_torch.ops import sortmatch as tsm

INVALID = 1 << 30
SCAN_SIZES = [1024, 2048]
# (family of chip_smoke.scan_rows or None for _sorted_planes, n): the
# worst cases of the scan at 1,024 slots, and "mixed" rows at n = 1,000
SCAN_REF_CASES = ([(None, n) for n in SCAN_SIZES]
                  + [(c, 1024) for c in SCAN_CASES if c != "mixed"]
                  + [("mixed", 1000)])
SCAN_REF_IDS = [str(n) if c is None else f"{c}-{n}"
                for c, n in SCAN_REF_CASES]
# (seed, start_valid, end_valid, cut_boundary, limit_final)
SEGMENT_CASES = ([(s, 0, 1024, c, f) for s in (7, 11)
                  for c in (False, True) for f in (False, True)]
                 + [(3, 100, 900, False, True)])


def _sorted_planes(n, seed):
    """Sorted record planes (k1, k2, pos_t, e1, e2) as int32 numpy arrays:
    few distinct grams so groups are long, payload words that share
    leading bytes, raw positions a permutation with a fifth of the
    records marked invalid (+2^30), as match_segment makes them."""
    rng = np.random.default_rng(seed)
    k1 = rng.integers(0, 12, n).astype(np.uint32) * np.uint32(0x01010101)
    k2 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    k2[: n // 3] &= np.uint32(0xFFFF0000)  # equal high halves: pos decides
    raw = rng.permutation(n).astype(np.int64)
    pos_t = np.where(rng.random(n) < 0.2, raw + INVALID, raw).astype(np.int32)
    e = rng.integers(0, 3, (n, 8), dtype=np.uint8)  # 8 payload bytes
    e1 = e[:, :4].copy().view("<u4").ravel()
    e2 = e[:, 4:].copy().view("<u4").ravel()
    order = np.lexsort((pos_t, k2, k1))
    return [p[order].view(np.int32) for p in (k1, k2, pos_t, e1, e2)]


def _scan_planes(family, n):
    """One sorted record row [5, n] of SCAN_REF_CASES (int32 numpy)."""
    if family is None:
        return np.stack(_sorted_planes(n, seed=n))
    return scan_rows(np, family, 1, n, seed=n)[0]


def _padded_to_lanes(planes):
    """The reference's scan takes rows of a multiple of 128 slots: append
    records whose grams no record of the row has (so no probe meets them)
    at the raw positions n, n + 1, ... (so its unsort keeps the row's
    results first)."""
    n = planes.shape[1]
    extra = -n % 128
    pad = np.zeros((5, extra), np.int32)
    free = np.setdiff1d(np.arange(extra + 1 + len(np.unique(planes[0]))),
                        planes[0].astype(np.int64))[:extra]
    pad[0] = free
    pad[2] = np.arange(n, n + extra)
    return np.concatenate([planes, pad], axis=1)


def _chain_inputs(n, seed):
    rng = np.random.default_rng(seed)
    lens = rng.choice([0, 4, 5, 8, 12], n).astype(np.int32)
    dists = rng.choice([0, 1, 2, 7, 300], n).astype(np.int32)
    dists[rng.random(n) < 0.3] = 7  # long same-distance runs
    lens[dists == 0] = 0
    return lens, dists


def _chain_case(case, n=1024):
    """Chain rows: the mixed claims above, and one long same-distance run
    (distance 3, length 8 everywhere: every claim grows to the row's
    end)."""
    if case == "mixed":
        return _chain_inputs(n, seed=5)
    return np.full(n, 8, np.int32), np.full(n, 3, np.int32)


# steps 0 (a copy), 10, and 16 (s = 32768 runs past the 1,024-slot row)
CHAIN_CASES = [(steps, case) for steps in (0, 10, 16)
               for case in ("mixed", "one_run")]


def _segment_buf(seed, n=1024):
    """The reference tests' segment corpus (tests/test_sortmatch.py), with
    the 16-byte lookahead; seed 3 is its random partial-validity buffer."""
    rng = np.random.default_rng(seed)
    if seed == 3:
        return rng.integers(97, 100, n + 16).astype(np.uint8)
    parts = [bytes(rng.integers(97, 102, 400, dtype=np.uint8)), b"A" * 300,
             bytes(rng.integers(0, 256, 200, dtype=np.uint8)),
             bytes(rng.integers(97, 102, 200, dtype=np.uint8))]
    buf = np.zeros(n + 16, np.uint8)
    buf[:n] = np.frombuffer((b"".join(parts) * 2)[:n], np.uint8)
    return buf


def _batch_inputs():
    """One [2, SEG_BUF] dispatch at full size: a segment of mixed data
    with a boundary cut and a read-ahead bound, and a padding row."""
    from smallz4_tpu_torch.ops import pipeline

    rng = np.random.default_rng(21)
    bufs = np.zeros((2, pipeline.SEG_BUF), np.uint8)
    text = np.frombuffer(b"the quick brown fox jumps over the lazy dog. "
                         * 1000, np.uint8)
    bufs[0, 1000: 1000 + len(text)] = text
    bufs[0, 60000:90000] = rng.integers(0, 4, 30000, dtype=np.uint8)
    bufs[0, 100000:110000] = 0
    sv = np.array([1000, pipeline.SEG_BUF], np.int32)
    ev = np.array([pipeline.SEG_BUF, 0], np.int32)
    cut = np.array([True, False])
    fin = np.array([False, False])
    return bufs, sv, ev, cut, fin


@pytest.fixture(scope="module")
def ref():
    """Reference outputs (interpret mode), computed once per module."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from smallz4_tpu.ops import sortmatch, sortnet

    out = {}
    with pltpu.force_tpu_interpret_mode():
        for family, n in SCAN_REF_CASES:
            planes = _padded_to_lanes(_scan_planes(family, n))
            k1, _, pos, e1, e2 = map(jnp.asarray, planes)
            blen, bdist, bflag = sortmatch._neighbor_scan(k1, pos, e1, e2)
            raw = (pos & (INVALID - 1)).view(jnp.uint32)
            _, *unsorted = sortnet.sort_records(raw, blen, bdist, bflag,
                                                n_keys=1)
            out["scan", family, n] = [np.asarray(u)[:n] for u in unsorted]
        lens, dists = _chain_inputs(1024, seed=5)
        out["chain"] = np.asarray(sortmatch._chain(
            jnp.asarray(lens), jnp.asarray(dists), 10))
        for steps, case in CHAIN_CASES:
            lens, dists = _chain_case(case)
            out["chain", steps, case] = np.asarray(sortmatch._chain(
                jnp.asarray(lens), jnp.asarray(dists), steps))
        for case in SEGMENT_CASES:
            seed, sv, ev, cut, fin = case
            res = sortmatch.match_segment(
                jnp.asarray(_segment_buf(seed)), jnp.int32(sv), jnp.int32(ev),
                n_entries=1024, chain_steps=10, cut_boundary=cut,
                limit_final=fin)
            out["segment", case] = [np.asarray(r) for r in res]
        res = sortmatch.match_segments(*map(jnp.asarray, _batch_inputs()))
        out["segments"] = [np.asarray(r) for r in res]
    jax.clear_caches()
    return out


@pytest.mark.parametrize("family,n", SCAN_REF_CASES, ids=SCAN_REF_IDS)
def test_neighbor_scan_equals_reference_scan_and_unsort(ref, family, n):
    rec = torch.from_numpy(_scan_planes(family, n))[None]
    got = tsm.neighbor_scan(rec)
    for g, want in zip(got, ref["scan", family, n]):
        assert g.dtype == torch.int32 and g.shape == (1, n)
        np.testing.assert_array_equal(g[0].numpy(), want)
    if family == "distinct grams":  # no probe meets its gram
        assert not got[0].any() and not got[2].any()
    else:
        assert (got[0] > 0).any() and (got[2] & 2).any()  # claims, groups


def _k1_contiguous(k1: np.ndarray) -> bool:
    """Every gram of the row occupies one run of slots."""
    runs = 1 + int(np.count_nonzero(k1[1:] != k1[:-1]))
    return runs == len(np.unique(k1))


@pytest.mark.parametrize("case", SEGMENT_CASES + ["batch"], ids=str)
def test_sorted_segment_records_keep_grams_contiguous(case):
    """The scan kernel stops probing at the first other gram: it relies on
    segment_records followed by sort_records(n_keys=2) leaving equal k1 in
    one run of slots in every row."""
    if case == "batch":
        bufs, sv, ev, cut, _ = map(torch.from_numpy, _batch_inputs())
        rec, _ = tsm.segment_records(bufs, sv, ev, cut)
    else:
        seed, sv, ev, cut, _ = case
        rec, _ = tsm.segment_records(
            torch.from_numpy(_segment_buf(seed))[None], sv, ev, cut, 1024)
    srt = sortnet.sort_records(rec, n_keys=2)
    for row in srt[:, 0].numpy():
        assert _k1_contiguous(row)
    assert not _k1_contiguous(np.array([1, 2, 1]))  # the check can fail


def test_chain_equals_reference(ref):
    lens, dists = _chain_inputs(1024, seed=5)
    got = tsm.chain(torch.from_numpy(lens)[None], torch.from_numpy(dists)[None],
                    10)
    np.testing.assert_array_equal(got[0].numpy(), ref["chain"])
    assert (got[0].numpy() > lens).any()  # the doubling extended claims


@pytest.mark.parametrize("steps,case", CHAIN_CASES)
def test_chain_plain_equals_reference_steps(ref, steps, case):
    lens, dists = _chain_case(case)
    got = tsm.chain_plain(torch.from_numpy(lens)[None],
                          torch.from_numpy(dists)[None], steps)
    np.testing.assert_array_equal(got[0].numpy(), ref["chain", steps, case])
    if case == "one_run" and steps == 16:  # each claim reaches the row end
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.arange(1024, 0, -1) + 7)


@pytest.mark.parametrize("steps", [-1, 31])
def test_chain_refuses_steps_out_of_range(steps):
    lens, dists = (torch.from_numpy(a)[None] for a in _chain_case("mixed"))
    with pytest.raises(ValueError, match="steps"):
        tsm.chain(lens, dists, steps)


@pytest.mark.parametrize("case", SEGMENT_CASES, ids=str)
def test_match_segment_equals_reference(ref, case):
    seed, sv, ev, cut, fin = case
    got = tsm.match_segment(torch.from_numpy(_segment_buf(seed)), sv, ev,
                            n_entries=1024, chain_steps=10, cut_boundary=cut,
                            limit_final=fin)
    for g, want in zip(got, ref["segment", case]):
        np.testing.assert_array_equal(g.numpy(), want)


def test_match_segments_full_size_equals_reference(ref):
    """[2, SEG_BUF] at N_ENTRIES = 2^17 with a padding row; the reference
    returns uint16 lens/dists, the port int32 clamped to 65535."""
    got = tsm.match_segments(*map(torch.from_numpy, _batch_inputs()))
    lens, dists, conv = got
    assert lens.shape == (2, tsm.SEG) and lens.dtype == torch.int32
    assert conv.dtype == torch.bool
    for g, want in zip(got, ref["segments"]):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      want.astype(np.int64))
    assert (lens[1] == 1).all() and conv[1].all()  # padding: nothing valid


def test_mix_is_uint32_arithmetic():
    """The int64 hash mix equals the uint32 arithmetic it stands for."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    m = np.uint64(0xFFFFFFFF)
    want = ((a ^ ((b * np.uint64(0x9E3779B1)) & m))
            * np.uint64(0x85EBCA77)) & m
    got = tsm._mix(torch.from_numpy(a.astype(np.int64)),
                   torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", SCAN_SIZES + [1 << 17])
def test_scan_and_chain_kernels_equal_plain_cuda(n):
    dev = _cuda_or_skip()
    rec = torch.from_numpy(np.stack([np.stack(_sorted_planes(n, seed=s))
                                     for s in (1, 2, 3)])).to(dev)
    before = dict(_cuda.LAUNCHES)
    got = tsm.neighbor_scan(rec)
    torch.cuda.synchronize()
    for g, w in zip(got, tsm.neighbor_scan_plain(rec)):
        assert torch.equal(g, w)
    lens, dists = (torch.from_numpy(np.stack([a, a[::-1].copy()])).to(dev)
                   for a in _chain_inputs(n, seed=9))
    assert torch.equal(tsm.chain(lens, dists, 14),
                       tsm.chain_plain(lens, dists, 14))
    # a batch of 3 x n records: the one-launch route up to
    # s4_scan_direct_max() records, else the two-kernel route
    spread = 3 * n > _cuda.lib().s4_scan_direct_max()
    assert _cuda.LAUNCHES["scan"] == before["scan"] + spread
    assert _cuda.LAUNCHES["scan_direct"] == before["scan_direct"] + (
        not spread)
    assert _cuda.LAUNCHES["chain"] == before["chain"] + 1


def _chain_rows(B, n, kind):
    """[B, n] chain inputs: realistic claims, rows of distance 1 and
    length 20, or random int32 lengths and distances (lengths wrap)."""
    rng = np.random.default_rng(B * n)
    if kind == "claims":
        rows = [_chain_inputs(n, seed=s) for s in range(B)]
        return [np.stack([r[i] for r in rows]) for i in (0, 1)]
    if kind == "dist1":
        return np.full((B, n), 20, np.int32), np.ones((B, n), np.int32)
    lens = rng.integers(-2**31, 2**31, (B, n), dtype=np.int64)
    dists = rng.integers(-2, 3, (B, n), dtype=np.int64)
    dists[:, ::5] = rng.integers(-2**31, 2**31, dists[:, ::5].shape)
    return lens.astype(np.int32), dists.astype(np.int32)


# (B, n, steps, kind): both production shapes, n = 1, odd n, steps 0, 1,
# 17 and 30, random int32 values, distance-1 rows, and a row past the
# one-launch path (chain_wide)
CHAIN_KERNEL_CASES = [(64, 65536, 16, "claims"), (8, 131072, 14, "claims"),
                      (64, 65536, 16, "dist1"), (8, 131072, 14, "dist1"),
                      (3, 1, 5, "claims"), (2, 1001, 17, "claims"),
                      (2, 1001, 0, "random"), (2, 4099, 1, "dist1"),
                      (2, 8193, 30, "random"), (4, 70001, 16, "random"),
                      (2, 131079, 14, "claims")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,steps,kind", CHAIN_KERNEL_CASES, ids=str)
def test_chain_kernel_cases_cuda(B, n, steps, kind):
    dev = _cuda_or_skip()
    lens, dists = (torch.from_numpy(a).to(dev)
                   for a in _chain_rows(B, n, kind))
    wide = n > _cuda.lib().s4_chain_row_max()
    before = dict(_cuda.LAUNCHES)
    got = tsm.chain(lens, dists, steps)
    torch.cuda.synchronize()
    assert torch.equal(got, tsm.chain_plain(lens, dists, steps))
    assert _cuda.LAUNCHES["chain"] == before["chain"] + (not wide)
    assert _cuda.LAUNCHES["chain_wide"] == before["chain_wide"] + wide


@pytest.mark.cuda
def test_match_segments_on_cuda_equals_cpu():
    dev = _cuda_or_skip()
    inputs = [torch.from_numpy(a) for a in _batch_inputs()]
    got = tsm.match_segments(*(t.to(dev) for t in inputs))
    want = tsm.match_segments(*inputs)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# (family, B, n): the cases of scripts/torch_scan_times.py at the
# dispatch shape, one row at small and odd lengths (the probe kernel's
# tiles end at 448 or 1,984 slots, the unsort kernel's spans at 2,048
# positions), odd rows on the two-kernel route, its longest row, and rows
# past it
SCAN_KERNEL_CASES = (
    [(c, 8, 1 << 17) for c in SCAN_CASES]
    + [("mixed", 1, n) for n in (1, 3, 63, 64, 65, 447, 449, 1000, 1024,
                                 1984, 1985, 2047, 2049, 8193, 100_003)]
    + [("one gram", 3, 4099), ("mixed", 3, 100_003), ("one gram", 2, 131_071),
       ("position order", 5, 65_537), ("mixed", 1, 1 << 19),
       ("mixed", 2, (1 << 19) + 7), ("one gram", 1, 600_001)])


@pytest.mark.cuda
@pytest.mark.parametrize("family,B,n", SCAN_KERNEL_CASES, ids=str)
def test_scan_kernel_cases_cuda(family, B, n):
    dev = _cuda_or_skip()
    rec = torch.from_numpy(scan_rows(np, family, B, n, seed=B * n)).to(dev)
    lib = _cuda.lib()
    spread = n <= lib.s4_scan_row_max() and B * n > lib.s4_scan_direct_max()
    before = dict(_cuda.LAUNCHES)
    got = tsm.neighbor_scan(rec)
    torch.cuda.synchronize()
    for g, w in zip(got, tsm.neighbor_scan_plain(rec)):
        assert torch.equal(g, w)
    assert _cuda.LAUNCHES["scan"] == before["scan"] + spread
    assert _cuda.LAUNCHES["scan_direct"] == before["scan_direct"] + (
        not spread)


@pytest.mark.cuda
def test_scan_kernel_real_dispatch_cuda():
    """The records of chip_smoke's sort-engine dispatch, and the same with
    every record invalid."""
    import chip_smoke

    dev = _cuda_or_skip()
    disp = chip_smoke.sort_dispatch(torch, np, dev, chip_smoke.real_corpus())
    invalid = disp.srec.clone()
    invalid[:, 2] |= INVALID
    for rec in (disp.srec, invalid):
        for g, w in zip(tsm.neighbor_scan(rec), tsm.neighbor_scan_plain(rec)):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_scan_refuses_too_many_rows_cuda():
    dev = _cuda_or_skip()
    rows = _cuda.lib().s4_scan_max_rows() + 1
    rec = torch.zeros(rows, 5, 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="rows"):
        tsm.neighbor_scan(rec)
