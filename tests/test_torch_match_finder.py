"""PyTorch port of the walk search engine
(smallz4_tpu_torch/ops/grams.py and ops/match_finder.py).

The port's plain path must return the reference's arrays exactly (integers,
tolerance 0): the reference (smallz4_tpu/ops/grams.py, match_finder.py)
runs in XLA on the CPU on the same numpy inputs, at the reference tests'
buffer size (tests/test_tpu_ops.py, BUF = 32768) and at the full segment
size.  Tests marked ``cuda`` hold the CUDA walk against the plain version
and skip without a card.
"""
import numpy as np
import pytest
import torch

from smallz4_tpu_torch import format as fmt
from smallz4_tpu_torch.ops import _cuda, grams
from smallz4_tpu_torch.ops import match_finder as tmf

BUF = 32768
CORPORA = ["text", "struct", "mixed", "random", "run_mid"]
# (corpus or "run", max_candidates, history corpus, cut_boundary)
BLOCK_CASES = ([(name, k, None, False) for name in CORPORA for k in (4, 64)]
               + [("struct", 16, "text", True), ("run", 8, None, False)])


def _block_input(corpora, name, hist_name):
    """(ctx [BUF], base, end_valid): history then data, zero padded."""
    data = (b"x" * 9000 + b"the-end-part" if name == "run"
            else corpora[name][:16000])
    hist = corpora[hist_name][:8000] if hist_name else b""
    ctx = np.zeros(BUF, np.uint8)
    ctx[: len(hist) + len(data)] = np.frombuffer(hist + data, np.uint8)
    return ctx, len(hist), len(hist) + len(data)


def _gram_input(corpora):
    """Mixed bytes with a validity mask that cuts a prefix and a tail."""
    x = np.frombuffer(corpora["mixed"][:4000], np.uint8)
    pos = np.arange(len(x))
    return x, (pos >= 300) & (pos + 12 <= 3500)


def _segments_input():
    """[2, SEG_BUF]: a cut segment of text, few-symbol noise and a zero run
    long enough to saturate a 16-bit length, and a padding row."""
    rng = np.random.default_rng(21)
    bufs = np.zeros((2, tmf.SEG_BUF), np.uint8)
    text = np.frombuffer(b"the quick brown fox jumps over the lazy dog. "
                         * 1400, np.uint8)[:59000]
    bufs[0, 1000:60000] = text
    bufs[0, 60000:66000] = rng.integers(0, 4, 6000, dtype=np.uint8)
    sv = np.array([1000, tmf.SEG_BUF], np.int32)
    ev = np.array([tmf.SEG_BUF, 0], np.int32)
    cut = np.array([True, False])
    return bufs, sv, ev, cut


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run loops of small tensor operations; with several
    test workers on one host, torch's intra-op threads would oversubscribe
    the cores and stall each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref(corpora):
    """Reference outputs, computed once per module."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from smallz4_tpu.ops import grams as ref_grams
    from smallz4_tpu.ops import match_finder

    out = {}
    x, valid = _gram_input(corpora)
    g = ref_grams.grams4(jnp.asarray(x))
    out["grams4"] = np.asarray(g).view(np.int32)
    out["hash20"] = np.asarray(ref_grams.hash20(g)).astype(np.int32)
    out["prev"] = np.asarray(match_finder.build_prev(g, jnp.asarray(valid)))
    for case in BLOCK_CASES:
        name, k, hist, cut = case
        ctx, base, end = _block_input(corpora, name, hist)
        res = match_finder.match_block(
            jnp.asarray(ctx), base=base, end_valid=jnp.int32(end),
            search_len=BUF - base, max_candidates=k, cut_boundary=cut)
        out["block", case] = [np.asarray(r) for r in res]
    res = match_finder.match_segments(*map(jnp.asarray, _segments_input()),
                                      max_candidates=8)
    out["segments"] = [np.asarray(r) for r in res]
    jax.clear_caches()
    return out


def test_grams4_and_hash20_equal_reference(ref, corpora):
    x, _ = _gram_input(corpora)
    g = grams.grams4(torch.from_numpy(x.copy()))
    assert g.dtype == torch.int32 and g.shape == x.shape
    np.testing.assert_array_equal(g.numpy(), ref["grams4"])
    np.testing.assert_array_equal(grams.hash20(g).numpy(), ref["hash20"])
    assert (g[-3:] == 0).all()


def test_build_prev_equals_reference(ref, corpora):
    """The immediately preceding same-gram position, -1 where that one is
    masked (never an earlier valid one)."""
    x, valid = _gram_input(corpora)
    g = grams.grams4(torch.from_numpy(x.copy()))
    prev = tmf.build_prev(g, torch.from_numpy(valid))
    assert prev.dtype == torch.int32
    np.testing.assert_array_equal(prev.numpy(), ref["prev"])
    assert (prev[300:] >= 0).any() and (prev[:300] == -1).all()


def test_mismatch_bytes_in_u32():
    x = torch.tensor([0x1, 0x100, 0x10000, 0x1000000, 0x80000000 - (1 << 32),
                      0x0300], dtype=torch.int32)
    assert grams.mismatch_bytes_in_u32(x).tolist() == [0, 1, 2, 3, 3, 1]


@pytest.mark.parametrize("case", BLOCK_CASES, ids=str)
def test_match_block_equals_reference(ref, corpora, case):
    name, k, hist, cut = case
    ctx, base, end = _block_input(corpora, name, hist)
    got = tmf.match_block(torch.from_numpy(ctx), base, end_valid=end,
                          search_len=BUF - base, max_candidates=k,
                          cut_boundary=cut)
    for g, want in zip(got, ref["block", case]):
        assert g.shape == (BUF - base,)
        np.testing.assert_array_equal(g.numpy(), want)
    if name == "run":  # distance-1 runs resolve analytically
        assert (got[1][1:100] == 1).all()


def test_match_segments_equals_reference(ref):
    """[2, SEG_BUF] with a cut row and a padding row; the reference returns
    uint16 lens/dists, the port int32 clamped to 65535."""
    lens, dists, conv = got = tmf.match_segments(
        *map(torch.from_numpy, _segments_input()), max_candidates=8)
    assert lens.shape == (2, tmf.SEG) and lens.dtype == torch.int32
    assert conv.dtype == torch.bool
    for g, want in zip(got, ref["segments"]):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      want.astype(np.int64))
    assert (lens[0] == 65535).any() and not conv[0][lens[0] == 65535].any()
    assert (lens[1] == 1).all() and conv[1].all()  # padding: nothing valid


def test_walk_plain_counts_its_work():
    """``counts`` receives the candidate hops and extension words."""
    ctx = torch.frombuffer(bytearray(b"abcdabcdabcdXabcdabcd" * 10),
                           dtype=torch.uint8)[None]
    sv = torch.zeros(1, dtype=torch.int32)
    ev = torch.full((1,), ctx.shape[1], dtype=torch.int32)
    g, prev, runs = tmf.walk_inputs(ctx, sv, ev, torch.zeros(1, dtype=bool),
                                    0)
    counts = {}
    tmf.walk_plain(ctx, g, prev, runs, sv, ev, 0, ctx.shape[1], 4, 512,
                   counts=counts)
    assert counts["hops"] > 0 and counts["ext_words"] > 0


def _walk_case(B, n, seed):
    """Walk inputs of B rows of n bytes: few symbols, repeats and a run."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3, (B, n), dtype=np.uint8)
    x[:, n // 3: n // 2] = 7
    sv = np.minimum(rng.integers(0, 50, B), n).astype(np.int32)
    ev = np.full(B, n, np.int32)
    ev[-1] = max(0, n - 100)  # a read-ahead bound below the row end
    return x, sv, ev


def _far_repeats(n=fmt.MAX_DISTANCE + 5000):
    """One row of random bytes with 48-byte repeats exactly 65535, 65534
    and 65536 (one past the window) apart, and the base and length of a
    search over the second copies."""
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (1, n), dtype=np.uint8)
    for at, d in ((1000, fmt.MAX_DISTANCE), (2000, fmt.MAX_DISTANCE - 1),
                  (3000, fmt.MAX_DISTANCE + 1)):
        x[0, at + d: at + d + 48] = x[0, at: at + 48]
    sv = np.zeros(1, np.int32)
    ev = np.full(1, n, np.int32)
    return x, sv, ev, fmt.MAX_DISTANCE, n - fmt.MAX_DISTANCE


def _back_distance_form(prev):
    """prev as the walk kernel stages it: -1 where the predecessor is none
    or farther back than 65535."""
    q = torch.arange(prev.shape[-1], dtype=torch.int32, device=prev.device)
    return torch.where(q - prev > fmt.MAX_DISTANCE, -1, prev)


# (B, n, base) of _walk_case rows, or "far" for _far_repeats
BACK_DISTANCE_CASES = [(2, 3000, 0), (3, 9000, 100), "far"]


@pytest.mark.parametrize("case", BACK_DISTANCE_CASES, ids=str)
def test_walk_back_distance_prev_is_exact(case):
    """The walk kernel's 16-bit back-distances make a predecessor farther
    than 65535 back into -1: walk_plain gives identical lens, dists and
    conv with that prev."""
    if case == "far":
        x, sv, ev, base, search_len = _far_repeats()
    else:
        B, n, base = case
        x, sv, ev = _walk_case(B, n, n)
        search_len = n - base
    x, sv, ev = (torch.from_numpy(a) for a in (x, sv, ev))
    cut = torch.arange(x.shape[0]) == 0
    g, prev, runs = tmf.walk_inputs(x, sv, ev, cut, base)
    args = (x, g, None, runs, sv, ev, base, search_len, 64, 512)
    want = tmf.walk_plain(*args[:2], prev, *args[3:])
    short = _back_distance_form(prev)
    got = tmf.walk_plain(*args[:2], short, *args[3:])
    for k, w in zip(got, want):
        assert torch.equal(k, w)
    if case == "far":  # the window's edge is exercised on both sides
        assert (short != prev).any()
        assert {fmt.MAX_DISTANCE, fmt.MAX_DISTANCE - 1} <= set(
            want[1].unique().tolist())
        assert fmt.MAX_DISTANCE + 1 not in want[1].unique().tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,base", [(1, 1, 0), (2, 3, 0), (3, 32767, 100),
                                      (2, 32768, 0),
                                      (8, tmf.SEG_BUF, tmf.HALO)], ids=str)
def test_walk_kernel_equals_plain_cuda(B, n, base):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, sv, ev = (torch.from_numpy(a).cuda() for a in _walk_case(B, n, n))
    cut = torch.arange(B, device="cuda") == 0
    g, prev, runs = tmf.walk_inputs(x, sv, ev, cut, base)
    search_len = min(n - base, tmf.SEG)
    args = (x, g, prev, runs, sv, ev, base, search_len, 64, 512)
    before = _cuda.LAUNCHES["walk"]
    got = tmf.walk(*args)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["walk"] == before + 1
    for k, w in zip(got, tmf.walk_plain(*args)):
        assert torch.equal(k, w)


# (rows, base, search_len, max_candidates, ext_cap): rows "few" are
# _walk_case rows of n bytes, "zeros" one zero row (distance-1 runs, so
# rejects at pos + best fall outside the staged bytes), "far" _far_repeats
WALK_CASES = [
    (("zeros", 1, tmf.SEG_BUF), tmf.HALO, tmf.SEG, 64, 512),
    (("far", 1, None), None, None, 64, 512),
    (("few", 2, 32768), 0, 32768, 1, 512),
    (("few", 2, 32768), 0, 32768, 64, 4),
    (("few", 2, 32768), 0, 32768, 64, 2048),
    (("few", 2, 20000), 100, 5000, 64, 512),
    (("few", 1, tmf.SEG_BUF), tmf.HALO, 65535, 64, 512),
    (("few", 1, 140000), 0, 140000, 16, 512),
]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,base,search_len,max_candidates,ext_cap",
                         WALK_CASES, ids=str)
def test_walk_kernel_cases_cuda(rows, base, search_len, max_candidates,
                                ext_cap):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kind, B, n = rows
    if kind == "far":
        x, sv, ev, base, search_len = _far_repeats()
    elif kind == "zeros":
        x = np.zeros((B, n), np.uint8)
        sv, ev = np.zeros(B, np.int32), np.full(B, n, np.int32)
    else:
        x, sv, ev = _walk_case(B, n, n + 1)
    x, sv, ev = (torch.from_numpy(a).cuda() for a in (x, sv, ev))
    cut = torch.arange(B, device="cuda") == 0
    g, prev, runs = tmf.walk_inputs(x, sv, ev, cut, base)
    args = (x, g, prev, runs, sv, ev, base, search_len, max_candidates,
            ext_cap)
    got = tmf.walk(*args)
    torch.cuda.synchronize()
    for k, w in zip(got, tmf.walk_plain(*args)):
        assert torch.equal(k, w)
