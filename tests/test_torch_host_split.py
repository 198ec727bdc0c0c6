"""One block's host match search split by position range
(``smallz4_tpu_torch.parallel.host.search``): every split against the
single native call it stands for, cut placement around giant byte runs,
whole parity streams with the split engaged, and its counters.

The range floor is lowered (``_MIN_RANGE``) and the core count fixed at
eight (``_cores``) so that blocks of 0.5-1 MiB split many ways on any
host.  Whole streams run the chunk engine at its real chunk size, one
chunk a group, on the CPU.
"""
import lzma
import pathlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from smallz4_tpu_torch import format as fmt
from smallz4_tpu_torch import native
from smallz4_tpu_torch.ops import chunkmatch as tcm
from smallz4_tpu_torch.ops import pipeline
from smallz4_tpu_torch.parallel import host as hp
from smallz4_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parent.parent
W = fmt.MAX_DISTANCE
CUT = fmt.BLOCK_END_NO_MATCH
MSL = fmt.MAX_SAME_LETTER
BS = 600_000  # a block of the unit tests: cuts can fall every 64 KiB


@pytest.fixture(scope="module")
def corpus():
    return lzma.decompress(
        (ROOT / "benchdata" / "realcorpus.bin.xz").read_bytes())


@pytest.fixture(autouse=True)
def split(monkeypatch):
    monkeypatch.setattr(hp, "_MIN_RANGE", 1 << 15)
    monkeypatch.setattr(hp, "_cores", lambda: 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _block(data: bytes, start: int, history: bool = True):
    """(ctx, base, lookback, cut) of the block at ``start`` as
    ``pipeline._compress_chunked`` passes them: a window of history before
    it where the frame carries history, the boundary chain cut once a
    whole window precedes it."""
    lo = max(start - W, 0) if history else start
    base = start - lo
    cut = base - CUT if history and start >= W + CUT else -1
    return np.frombuffer(data[lo:start + BS], np.uint8), base, base, cut


def _both(ctx, base, lookback, cut, lens, dists, mask=None, dist_fix=False):
    """The single native call and the split on copies of (lens, dists);
    the distance fix reads its targets from its lens, as the pipeline
    passes them.  Returns the split's range count."""
    bs = len(lens)
    one = (lens.copy(), dists.copy())
    two = (lens.copy(), dists.copy())
    if mask is None:
        native.match_block_ex(ctx, base=base, bs=bs, level=9,
                              lookback=lookback, cut_pos=cut, lens=one[0],
                              dists=one[1])
    elif dist_fix:
        native.match_refine_dist(ctx, base=base, bs=bs, lookback=lookback,
                                 mask=mask, targets=one[0], lens=one[0],
                                 dists=one[1], cut_pos=cut)
    else:
        native.match_refine(ctx, base=base, bs=bs, lookback=lookback,
                            mask=mask, lens=one[0], dists=one[1],
                            cut_pos=cut)
    ranges = hp.search(ctx, base, bs, lookback, cut, *two, mask=mask,
                       targets=two[0] if dist_fix else None)
    np.testing.assert_array_equal(two[0], one[0])
    np.testing.assert_array_equal(two[1], one[1])
    return ranges


def _whole(ctx, base, lookback, cut):
    lens = np.zeros(BS, np.int32)
    dists = np.zeros(BS, np.int32)
    native.match_block_ex(ctx, base=base, bs=BS, level=9, lookback=lookback,
                          cut_pos=cut, lens=lens, dists=dists)
    return lens, dists


def _mask(kind: str) -> np.ndarray:
    rng = np.random.default_rng(len(kind))
    i = np.arange(BS)
    m = {"dense": rng.random(BS) < 0.36,
         "sparse": rng.random(BS) < 0.02,
         "clustered": (i > 350_000) & (i < 420_000) & (rng.random(BS) < .5),
         "single": i == 333_333,
         "late": (i > BS // 2) & (rng.random(BS) < 0.3)}.get(kind)
    if kind == "bare_cuts":  # dense, but nothing within a window of two cuts
        m = rng.random(BS) < 0.36
        for c in (225_000, 450_000):
            m[c - W: c + W] = False
    m[BS - CUT + 1:] = False  # the block's last 11 positions are literals
    return m


# (block start, history): a block with a window of history and the
# boundary cut; the stream's first block; a dictionary-like short history;
# a legacy block (no history)
BLOCKS = [(W + 4321, True), (0, True), (20_000, True), (W + 4321, False)]


@pytest.mark.parametrize("start,history", BLOCKS)
def test_whole_search_equals_one_call(corpus, start, history):
    ctx, base, lookback, cut = _block(corpus, start, history)
    ranges = _both(ctx, base, lookback, cut, np.zeros(BS, np.int32),
                   np.zeros(BS, np.int32))
    assert ranges > 4


@pytest.mark.parametrize("kind", ["dense", "sparse", "clustered", "single",
                                  "late", "bare_cuts"])
@pytest.mark.parametrize("dist_fix", [False, True], ids=["refine",
                                                         "dist_fix"])
def test_masked_search_equals_one_call(corpus, kind, dist_fix):
    ctx, base, lookback, cut = _block(corpus, W + 4321)
    lens, dists = _whole(ctx, base, lookback, cut)
    m = _mask(kind)
    if dist_fix:  # exact lengths, distances still to find
        dists[m] = 0
    else:         # claims still to search
        lens[m] = 1
        dists[m] = 0
    ranges = _both(ctx, base, lookback, cut, lens, dists, m, dist_fix)
    assert ranges > 1 or kind == "single"


@pytest.mark.parametrize("start,history", BLOCKS[1:])
def test_masked_search_without_boundary_cut(corpus, start, history):
    ctx, base, lookback, cut = _block(corpus, start, history)
    lens, dists = _whole(ctx, base, lookback, cut)
    m = _mask("dense")
    lens[m] = 1
    dists[m] = 0
    assert _both(ctx, base, lookback, cut, lens, dists, m) > 1


def test_empty_mask_makes_no_call(corpus):
    ctx, base, lookback, cut = _block(corpus, W + 4321)
    lens = np.ones(BS, np.int32)
    assert hp.search(ctx, base, BS, lookback, cut, lens, lens.copy(),
                     mask=np.zeros(BS, bool)) == 0


def test_cuts_snap_out_of_giant_runs():
    back = hp._SCAN_BACK + hp._RUN_MARGIN
    assert hp._cuts([300_000], BS, []) == [300_000]
    # a giant run ending within a scan window before the target, one
    # straddling it, one starting right after it: past each, by a window
    for a, b in [(180_000, 250_000), (280_000, 360_000),
                 (300_050, 380_000)]:
        assert hp._cuts([300_000], BS, [(a, b)]) == [b + back]
    # a run that ends a whole window before the target does not move it
    assert hp._cuts([300_000], BS, [(100, 300_000 - back)]) == [300_000]
    # cuts keep a window from the block's start, each other and its end
    assert hp._cuts([10, 20, 560_000], BS, []) == [2 * hp._SCAN_BACK,
                                                   3 * hp._SCAN_BACK]
    # a run reaching the block's end leaves no cut after it
    assert hp._cuts([300_000], BS, [(290_000, BS)]) == []


def _with_run(corpus, at: int, length: int, byte: int = 0x61) -> bytes:
    """The corpus with an equal-byte run of ``length`` ending at block
    position ``at`` of the block at W + 4321."""
    p = W + 4321 + at
    return corpus[:p - length] + bytes([byte]) * length + corpus[p:]


# whole-search cut targets of a BS block on 8 ranges: multiples of 75,000
# (snapped); runs around the one at 300,000
@pytest.mark.parametrize("length", [MSL - 65, MSL + 1, 70_000, 131_000])
@pytest.mark.parametrize("end", [300_000 - W - 100, 300_000 - 10, 300_000,
                                 300_000 + 1000, 300_000 + 40_000])
def test_giant_runs_around_a_cut(corpus, length, end):
    data = _with_run(corpus, end, length)
    ctx, base, lookback, cut = _block(data, W + 4321)
    assert _both(ctx, base, lookback, cut, np.zeros(BS, np.int32),
                 np.zeros(BS, np.int32)) > 1
    lens, dists = _whole(ctx, base, lookback, cut)
    m = _mask("dense")
    claims = lens.copy(), dists.copy()
    lens[m] = 1
    dists[m] = 0
    assert _both(ctx, base, lookback, cut, lens, dists, m) > 1
    claims[1][m] = 0
    assert _both(ctx, base, lookback, cut, *claims, m, dist_fix=True) > 1


def test_runs_straddling_every_cut(corpus):
    """A giant run across each candidate cut of the whole search."""
    data = corpus
    for c in range(75_000, BS, 75_000):
        data = _with_run(data, c + 35_000, 70_000, byte=c % 251)
    ctx, base, lookback, cut = _block(data, W + 4321)
    _both(ctx, base, lookback, cut, np.zeros(BS, np.int32),
          np.zeros(BS, np.int32))
    lens, dists = _whole(ctx, base, lookback, cut)
    m = _mask("dense")
    lens[m] = 1
    dists[m] = 0
    _both(ctx, base, lookback, cut, lens, dists, m)


def test_long_distance_one_claims_in_short_runs(corpus):
    """Unmasked incoming claims of distance 1 past MaxSameLetter make the
    single call copy them down short runs; no range may start inside
    their reach."""
    data = corpus
    starts = [150_000, 420_000]  # a cut fits only between their reaches
    for s in starts:
        data = _with_run(data, s + 300, 300, byte=0x20)
    ctx, base, lookback, cut = _block(data, W + 4321)
    lens, dists = _whole(ctx, base, lookback, cut)
    m = _mask("dense")
    lens[m] = 1
    dists[m] = 0
    for s in starts:
        m[s: s + 300] = False
        lens[s], dists[s] = MSL + 700, 1
    assert _both(ctx, base, lookback, cut, lens, dists, m) > 1


def test_search_pool_runs_the_cheapest_first():
    pool = hp._SearchPool(1)
    gate = threading.Event()
    ran = []
    first = pool.submit(0, gate.wait, 10)
    late = [pool.submit(cost, ran.append, cost) for cost in (9, 3, 9, 1)]
    gate.set()
    assert first.result(timeout=10)
    for f in late:
        f.result(timeout=10)
    assert ran == [1, 3, 9, 9]
    with pytest.raises(ZeroDivisionError):
        pool.submit(0, lambda: 1 // 0).result(timeout=10)


def test_search_pool_under_contention():
    """More workers and submitters than cores, a short switch interval:
    every call runs once and returns its own result."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = hp._SearchPool(16)
        out = {}

        def submit(t):
            out[t] = [pool.submit(i % 7, lambda x: x * 2, (t, i))
                      for i in range(300)]

        threads = [threading.Thread(target=submit, args=(t,))
                   for t in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
        for t, futs in out.items():
            assert [f.result(timeout=30) for f in futs] == [
                (t, i) * 2 for i in range(300)]
    finally:
        sys.setswitchinterval(interval)


# --- whole streams -------------------------------------------------------

@pytest.fixture()
def one_chunk_groups(monkeypatch):
    """The chunk engine at its real chunk size, one chunk a group, so that
    0.5 MiB blocks run it (and stay bit-exact) on the CPU."""
    monkeypatch.setattr(tcm, "GROUP", 1)


def _stream(corpus, n=1_100_000):
    return corpus[3_000_000: 3_000_000 + n]


@pytest.mark.parametrize("assist", ["0", None], ids=["no_assist",
                                                      "assist"])
def test_parity_stream_with_split(corpus, one_chunk_groups, monkeypatch,
                                  assist):
    if assist is not None:
        monkeypatch.setenv("SMALLZ4_TPU_CPU_ASSIST", assist)
    data = _stream(corpus)
    stats = {}
    got = pipeline.compress(data, 9, device="cpu", block_size=1 << 19,
                            stats=stats)
    assert got == native.compress(data, 9, block_size=1 << 19)
    assert stats["n_search_ranges"] > stats["n_searches"] > 0


def test_legacy_and_dictionary_streams_with_split(corpus, one_chunk_groups):
    data = _stream(corpus, 700_000)
    stats = {}
    got = pipeline.compress(data, 9, legacy=True, device="cpu", stats=stats)
    assert got == native.compress(data, 9, legacy=True)
    assert stats["n_search_ranges"] > stats["n_searches"]
    dictionary = corpus[:50_000]
    stats = {}
    got = pipeline.compress(data, 9, dictionary=dictionary, device="cpu",
                            block_size=1 << 19, stats=stats)
    assert got == native.compress(data, 9, dictionary=dictionary,
                                  block_size=1 << 19)
    assert stats["n_search_ranges"] > stats["n_searches"]


def test_head_overflow_redo_with_split(corpus, one_chunk_groups,
                                       monkeypatch):
    """Fast mode redoes the chunks whose heads overflow (mask = redo): the
    same stream split or not, and it decodes."""
    monkeypatch.setattr(tcm, "HEAD_CAP", 1 << 12)
    data = _stream(corpus, 700_000)
    stats = {}
    got = pipeline.compress(data, 9, device="cpu", block_size=1 << 19,
                            parity=False, stats=stats)
    assert stats["n_search_ranges"] > stats["n_searches"] > 0
    monkeypatch.setattr(hp, "_MIN_RANGE", 1 << 40)
    stats = {}
    assert got == pipeline.compress(data, 9, device="cpu",
                                    block_size=1 << 19, parity=False,
                                    stats=stats)
    assert stats["n_search_ranges"] == stats["n_searches"] > 0
    assert native.decompress(got) == data


@pytest.mark.parametrize("assist", ["0", None], ids=["no_assist",
                                                      "assist"])
def test_sort_engine_refine_with_split(corpus, monkeypatch, assist):
    """The sort engine's refine split, every block on the engine; with the
    CPU assist (the default in parity mode) whole blocks may go to the
    host search instead, and the stream is the same."""
    if assist is not None:
        monkeypatch.setenv("SMALLZ4_TPU_CPU_ASSIST", assist)
    data = _stream(corpus, 700_000)
    stats = {}
    got = pipeline.compress(data, 9, device="cpu", kernel="sort",
                            block_size=1 << 19, stats=stats)
    assert got == native.compress(data, 9, block_size=1 << 19)
    assert stats["n_search_ranges"] > stats["n_searches"]
    if assist is not None:
        assert stats["n_dispatches"] == 2 and stats["n_device_blocks"] == 2


def test_searches_below_the_floor_take_one_call(corpus, monkeypatch):
    """At the tiny chunk engine's 2 KiB blocks no search splits."""
    monkeypatch.setattr(tcm, "CHUNK", 1024)
    monkeypatch.setattr(tcm, "GROUP", 1)
    monkeypatch.setattr(tcm, "HEAD_CAP", 1024)
    monkeypatch.setattr(hp, "_MIN_RANGE", 1 << 17)
    data = corpus[:2048]
    stats = {}
    got = pipeline.compress(data, 9, device="cpu", block_size=2048,
                            stats=stats)
    assert got == native.compress(data, 9, block_size=2048)
    assert stats["n_search_ranges"] == stats["n_searches"] > 0


@pytest.mark.cuda
def test_fixture_on_cuda_splits_both_full_blocks(corpus, monkeypatch):
    """The 10,000,000-byte fixture at every default on the card: the
    stream equals the native encoder's, and the search of each full 4 MiB
    block ran as more than one range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.undo()  # the production floor and core count
    stats = {}
    t0 = time.time_ns()
    got = pipeline.compress(corpus, 9, device="cuda", stats=stats)
    recs = profiling.spans(t0)
    assert got == native.compress(corpus, 9)
    assert stats["n_search_ranges"] > stats["n_searches"]
    full = {r.span_id for r in recs if r.name == "host.block"
            and r.counts["n_positions"] == fmt.MAX_BLOCK_SIZE}
    assert len(full) == 2
    ranges = {r.parent_id: r.counts["n_ranges"] for r in recs
              if r.name == "host.refine" and r.parent_id in full}
    assert len(ranges) == 2 and min(ranges.values()) > 1, ranges
