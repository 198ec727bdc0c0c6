"""The device-resident encode of the port
(smallz4_tpu_torch/ops/pipeline.py ``compress_device_resident``:
``chunkmatch.match_chunks_raw`` -> ``parse.estimate_costs_device`` ->
``emit.emit_block_device``).

At C = 1024 in both packages, ``compress_device_resident(device="cpu")``
must equal the JAX package's ``compress_device_resident`` (Pallas interpret
mode) byte for byte over 34 blocks of 2 KiB: the halo carries from block to
block, and the last two blocks start past MAX_DISTANCE + BLOCK_END_NO_MATCH,
so their boundary cut is live.  The stream must decode back, and the
report's byte counters equal the reference's.  ``match_chunks_raw``'s four
claim planes and its halo must equal the reference's; a DP that hits its
round cap must redo the block on the host as the reference does, to the
same bytes.  A test marked ``cuda`` runs the encode on the card against
the CPU, and the real fixture's stream with the emit kernel against the
same encode with the plain emit forced.
"""
import numpy as np
import pytest
import torch

from smallz4_tpu_torch import format as fmt
from smallz4_tpu_torch import native
from smallz4_tpu_torch.ops import chunkmatch as tcm
from smallz4_tpu_torch.ops import pipeline
from smallz4_tpu_torch.utils.profiling import RunReport

C = 1024
BLOCK = 2 * C
N_BLOCKS = 34  # blocks 33 and 34 start at 67,584 and 69,632
# the chunk engine's own sizes (the small_chunks fixture changes them)
DEFAULT_CHUNKS = (tcm.CHUNK, tcm.GROUP, tcm.HEAD_CAP)


def _mixed(n, seed=9):
    """The reference test's generator (tests/test_emit.py): text-like runs
    and repeats of earlier parts."""
    rng = np.random.default_rng(seed)
    parts = []
    while sum(map(len, parts)) < n:
        parts.append(rng.integers(97, 104, 300, dtype=np.uint8).tobytes())
        if parts and rng.random() < 0.5:
            parts.append(parts[int(rng.integers(0, len(parts)))])
    return b"".join(parts)[:n]


@pytest.fixture(scope="module")
def small_chunks():
    """C = 1024, one chunk a group, in the port and (where it is installed)
    in the JAX package, for the whole module: the reference compiles its
    block step once for every test here."""
    saved = (tcm.CHUNK, tcm.GROUP, tcm.HEAD_CAP)
    tcm.CHUNK, tcm.GROUP, tcm.HEAD_CAP = C, 1, C
    jcm = None
    try:
        from smallz4_tpu.ops import chunkmatch as jcm

        jsaved = (jcm.CHUNK, jcm.GROUP, jcm.HEAD_CAP)
        jcm.CHUNK, jcm.GROUP, jcm.HEAD_CAP = C, 1, C
    except ImportError:
        pass
    yield
    tcm.CHUNK, tcm.GROUP, tcm.HEAD_CAP = saved
    if jcm is not None:
        jcm.CHUNK, jcm.GROUP, jcm.HEAD_CAP = jsaved
        import jax

        jax.clear_caches()


@pytest.fixture(scope="module")
def jref(small_chunks):
    pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu

    from smallz4_tpu.ops import chunkmatch as jcm
    from smallz4_tpu.ops import pipeline as jpipe
    from smallz4_tpu.utils.profiling import RunReport as JRunReport

    assert jcm.LOOK == tcm.LOOK and jcm.PROBES == tcm.PROBES
    return jcm, jpipe, JRunReport, pltpu


@pytest.fixture(scope="module")
def streams(jref):
    """(data, reference stream and report, port stream and report)."""
    _, jpipe, JRunReport, pltpu = jref
    data = _mixed(N_BLOCKS * BLOCK)
    jrep = JRunReport(operation="encode", engine="")
    with pltpu.force_tpu_interpret_mode():
        want = jpipe.compress_device_resident(data, block_size=BLOCK,
                                              report=jrep)
    rep = RunReport(operation="encode", engine="")
    got = pipeline.compress_device_resident(data, block_size=BLOCK,
                                            report=rep, device="cpu")
    return data, want, jrep, got, rep


def test_stream_equals_reference(streams):
    data, want, _, got, _ = streams
    assert (N_BLOCKS - 1) * BLOCK >= fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH
    assert got == want
    assert native.decompress(got) == data


def test_report_equals_reference(streams):
    """The byte counters equal the reference's; only compressed bytes (and
    8 header bytes a block) come back, well under one byte an input
    byte."""
    data, want, jrep, got, rep = streams
    assert rep.counters == jrep.counters
    assert rep.counters["n_d2h_bytes"] < len(data)
    assert (rep.operation, rep.engine, rep.bytes_in, rep.bytes_out,
            rep.blocks) == ("encode", "device-resident", len(data),
                            len(got), N_BLOCKS)
    assert set(rep.stages) == {
        "encode", "resident.stage", "resident.upload", "resident.match",
        "resident.dp", "resident.emit", "resident.sync", "resident.fetch"}
    assert rep.wall_s > 0 and all(v >= 0 for v in rep.stages.values())


def test_match_chunks_raw_equals_reference(jref):
    """Four chunks after a history chunk, the boundary cut live in chunk
    0: the claim planes and the carried halo."""
    import jax.numpy as jnp

    jcm, _, _, pltpu = jref
    G = 4
    data = _mixed((G + 1) * C + tcm.LOOK, seed=4)
    arr = np.frombuffer(data, np.uint8)
    n = (G + 1) * C
    bufs = np.stack([arr[(j + 1) * C: (j + 2) * C + tcm.LOOK]
                     for j in range(G)])
    cand = np.array([min(C, n - fmt.BLOCK_END_NO_MATCH + 1 - (j + 1) * C)
                     for j in range(G)], np.int32)
    lim = np.array([n - fmt.BLOCK_END_LITERALS - (j + 1) * C
                    for j in range(G)], np.int32)
    hb = arr[:C + tcm.LOOK].copy()
    cut = C - fmt.BLOCK_END_NO_MATCH
    cg = tcm.pack_cut_gram(data[cut: cut + 4])
    i32 = jnp.int32
    with pltpu.force_tpu_interpret_mode():
        jhalo = jcm.sort_chunk(jnp.asarray(hb), i32(0), i32(C), chunk=C)
        want_halo, want = jcm.match_chunks_raw(
            jhalo, jnp.asarray(bufs), jnp.asarray(cand), jnp.asarray(cand),
            jnp.asarray(lim), i32(cg), i32(cut), n_chunks=G, chunk=C)
    halo = tcm.sort_chunk(torch.from_numpy(hb), 0, C, chunk=C)
    cand_t = torch.from_numpy(cand)
    got_halo, got = tcm.match_chunks_raw(
        halo, torch.from_numpy(bufs), cand_t, cand_t, torch.from_numpy(lim),
        cg, cut, n_chunks=G, chunk=C)
    for a, b in zip(tcm.planes_to_reference(got_halo), want_halo):
        np.testing.assert_array_equal(a, np.asarray(b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0].max()) >= fmt.MIN_MATCH  # matches were found


def test_host_fallback_equals_reference(jref, monkeypatch):
    """A DP that hits its round cap (forced here) redoes the block on the
    host: exact search, native DP and emit, in both packages."""
    import jax.numpy as jnp

    _, jpipe, _, pltpu = jref
    data = _mixed(2 * BLOCK, seed=2)
    real = jpipe._device_resident_block_step

    def jfake(*a, **k):
        halo, payload, n_out, _ok = real(*a, **k)
        return halo, payload, n_out, jnp.bool_(False)

    monkeypatch.setattr(jpipe, "_device_resident_block_step", jfake)
    with pltpu.force_tpu_interpret_mode():
        want = jpipe.compress_device_resident(data, block_size=BLOCK)
    treal = pipeline._device_resident_block_step

    def fake(*a):
        halo, payload, n_out, _ok, rounds = treal(*a)
        return halo, payload, n_out, torch.tensor(False), rounds

    monkeypatch.setattr(pipeline, "_device_resident_block_step", fake)
    rep = RunReport(operation="encode", engine="")
    got = pipeline.compress_device_resident(data, block_size=BLOCK,
                                            report=rep, device="cpu")
    assert got == want
    assert native.decompress(got) == data
    assert "n_d2h_bytes" not in rep.counters  # no payload came back
    assert "resident.fallback" in rep.stages


def test_default_block_size_and_errors(small_chunks):
    """The default block is 16 chunks; a block size off the chunk grid and
    a CUDA device without CUDA raise."""
    data = _mixed(16 * C + 100, seed=3)
    rep = RunReport(operation="encode", engine="")
    frame = pipeline.compress_device_resident(data, report=rep,
                                              device="cpu")
    assert rep.blocks == 2 and native.decompress(frame) == data
    with pytest.raises(ValueError):
        pipeline.compress_device_resident(data, block_size=C + 1,
                                          device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pipeline.compress_device_resident(data, block_size=BLOCK)


@pytest.mark.cuda
def test_device_resident_cuda_equals_cpu(small_chunks):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from smallz4_tpu_torch.ops import _cuda

    data = _mixed(N_BLOCKS * BLOCK)
    want = pipeline.compress_device_resident(data, block_size=BLOCK,
                                             device="cpu")
    _cuda.reset_counts()
    got = pipeline.compress_device_resident(data, block_size=BLOCK,
                                            device="cuda")
    assert got == want
    # a block: the sort of its 2 chunks, one merge, probe, compaction,
    # chain, the parse and the emit
    assert _cuda.LAUNCHES == {k: 0 for k in _cuda.LAUNCHES} | {
        "sort_records": N_BLOCKS + 1, "merge_sorted": N_BLOCKS,
        "probe": N_BLOCKS, "compact": N_BLOCKS, "chain": N_BLOCKS,
        "parse": N_BLOCKS, "emit": N_BLOCKS}


@pytest.mark.cuda
def test_resident_emit_kernel_equals_plain_emit(monkeypatch):
    """The real fixture's resident stream at the default chunk sizes and
    4 MiB blocks: the emit kernel's stream equals the stream with the plain
    emit forced on the card, byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import lzma
    import pathlib

    from smallz4_tpu_torch.ops import _cuda, emit

    root = pathlib.Path(__file__).resolve().parent.parent
    data = lzma.decompress((root / "benchdata" / "realcorpus.bin.xz")
                           .read_bytes())
    for name, value in zip(("CHUNK", "GROUP", "HEAD_CAP"), DEFAULT_CHUNKS):
        monkeypatch.setattr(tcm, name, value)
    bs = fmt.MAX_BLOCK_SIZE
    _cuda.reset_counts()
    got = pipeline.compress_device_resident(data, block_size=bs,
                                            device="cuda")
    assert _cuda.LAUNCHES["emit"] == -(-len(data) // bs)
    monkeypatch.setattr(emit, "emit_block_device", emit.emit_block_plain)
    want = pipeline.compress_device_resident(data, block_size=bs,
                                             device="cuda")
    assert got == want
    assert native.decompress(got) == data
