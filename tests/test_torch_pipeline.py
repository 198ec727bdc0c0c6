"""PyTorch port of the device stream pipeline
(smallz4_tpu_torch/ops/pipeline.py) and its public API.

Chunk engine: the port's pipeline runs at C = 1024 (one chunk per group) on
the CPU, where every kernel wrapper takes its plain PyTorch version,
through the seven scenarios of the reference's own pipeline tests
(tests/test_chunkmatch.py): parity, small-block delegation, fast
round-trip, head overflow, CPU assist, legacy and dictionary.  Sort engine:
at its full segment size, multi-block, legacy and dictionary streams.  Walk
engine: the reference tests' parity corpora and multi-block input.
Parity streams must equal the port's native.compress byte for byte, and
each engine's parity=False stream must equal the reference engine's
(smallz4_tpu pipeline, Pallas interpret mode).
"""
import ast
import pathlib
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch

import smallz4_tpu_torch
from smallz4_tpu_torch import native
from smallz4_tpu_torch.ops import _cuda, pipeline
from smallz4_tpu_torch.ops import chunkmatch as tcm

C = 1024
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _mixed_stream(n, seed=5):
    """The reference tests' generator (tests/test_chunkmatch.py)."""
    rng = np.random.default_rng(seed)
    parts = []
    while sum(map(len, parts)) < n:
        r = rng.random()
        if r < 0.3:
            parts.append(bytes(rng.integers(0, 256, 200, dtype=np.uint8)))
        elif r < 0.6:
            parts.append(bytes(rng.integers(97, 103, 300, dtype=np.uint8)))
        elif r < 0.8 and parts:
            parts.append(parts[rng.integers(0, len(parts))])
        else:
            parts.append(bytes([rng.integers(0, 256)])
                         * int(rng.integers(5, 200)))
    return b"".join(parts)[:n]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run loops of small tensor operations; with several
    test workers on one host, torch's intra-op threads would oversubscribe
    the cores and stall each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def tiny(monkeypatch):
    """Shrink the port's chunk engine to C = 1024, one chunk per group.
    As in the reference, bit parity at this size holds while every
    candidate fits in (halo chunk, current chunk): parity data <= 2*C."""
    monkeypatch.setattr(tcm, "CHUNK", C)
    monkeypatch.setattr(tcm, "GROUP", 1)
    monkeypatch.setattr(tcm, "HEAD_CAP", C)


def _compress(data, **kw):
    return pipeline.compress(data, 9, device="cpu", **kw)


@pytest.fixture()
def reference_native():
    """The reference engine's native runtime, loaded before it is needed:
    another process's ``make`` may still be writing native/libtlz4.so, so a
    failed load is retried for up to a minute."""
    from smallz4_tpu import native as ref_native

    deadline = time.monotonic() + 60
    while True:
        try:
            assert ref_native._load() is not None
            return ref_native
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(1)


def test_parity(tiny):
    data = _mixed_stream(2 * C)
    stats = {}
    got = _compress(data, block_size=2 * C, stats=stats)
    assert got == native.compress(data, 9, block_size=2 * C)
    assert stats["n_device_blocks"] == 1 and stats["n_positions"] == 2 * C


def test_parity_small_blocks_delegate(tiny):
    data = _mixed_stream(2 * C)
    got = _compress(data, block_size=C)
    assert got == native.compress(data, 9, block_size=C)


def test_fast_roundtrip(tiny):
    data = _mixed_stream(4 * C + 700)
    fast = _compress(data, block_size=2 * C, parity=False)
    assert native.decompress(fast) == data
    want = native.compress(data, 9, block_size=2 * C)
    assert len(fast) <= int(len(want) * 1.10) + 64


def test_head_overflow(tiny, monkeypatch):
    """Chunks with more heads than HEAD_CAP are redone on the host."""
    monkeypatch.setattr(tcm, "HEAD_CAP", 8)
    data = _mixed_stream(2 * C, seed=3)
    assert (_compress(data, block_size=2 * C)
            == native.compress(data, 9, block_size=2 * C))
    fast = _compress(data, block_size=2 * C, parity=False)
    assert native.decompress(fast) == data


def test_cpu_assist(tiny, monkeypatch):
    """Host workers take whole blocks from the back of the stream."""
    monkeypatch.setenv("SMALLZ4_TPU_CPU_ASSIST", "1")
    data = _mixed_stream(6 * C + 100, seed=17)
    stats = {}
    fast = _compress(data, block_size=2 * C, parity=False, stats=stats)
    assert native.decompress(fast) == data
    assert 1 <= stats["n_device_blocks"] < 4  # some blocks were assisted


def test_legacy(tiny):
    data = _mixed_stream(C + 200, seed=23)  # single legacy block
    got = _compress(data, legacy=True, block_size=2 * C)
    assert got == native.compress(data, 9, legacy=True, block_size=2 * C)


def test_dictionary(tiny):
    dict_data = _mixed_stream(700, seed=9)
    data = dict_data[100:500] + _mixed_stream(C - 400, seed=10)
    got = _compress(data, block_size=C, dictionary=dict_data)
    assert got == native.compress(data, 9, block_size=C,
                                  dictionary=dict_data)


def test_fast_stream_equals_reference_engine(tiny, monkeypatch,
                                            reference_native):
    """parity=False keeps raw device claims, so the stream shows any claim
    difference: it must equal the JAX engine's stream."""
    pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu

    from smallz4_tpu.ops import chunkmatch as ref_cm
    from smallz4_tpu.ops import pipeline as ref_pipeline

    monkeypatch.setattr(ref_cm, "CHUNK", C)
    monkeypatch.setattr(ref_cm, "GROUP", 1)
    monkeypatch.setattr(ref_cm, "HEAD_CAP", C)
    data = _mixed_stream(2 * C, seed=8)  # one block: two groups, one carry
    with pltpu.force_tpu_interpret_mode():
        want = ref_pipeline.compress(data, 9, block_size=2 * C, parity=False,
                                     kernel="chunk")
    assert _compress(data, block_size=2 * C, parity=False) == want


def test_public_api(tiny):
    data = _mixed_stream(2 * C, seed=31)
    frame = smallz4_tpu_torch.compress(data, 9, block_size=2 * C,
                                       engine="device", device="cpu")
    assert frame == native.compress(data, 9, block_size=2 * C)
    assert smallz4_tpu_torch.decompress(frame) == data
    assert (smallz4_tpu_torch.compress(data, engine="native")
            == native.compress(data, 9))
    assert smallz4_tpu_torch.get_version() == smallz4_tpu_torch.VERSION


def test_levels_below_9_use_native():
    data = _mixed_stream(3000, seed=2)
    assert (pipeline.compress(data, 5, device="cpu")
            == native.compress(data, 5))


def test_unsupported_requests_raise(tiny):
    """A block size the chunk engine cannot take falls back to the sort
    engine (warning only when 'chunk' was asked for); the device decode
    round-trips on the CPU and raises for a card without CUDA."""
    data = _mixed_stream(3 * C)
    _cuda.reset_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fast = _compress(data, block_size=C + 512, parity=False)
    assert native.decompress(fast) == data
    assert not any(_cuda.LAUNCHES.values())  # the CPU ran the plain versions
    with pytest.warns(UserWarning, match="falling back to kernel='sort'"):
        assert _compress(data, block_size=C + 512, parity=False,
                         kernel="chunk") == fast
    with pytest.raises(ValueError, match="unknown device kernel"):
        _compress(data, block_size=2 * C, parity=False, kernel="bitonic")
    # the device decode runs where it is asked to, and a card it is asked
    # for without CUDA raises
    assert smallz4_tpu_torch.decompress(fast, engine="device",
                                        device="cpu") == data
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            smallz4_tpu_torch.decompress(fast, engine="device",
                                         device="cuda")
    with pytest.raises(ValueError):
        smallz4_tpu_torch.compress(data, engine="tpu")


def _sort_case(name):
    """(data, compress keywords) of the sort-engine parity scenarios."""
    if name == "multi_block":  # 2 blocks of 2 and 1 segments, a cut
        return _mixed_stream(200_000, seed=41), {"block_size": 100_000}
    if name == "legacy_single_block":
        return _mixed_stream(90_000, seed=42), {"legacy": True,
                                                "kernel": "sort"}
    dict_data = _mixed_stream(30_000, seed=9)
    data = dict_data[1000:9000] + _mixed_stream(60_000, seed=10)
    return data, {"dictionary": dict_data, "kernel": "sort"}


@pytest.mark.parametrize("name", ["multi_block", "legacy_single_block",
                                  "dictionary"])
def test_sort_engine_parity(name, monkeypatch):
    """Every block on the sort engine (no CPU assist, which would take
    whole blocks off it in parity mode), as the counts say."""
    monkeypatch.setenv("SMALLZ4_TPU_CPU_ASSIST", "0")
    data, kw = _sort_case(name)
    stats = {}
    got = _compress(data, stats=stats, **kw)
    native_kw = {k: v for k, v in kw.items() if k != "kernel"}
    assert got == native.compress(data, 9, **native_kw)
    assert stats["n_positions"] == len(data)
    assert stats["n_dispatches"] == (2 if name == "multi_block" else 1)


def test_sort_engine_fast_stream_equals_reference_engine(reference_native):
    """parity=False keeps the raw device claims: the sort engine's stream
    must equal the JAX engine's (kernel='sort', interpret mode)."""
    pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu

    from smallz4_tpu.ops import pipeline as ref_pipeline

    data = _mixed_stream(150_000, seed=12)  # 2 blocks, 3 segments
    with pltpu.force_tpu_interpret_mode():
        want = ref_pipeline.compress(data, 9, block_size=100_000,
                                     parity=False, kernel="sort")
    got = _compress(data, block_size=100_000, parity=False, kernel="sort")
    assert got == want
    assert native.decompress(got) == data


@pytest.mark.parametrize("name", ["text", "struct", "mixed", "random"])
def test_walk_engine_parity(corpora, name):
    """The reference tests' parity corpora (tests/test_tpu_ops.py), one
    block, at their max_candidates=8."""
    data = corpora[name]
    stats = {}
    got = _compress(data, kernel="walk", max_candidates=8, stats=stats)
    assert got == native.compress(data, 9)
    assert stats["n_dispatches"] == 1 and stats["n_positions"] == len(data)


def _multiblock_data():
    """The input of tests/test_tpu_ops.py::test_pipeline_multiblock_parity:
    a 128 KiB block and a shorter one, two segments each, with history
    carried over."""
    rng = np.random.default_rng(5)
    piece = rng.integers(0, 256, 30000, dtype=np.uint8).tobytes()
    return (piece + b"needle in a haystack " * 2000 + piece) * 2


@pytest.mark.parametrize("assist", ["0", None], ids=["no_assist",
                                                      "assist"])
def test_walk_engine_multiblock_parity(monkeypatch, assist):
    """Both blocks on the walk engine without the CPU assist; with it (the
    default in parity mode) the assist may take whole blocks, and the
    stream is the same."""
    if assist is not None:
        monkeypatch.setenv("SMALLZ4_TPU_CPU_ASSIST", assist)
    data = _multiblock_data()
    stats = {}
    got = _compress(data, block_size=131072, kernel="walk", max_candidates=8,
                    stats=stats)
    assert got == native.compress(data, 9, block_size=131072)
    assert native.decompress(got) == data
    # one dispatch a device block
    assert stats.get("n_dispatches", 0) == stats.get("n_device_blocks", 0)
    if assist is not None:
        assert stats["n_dispatches"] == 2


def test_walk_engine_fast_stream_equals_reference_engine(reference_native):
    """parity=False keeps the raw walk claims: the stream must equal the
    JAX engine's (kernel='walk') and decode back."""
    pytest.importorskip("jax")
    from smallz4_tpu.ops import pipeline as ref_pipeline

    data = _mixed_stream(150_000, seed=12)  # 2 blocks, 3 segments
    want = ref_pipeline.compress(data, 9, block_size=100_000, parity=False,
                                 kernel="walk", max_candidates=8)
    got = _compress(data, block_size=100_000, parity=False, kernel="walk",
                    max_candidates=8)
    assert got == want
    assert native.decompress(got) == data


def test_walk_engine_from_environment(monkeypatch):
    """$SMALLZ4_TPU_KERNEL=walk picks the walk engine when kernel=None."""
    calls = []
    search = pipeline.mf.match_segments

    def spy(*args, **kw):
        calls.append(kw["max_candidates"])
        return search(*args, **kw)

    monkeypatch.setattr(pipeline.mf, "match_segments", spy)
    monkeypatch.setenv("SMALLZ4_TPU_KERNEL", "walk")
    data = _mixed_stream(20_000, seed=6)
    fast = _compress(data, parity=False, max_candidates=4)
    assert calls == [4]
    assert native.decompress(fast) == data


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        smallz4_tpu_torch.compress(b"abc" * 100, 9, engine="device",
                                   device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):  # the default: the card
        smallz4_tpu_torch.compress(b"abc" * 100)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """Neither the port nor chip_smoke.py imports JAX or anything of the
    JAX package (smallz4_tpu, even its JAX-free modules)."""
    files = sorted((ROOT / "smallz4_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 13
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"smallz4_tpu_torch/ops/parse.py", "smallz4_tpu_torch/ops/emit.py",
            "smallz4_tpu_torch/utils/profiling.py"} <= names
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "smallz4_tpu"), (f, name)


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    """chip_smoke.py prints no result without a card, and fails when it is
    alone in a directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        res = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=script.parent)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


@pytest.mark.cuda
def test_pipeline_on_cuda_equals_native(tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data = _mixed_stream(2 * C)
    _cuda.reset_counts()
    got = pipeline.compress(data, 9, block_size=2 * C, device="cuda")
    assert got == native.compress(data, 9, block_size=2 * C)
    # one block of two groups; its halo sort adds one sort launch
    assert _cuda.LAUNCHES == {k: 0 for k in _cuda.LAUNCHES} | {
        "sort_records": 3, "merge_sorted": 2, "probe": 2, "compact": 2,
        "chain": 2, "pack": 2}


@pytest.mark.cuda
def test_sort_engine_on_cuda_equals_native(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("SMALLZ4_TPU_CPU_ASSIST", "0")  # both blocks here
    data = _mixed_stream(200_000, seed=41)
    _cuda.reset_counts()
    got = pipeline.compress(data, 9, block_size=100_000, device="cuda")
    assert got == native.compress(data, 9, block_size=100_000)
    # two blocks of 2 and 1 segments: one dispatch each
    assert _cuda.LAUNCHES == {k: 0 for k in _cuda.LAUNCHES} | {
        "sort_records": 2, "scan": 2, "chain": 2, "run_lengths": 2}


@pytest.mark.cuda
def test_walk_engine_on_cuda_equals_native(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("SMALLZ4_TPU_CPU_ASSIST", "0")  # both blocks here
    data = _multiblock_data()
    _cuda.reset_counts()
    got = pipeline.compress(data, 9, block_size=131072, device="cuda",
                            kernel="walk")
    assert got == native.compress(data, 9, block_size=131072)
    # two blocks of 2 segments: one dispatch each
    assert _cuda.LAUNCHES == {k: 0 for k in _cuda.LAUNCHES} | {
        "gram_hash": 2, "walk": 2, "run_lengths": 2}
