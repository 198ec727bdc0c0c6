"""The device decode of the port (smallz4_tpu_torch/ops/decoder.py,
ops/pipeline.py ``decompress``, ``decompress_batch``; kernel
csrc/expand.cu).

On the CPU the block expansion's plain version must equal the JAX
package's ``expand_block`` (jit on the CPU) and ``_expand_batch`` over all
``out_cap`` bytes, tolerance 0: on tables that ``native.parse_sequences``
makes of the text, struct, run and random corpora, on a dictionary
history, on a literals-only table, on the worst-case rows of
``chip_smoke.expand_row`` at 64 KiB (a 16 Ki-deep chain, one run, offsets
into the history, literals only, sequence ends and offsets at tile edges)
and on a batch with a padding row.  The history update,
the frame decode (twins of tests/test_tpu_ops.py's decode tests, plus a
legacy frame and a skippable prefix) and the batched decode (twins of
tests/test_batch_decode.py) must equal the reference's arrays and bytes and
the input, and raise the reference's errors.  Tests marked ``cuda`` hold the
kernel against the plain version on the card.
"""
import struct

import numpy as np
import pytest
import torch

import smallz4_tpu_torch
from chip_smoke import EXPAND_CASES, device_ms, expand_batch, expand_row
from smallz4_tpu_torch import format as fmt
from smallz4_tpu_torch import native
from smallz4_tpu_torch.ops import _cuda, decoder, pipeline

WORST_N = 1 << 16  # output bytes of a worst-case row on the CPU


@pytest.fixture(scope="module")
def jref():
    """The JAX package's decoder and pipeline (CPU)."""
    pytest.importorskip("jax")
    from smallz4_tpu.ops import decoder as jdec
    from smallz4_tpu.ops import pipeline as jpipe

    return jdec, jpipe


def _block_table(data: bytes, **kw):
    """(payload, tables) of the first block of native.compress(data); a
    stored block becomes one literal run, as decompress_batch stores it."""
    frame = native.compress(data, 9, **kw)
    payload, tables, out_len = next(decoder.frame_blocks(frame))
    if tables is None:
        tables = tuple(np.asarray([v], np.int32) for v in (out_len, 0, 0, 0))
    return np.frombuffer(payload, np.uint8), tables


def _hist(tail: bytes) -> np.ndarray:
    h = np.zeros(decoder.HIST_CAP, np.uint8)
    if tail:
        h[-len(tail):] = np.frombuffer(tail, np.uint8)
    return h


def _both(jref, rows):
    """(port, reference) outputs of a batch of rows: expand_block_plain
    against expand_block for one row, _expand_batch for several."""
    import jax.numpy as jnp

    jdec, _ = jref
    pay, hist, tabs, oc = expand_batch(np, rows)
    got = decoder.expand_block_plain(torch.from_numpy(pay),
                                     torch.from_numpy(hist),
                                     *torch.from_numpy(tabs), out_cap=oc)
    if len(rows) == 1:
        want = jdec.expand_block(jnp.asarray(pay[0]), jnp.asarray(hist[0]),
                                 *(jnp.asarray(t[0]) for t in tabs),
                                 out_cap=oc)[None]
    else:
        want = jdec._expand_batch(jnp.asarray(pay), jnp.asarray(hist),
                                  *(jnp.asarray(t) for t in tabs),
                                  out_cap=oc)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("name", ["text", "struct", "run", "random"])
def test_expand_plain_equals_reference_corpora(jref, corpora, name):
    data = corpora[name]
    payload, tables = _block_table(data)
    got, want = _both(jref, [(payload, _hist(b""), tables)])
    assert np.array_equal(got, want)
    assert got[0, :len(data)].tobytes() == data


def test_expand_plain_equals_reference_dictionary(jref, corpora):
    dict_data = corpora["text"][:8000]
    data = dict_data[1000:5000] + b"-tail-" + dict_data[:200]
    payload, tables = _block_table(data, dictionary=dict_data)
    got, want = _both(jref, [(payload, _hist(dict_data), tables)])
    assert np.array_equal(got, want)
    assert got[0, :len(data)].tobytes() == data


@pytest.mark.parametrize("case", [c for c in EXPAND_CASES if c != "padding"])
def test_expand_plain_equals_reference_worst_cases(jref, case):
    """Worst-case rows at 64 KiB: literals only, a chain 16 Ki deep, one
    run, offsets that leave the block through the history."""
    got, want = _both(jref, [expand_row(np, case, WORST_N, 1)])
    assert np.array_equal(got, want)


def test_expand_plain_equals_reference_batch(jref, corpora):
    """A batch of 3 rows of unequal lengths, one a padding row."""
    payload, tables = _block_table(corpora["struct"])
    rows = [(payload, _hist(b"h" * 100), tables),
            expand_row(np, "padding", 0, 2),
            expand_row(np, "history offsets", 4096, 3)]
    got, want = _both(jref, rows)
    assert np.array_equal(got, want)
    assert got[0, :len(corpora["struct"])].tobytes() == corpora["struct"]


def test_update_hist_equals_reference(jref):
    import jax.numpy as jnp

    jdec, _ = jref
    rng = np.random.default_rng(7)
    hist = rng.integers(0, 256, (3, decoder.HIST_CAP), dtype=np.uint8)
    out = rng.integers(0, 256, (3, 70000), dtype=np.uint8)
    lens = np.asarray([5, 0, 70000], np.int32)
    for i, n in enumerate(lens):
        got = decoder._update_hist(torch.from_numpy(hist[i]),
                                   torch.from_numpy(out[i]), int(n))
        want = jdec._update_hist(jnp.asarray(hist[i]), jnp.asarray(out[i]),
                                 jnp.int32(n))
        assert np.array_equal(got.numpy(), np.asarray(want))
    got = decoder._update_hist(torch.from_numpy(hist), torch.from_numpy(out),
                               torch.from_numpy(lens))
    want = jdec._update_hist_batch(jnp.asarray(hist), jnp.asarray(out),
                                   jnp.asarray(lens))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_expand_block_roundtrip(jref, corpora):
    """Twin of tests/test_tpu_ops.py: one block of each corpus through the
    block decoder."""
    jdec, _ = jref
    for name in ("text", "struct", "run", "random"):
        data = corpora[name]
        frame = native.compress(data, 9)
        size_word = int.from_bytes(frame[7:11], "little")
        if size_word & fmt.STORED_FLAG:  # stored block: nothing to expand
            continue
        payload = frame[11:11 + size_word]
        dec = decoder.BlockDecoder(out_cap=fmt.MAX_BLOCK_SIZE, device="cpu")
        assert dec.decode(payload, b"") == data, name
        assert dec.decode(payload, b"") == jdec.TpuBlockDecoder(
            out_cap=fmt.MAX_BLOCK_SIZE).decode(payload, b""), name


def test_expand_block_with_history_and_dict(jref, corpora):
    _, jpipe = jref
    dict_data = corpora["text"][:8000]
    data = dict_data[1000:5000] + b"-tail-" + dict_data[:200]
    frame = native.compress(data, 9, dictionary=dict_data)
    got = pipeline.decompress(frame, dictionary=dict_data, device="cpu")
    assert got == data
    assert got == jpipe.decompress(frame, dictionary=dict_data)


def _mixed_frame():
    """Stored and compressed blocks at 131072-byte blocks, with matches
    across a block boundary: random 128 KiB (stored), text that spans
    blocks 2 and 3, random tail."""
    rng = np.random.default_rng(13)
    text = b"the quick brown fox jumps over the lazy dog. " * 3200
    data = (rng.integers(0, 256, 131072, dtype=np.uint8).tobytes()
            + text
            + rng.integers(0, 256, 20000, dtype=np.uint8).tobytes())
    return native.compress(data, 9, block_size=131072), data


def test_tpu_decode_multiblock_mixed(jref):
    _, jpipe = jref
    frame, data = _mixed_frame()
    kinds = [t is not None for _, t, _ in decoder.frame_blocks(frame)]
    assert True in kinds and False in kinds and len(kinds) == 3
    got = pipeline.decompress(frame, device="cpu")
    assert got == data
    assert got == jpipe.decompress(frame)


def test_decode_legacy_and_skippable(jref, corpora):
    _, jpipe = jref
    data = corpora["text"] + corpora["struct"]
    legacy = native.compress(data, 9, legacy=True)
    skip = struct.pack("<II", fmt.MAGIC_SKIPPABLE_BASE + 3, 6) + b"ABCDEF"
    for frame in (legacy, skip + legacy, skip + native.compress(data, 9)):
        got = pipeline.decompress(frame, device="cpu")
        assert got == data
        assert got == jpipe.decompress(frame)


def test_decode_public_api(corpora):
    """engine='device' decodes on the given device; the default device is
    the card, which raises without CUDA; 'auto' is the native decoder."""
    data = corpora["mixed"]
    frame = native.compress(data, 9)
    assert smallz4_tpu_torch.decompress(frame, engine="device",
                                        device="cpu") == data
    assert smallz4_tpu_torch.decompress(frame) == data
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            smallz4_tpu_torch.decompress(frame, engine="device")
        with pytest.raises(RuntimeError, match="cuda"):
            smallz4_tpu_torch.decompress_batch([frame], engine="device")
    with pytest.raises(ValueError, match="unknown engine"):
        smallz4_tpu_torch.decompress(frame, engine="tpu")


@pytest.mark.parametrize("keep", [5, -3, -20], ids=["header", "end mark",
                                                  "payload"])
def test_truncated_frame_errors_equal_reference(jref, corpora, keep):
    """A frame cut short (in its header, its end mark, a block's payload)
    raises the reference's FormatError, in the frame decode and in the
    batch decode."""
    jdec, jpipe = jref
    frame = native.compress(corpora["text"], 9)[:keep]
    errors = []
    for fn in (lambda: pipeline.decompress(frame, device="cpu"),
               lambda: jpipe.decompress(frame),
               lambda: decoder.decompress_batch([frame], device="cpu"),
               lambda: jdec.decompress_batch([frame])):
        with pytest.raises(ValueError) as err:
            fn()
        errors.append((type(err.value).__name__, str(err.value)))
    assert errors[0] == errors[1] == errors[2] == errors[3]
    assert errors[0][0] == "FormatError"


def _oversized_frame():
    """tests/test_batch_decode.py's corrupt frame: its sequences sum past
    the declared maximum block size."""
    seq = b"\x1f" + b"A" + b"\x01\x00" + b"\xff" * 120 + b"\x00"
    payload = seq * 2000
    return (fmt.build_frame_header(False)
            + fmt.build_block_header(len(payload), False, False)
            + payload + fmt.build_end_mark(False))


def test_oversized_block_errors_equal_reference(jref):
    jdec, jpipe = jref
    frame = _oversized_frame()
    with pytest.raises(fmt.FormatError,
                       match="block exceeds declared maximum size"):
        decoder.decompress_batch([frame], device="cpu")
    with pytest.raises(ValueError,
                       match="block exceeds declared maximum size"):
        pipeline.decompress(frame, device="cpu")
    for fn in (lambda: jdec.decompress_batch([frame]),
               lambda: jpipe.decompress(frame)):
        with pytest.raises(ValueError,
                           match="block exceeds declared maximum size"):
            fn()
    with pytest.raises(ValueError, match="block exceeds declared maximum"):
        decoder.BlockDecoder(out_cap=1 << 16, device="cpu").decode(
            native.compress(b"x" * 70000, 9)[11:-4], b"")


# -- twins of tests/test_batch_decode.py -----------------------------------

def _frames():
    rng = np.random.default_rng(4)
    text = b"the quick brown fox jumps over the lazy dog. " * 120
    cases = [
        (text, dict()),
        (rng.integers(0, 256, 9000, dtype=np.uint8).tobytes(), dict()),
        (text * 4, dict(block_size=1 << 16)),
        (text[:3000], dict(legacy=True)),
        (b"x" * 20000 + text[:500], dict()),
        (b"short", dict()),
    ]
    return ([native.compress(raw, 9, **kw) for raw, kw in cases],
            [raw for raw, _ in cases])


def test_batch_roundtrip(jref):
    jdec, _ = jref
    frames, raws = _frames()
    got = decoder.decompress_batch(frames, device="cpu")
    assert got == raws
    assert got == jdec.decompress_batch(frames)


def test_batch_with_dictionary(jref):
    jdec, _ = jref
    dict_data = b"dictionary seed content " * 40
    raw = dict_data[100:400] + b" payload tail " * 30
    fr = native.compress(raw, 9, dictionary=dict_data)
    got = decoder.decompress_batch([fr, fr], dictionary=dict_data,
                                   device="cpu")
    assert got == [raw, raw]
    assert got == jdec.decompress_batch([fr, fr], dictionary=dict_data)


def test_batch_many_rounds(jref):
    """More rounds than the window of rounds in flight, frames of unequal
    block counts: each round's bytes are taken as it lands."""
    jdec, _ = jref
    rng = np.random.default_rng(3)
    text = b"the quick brown fox jumps over the lazy dog. " * 6000
    raws = [text, rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes()
            + text[:50_000], b"short"]
    frames = [native.compress(r, 9, block_size=1 << 16) for r in raws]
    assert max(len(list(decoder.frame_blocks(f))) for f in frames) > 3
    got = decoder.decompress_batch(frames, device="cpu")
    assert got == raws
    assert got == jdec.decompress_batch(frames)


def test_batch_empty():
    assert decoder.decompress_batch([], device="cpu") == []


def test_public_api_batch():
    raws = [b"alpha " * 200, b"beta " * 150]
    frames = [native.compress(r, 9) for r in raws]
    assert smallz4_tpu_torch.decompress_batch(frames) == raws
    assert smallz4_tpu_torch.decompress_batch(frames, engine="device",
                                              device="cpu") == raws


def test_batch_skippable_prefix():
    raw = b"skippable test payload " * 60
    fr = native.compress(raw, 9)
    sk = struct.pack("<II", 0x184D2A50, 6) + b"ABCDEF"
    assert decoder.decompress_batch([sk + fr], device="cpu") == [raw]


def test_batch_corrupt_block_size_rejected():
    with pytest.raises(fmt.FormatError):
        decoder.decompress_batch([_oversized_frame()], device="cpu")


def test_batch_launches_nothing_on_the_cpu():
    """The CPU runs the plain version: no kernel launch is counted."""
    frames, raws = _frames()
    _cuda.reset_counts()
    assert decoder.decompress_batch(frames, device="cpu") == raws
    assert pipeline.decompress(frames[2], device="cpu") == raws[2]
    assert not any(_cuda.LAUNCHES.values())


# -- the kernel on the card ------------------------------------------------

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(dev, pay, hist, tabs):
    return (torch.from_numpy(pay).to(dev), torch.from_numpy(hist).to(dev),
            *torch.from_numpy(tabs).to(dev))


# (case, output bytes)
EXPAND_CUDA = ([(c, 1 << 22) for c in EXPAND_CASES if c != "padding"]
               + [(c, n) for c in ("deep chain", "history offsets",
                                   "tile edges")
                  for n in (4096, 8192 + 4, 100004)])


@pytest.mark.cuda
@pytest.mark.parametrize("case,n", EXPAND_CUDA, ids=str)
def test_expand_kernel_equals_plain_cuda(case, n):
    """The worst cases at 4 MiB (a chain 1M deep among them) and at sizes
    off the kernel's tile, exact over all out_cap bytes, one count."""
    dev = _cuda_or_skip()
    pay, hist, tabs, oc = expand_batch(np, [expand_row(np, case, n, 5)])
    args = _on(dev, pay, hist, tabs)
    before = _cuda.LAUNCHES["expand"]
    got = decoder.expand_block(*args, out_cap=oc)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["expand"] == before + 1
    assert torch.equal(got, decoder.expand_block_plain(*args, out_cap=oc))
    # an out_cap that is no multiple of the tile, past the row's length
    odd = oc + 4099
    assert torch.equal(decoder.expand_block(*args, out_cap=odd),
                       decoder.expand_block_plain(*args, out_cap=odd))


@pytest.mark.cuda
def test_expand_kernel_batch_of_unequal_rows_cuda():
    """8 rows of unequal lengths, two of them padding rows."""
    dev = _cuda_or_skip()
    rows = [expand_row(np, c, n, i) for i, (c, n) in enumerate(
        [("history offsets", 1 << 20), ("padding", 0), ("deep chain", 4096),
         ("one run", 70000), ("literals only", 12), ("padding", 0),
         ("history offsets", 333336), ("deep chain", 1 << 19)])]
    pay, hist, tabs, oc = expand_batch(np, rows)
    args = _on(dev, pay, hist, tabs)
    got = decoder.expand_block(*args, out_cap=oc)
    assert torch.equal(got, decoder.expand_block_plain(*args, out_cap=oc))


@pytest.mark.cuda
def test_expand_kernel_rows_ending_mid_tile_cuda():
    """A batch whose rows end inside a tile, one position either side of a
    tile edge and in its middle, on an out_cap past every row, exact over
    all out_cap bytes, also on an out_cap that is no multiple of 16 (the
    rows' starts off the 16-byte stores)."""
    dev = _cuda_or_skip()
    tile = _cuda.lib().s4_expand_tile()
    rows = [expand_row(np, c, n, i) for i, (c, n) in enumerate(
        [("tile edges", 3 * tile - 4), ("history offsets", 3 * tile + 4),
         ("deep chain", tile + tile // 2), ("tile edges", 5 * tile + 1028),
         ("one run", 2 * tile - 8), ("literals only", tile + 12)])]
    pay, hist, tabs, oc = expand_batch(np, rows)
    args = _on(dev, pay, hist, tabs)
    for cap in (oc, oc + 4099):
        assert torch.equal(decoder.expand_block(*args, out_cap=cap),
                           decoder.expand_block_plain(*args, out_cap=cap))


@pytest.mark.cuda
def test_expand_kernel_fixed_launches_cuda():
    """One launch of the kernel a call (torch.profiler and the wrapper's
    count) on a chain 1M deep as on a real block: no launch depends on the
    chains' depth."""
    dev = _cuda_or_skip()
    real = (b"the quick brown fox jumps over the lazy dog. " * 30000
            + bytes(range(256)) * 2000)
    payload, tables = _block_table(real)
    for row in (expand_row(np, "deep chain", 1 << 22, 1),
                (payload, _hist(b""), tables)):
        pay, hist, tabs, oc = expand_batch(np, [row])
        args = _on(dev, pay, hist, tabs)
        before = _cuda.LAUNCHES["expand"]
        _, per_call = device_ms(
            torch, lambda: decoder.expand_block(*args, out_cap=oc), 5,
            "expand_kernel")
        calls = _cuda.LAUNCHES["expand"] - before
        assert per_call == 1
        # one count a call: 1, then 1 + 5 + 1 a trace
        assert calls in range(8, 44, 7)


@pytest.mark.cuda
def test_device_decode_on_a_second_card_cuda():
    """device='cuda:1' while card 0 is current: the copies to the host are
    ordered on card 1's stream."""
    _cuda_or_skip()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    frame, data = _mixed_frame()
    frames, raws = _frames()
    with torch.cuda.device(0):
        assert pipeline.decompress(frame, device="cuda:1") == data
        assert decoder.decompress_batch(frames, device="cuda:1") == raws


@pytest.mark.cuda
def test_device_decode_roundtrip_cuda():
    """Frame and batch decode on the card equal the input; expand runs once
    a compressed block, once a batch round."""
    _cuda_or_skip()
    frame, data = _mixed_frame()
    _cuda.reset_counts()
    assert smallz4_tpu_torch.decompress(frame, engine="device") == data
    assert _cuda.LAUNCHES["expand"] == sum(
        t is not None for _, t, _ in decoder.frame_blocks(frame))
    frames, raws = _frames()
    _cuda.reset_counts()
    assert smallz4_tpu_torch.decompress_batch(frames, engine="device") == raws
    assert _cuda.LAUNCHES["expand"] == max(
        len(list(decoder.frame_blocks(f))) for f in frames)
