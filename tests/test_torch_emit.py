"""The device sequence emit of the port (smallz4_tpu_torch/ops/emit.py).

The plain version ``emit_block_plain`` (PyTorch tensor ops, what
``emit_block_device`` runs for a CPU tensor) must equal the JAX package's
``emit_block_device`` (jit on the CPU) over all its output bytes and
``native.emit_block`` over the payload, byte for byte, on the cases of
tests/test_emit.py: text, all literals, literal runs and match lengths whose
extensions chain through 255s, adjacent matches, mixed data and tiny
blocks; the payload must decode back to the block.

``_kernel_model`` is a numpy model of csrc/emit.cu (segment, span and tile
exits, the chain of tile entries, the orbit walked segment by segment, the
aggregates' scan and look-back, the byte writer), held equal to the plain
version at small tiles, so that many tiles, skipped tiles and long runs
show on the CPU cases.  Tests marked ``cuda`` hold the kernel against the
plain version (all output bytes and n_out) and ``native.emit_block`` on
the card: every case, N = 1..20, the real fixture's first 4 MiB block
parsed by the device DP, blocks of many sizes in turn, payload left in the
state that reads as the next call's flags, an all-literal 4 MiB block and
a 4 MiB block of one byte value; each call one count of
``LAUNCHES["emit"]`` and no host sync.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from smallz4_tpu_torch import format as fmt
from smallz4_tpu_torch import native
from smallz4_tpu_torch.ops import _cuda, emit

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _parse(data: bytes):
    """The native DP's parse of one block: (lens, dists)."""
    n = len(data)
    lens = np.zeros(n, np.int32)
    dists = np.zeros(n, np.int32)
    native.match_block_ex(np.frombuffer(data, np.uint8), base=0, bs=n,
                          level=9, lookback=0, cut_pos=-1, lens=lens,
                          dists=dists)
    tail = min(fmt.BLOCK_END_NO_MATCH - 1, n)
    lens[n - tail:] = 1
    dists[n - tail:] = 0
    native.estimate_costs(lens, dists)
    return lens, dists


def _mixed():
    rng = np.random.default_rng(5)
    frag = bytearray(rng.integers(97, 103, 90, dtype=np.uint8).tobytes())
    parts = []
    while sum(map(len, parts)) < 5000:
        frag[int(rng.integers(0, len(frag)))] ^= 1
        parts.append(bytes(frag))
        if rng.random() < 0.3:
            parts.append(rng.integers(0, 256, 150, dtype=np.uint8).tobytes())
        if rng.random() < 0.3:
            parts.append(bytes([int(rng.integers(97, 100))]) * 60)
    return b"".join(parts)[:5000]


def _cases():
    rng = np.random.default_rng(1)
    return {
        "text": (b"the quick brown fox jumps over the lazy dog. " * 40)[:1500],
        "random all literals": np.random.default_rng(0).integers(
            0, 256, 2000, dtype=np.uint8).tobytes(),
        "literal run extension chains": (
            rng.integers(0, 256, 700, dtype=np.uint8).tobytes()
            + b"needle" * 8
            + rng.integers(0, 256, 300, dtype=np.uint8).tobytes()),
        "match extension chains": b"x" * 1200 + b"suffix data" * 4,
        "match past MAX_SAME_LETTER": (b"Q" * (fmt.MAX_SAME_LETTER + 2000)
                                       + b"tail" * 6),
        "adjacent matches": (b"abcdefgh" * 64) + (b"12345678" * 32),
        "mixed": _mixed(),
        "tiny run": b"a" * 16,
        "tiny repeat": b"abcdabcdabcdabcdabcd",
        "tiny literals": b"0123456789abcdef",
    }


CASES = _cases()


@pytest.fixture(scope="module")
def jemit():
    pytest.importorskip("jax")
    import jax
    from smallz4_tpu.ops import emit as je

    yield je
    jax.clear_caches()


def _port(data, lens, dists, device="cpu", fn=None):
    block = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    out, n_out = (fn or emit.emit_block_device)(
        block.to(device), torch.from_numpy(lens).to(device),
        torch.from_numpy(dists).to(device))
    return out.cpu().numpy(), int(n_out)


@pytest.mark.parametrize("case", list(CASES))
def test_emit_equals_reference_and_native(jemit, case):
    import jax.numpy as jnp

    data = CASES[case]
    lens, dists = _parse(data)
    out, n_out = _port(data, lens, dists)
    want_out, want_n = jemit.emit_block_device(
        jnp.asarray(np.frombuffer(data, np.uint8)), jnp.asarray(lens),
        jnp.asarray(dists))
    assert n_out == int(want_n)
    np.testing.assert_array_equal(out, np.asarray(want_out))
    payload = out[:n_out].tobytes()
    assert payload == native.emit_block(data, lens, dists)
    assert native.decompress(fmt.build_frame_header(False)
                             + fmt.build_block_header(n_out, False, False)
                             + payload + fmt.build_end_mark(False)) == data
    assert len(out) == len(data) + len(data) // 255 + 16
    assert not out[n_out:].any()


def test_emit_refuses_bad_inputs():
    block = torch.zeros(32, dtype=torch.uint8)
    ones = torch.ones(32, dtype=torch.int32)
    with pytest.raises(ValueError):
        emit.emit_block_device(block.int(), ones, ones)
    with pytest.raises(ValueError):
        emit.emit_block_device(block, ones[:16], ones)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "match past MAX_SAME_LETTER"])
def test_emit_cuda_equals_cpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data = CASES[case]
    lens, dists = _parse(data)
    got = _port(data, lens, dists, "cuda")
    want = _port(data, lens, dists)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])


# -- a numpy model of csrc/emit.cu -------------------------------------------

def _seq_bytes(nl: int, mlc: int) -> int:
    ext = lambda v: (v - 15) // 255 + 1 if v >= 15 else 0  # noqa: E731
    return 3 + ext(nl) + nl + ext(mlc)


def _combine(a, b):
    """csrc/emit.cu's aggregate (matches, bytes closed inside, first match,
    its length code, end of the last match), a before b."""
    if b[0] == 0:
        return a
    if a[0] == 0:
        return b
    return (a[0] + b[0], a[1] + b[1] + _seq_bytes(b[2] - a[4], b[3]), a[2],
            a[3], b[4])


def _pointer_jump(v, lo: int, hi: int, rounds: int):
    """``rounds`` synchronous rounds of v[x] <- v[v[x]] over x in [lo, hi)
    where v[x] < hi (the kernel's read phase, barrier, write phase)."""
    for _ in range(rounds):
        new = [v[v[x]] if v[x] < hi else v[x] for x in range(lo, hi)]
        v[lo:hi] = new


def _kernel_model(block: bytes, lens, dists, per: int = 2, lanes: int = 4,
                  warps: int = 4):
    """(out, n_out) as csrc/emit.cu computes them, with ``per`` positions a
    segment, ``lanes`` segments a span, ``warps`` spans a tile (the kernel:
    16, 32, 32).  Tiles run in order, each taking F(t) from the one before;
    the look-back folds the tiles' aggregates back to tile 0."""
    N = len(block)
    T, span = per * lanes * warps, per * lanes
    tiles = -(-N // T)
    L = np.maximum(np.asarray(lens, np.int64), 1)
    aggs, seqs = [], {}
    f = 0
    for t in range(tiles):
        base = t * T
        nh = min(T, N - base)
        lc = [int(min(L[base + x], N - base - x)) if base + x < N else 1
              for x in range(T)]
        lb = [int(min(L[base + x], 255)) if base + x < N else 1
              for x in range(T)]
        ex = [0] * T
        for s0 in range(0, T, per):  # segment exits, backwards
            for k in reversed(range(per)):
                x = s0 + k
                j = k + lc[x]
                ex[x] = nh if base + x >= N else (ex[s0 + j] if j < per
                                                  else s0 + j)
        s16 = [min(v, 0xFFFF) for v in ex]
        wex = list(ex)
        for w in range(warps):
            lo = w * span
            _pointer_jump(wex, lo, min(lo + span, nh), lanes.bit_length() - 1)
        tex = list(wex)
        _pointer_jump(tex, 0, nh, warps.bit_length() - 1)
        fr = f - base
        f = base + tex[fr] if fr < nh else f  # F(t+1)
        mines, e = [], fr
        for w in range(warps):
            went = e
            if e < min((w + 1) * span, nh):
                e = wex[e]
            for k in range(lanes):
                mines.append(went)
                if went < min(w * span + (k + 1) * per, nh):
                    went = s16[went]
        seg_aggs, walks = [], []
        for g, mine in enumerate(mines):
            a, x, ms = (0, 0, 0, 0, 0), mine, []
            while x < min((g + 1) * per, nh):
                if lb[x] > 1:
                    m, ml = base + x, int(lens[base + x])
                    ms.append((m, ml))
                    a = _combine(a, (1, 0, m, ml - fmt.MIN_MATCH, m + ml))
                x += lb[x]
            seg_aggs.append(a)
            walks.append(ms)
        tile_agg = (0, 0, 0, 0, 0)
        for a in seg_aggs:
            tile_agg = _combine(tile_agg, a)
        excl = (0, 0, 0, 0, 0)
        for u in reversed(range(t)):  # every earlier tile an aggregate
            excl = _combine(aggs[u], excl)
        excl = _combine((1, 0, 0, 0, 0), excl)  # the match that ends at 0
        aggs.append(tile_agg)
        before = (0, 0, 0, 0, 0)
        for a, ms in zip(seg_aggs, walks):
            cnt, byt, _, _, rl = _combine(excl, before)
            for m, ml in ms:
                seqs[cnt - 1] = (byt, rl, m - rl, ml - fmt.MIN_MATCH,
                                 int(dists[m]))
                byt += _seq_bytes(m - rl, ml - fmt.MIN_MATCH)
                rl = m + ml
                cnt += 1
            before = _combine(before, a)
        if t == tiles - 1:
            cnt, byt, _, _, rl = _combine(excl, tile_agg)
            seqs[cnt - 1] = (byt, rl, N - rl, 0, 0)
            n_out = byt + _seq_bytes(N - rl, 0) - 2
    S = len(seqs)
    assert sorted(seqs) == list(range(S))
    soff = [seqs[s][0] for s in range(S)]
    out = np.zeros(N + N // 255 + 16, np.uint8)
    for o in range(n_out):  # the byte writer
        s = int(np.searchsorted(soff, o, side="right")) - 1
        off, lf, nl, mlc, d = seqs[s]
        rel = o - off
        a_len = 1 + ((nl - 15) // 255 + 1 if nl >= 15 else 0)
        eb = lambda v, k: 255 if k < v // 255 else v - 255 * k  # noqa: E731
        if rel == 0:
            b = (min(nl, 15) << 4) | (0 if s == S - 1 else min(mlc, 15))
        elif rel < a_len:
            b = eb(nl - 15, rel - 1)
        elif rel - a_len < nl:
            b = block[lf + rel - a_len]
        else:
            r = rel - a_len - nl
            b = (d & 0xFF if r == 0 else (d >> 8) & 0xFF if r == 1
                 else eb(mlc - 15, r - 2))
        out[o] = b & 0xFF
    return out, n_out


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_model_equals_plain(case):
    """The kernel's algorithm at tiles of 32 and of 512 positions."""
    data = CASES[case]
    lens, dists = _parse(data)
    want, want_n = _port(data, lens, dists, fn=emit.emit_block_plain)
    for per, lanes, warps in ((2, 4, 4), (4, 8, 16)):
        out, n_out = _kernel_model(data, lens, dists, per, lanes, warps)
        assert n_out == want_n
        np.testing.assert_array_equal(out, want)


def test_cpu_takes_the_plain_version(monkeypatch):
    """A CPU tensor runs the plain version: no kernel count, and the kernel
    library is never asked for."""
    def no_library():
        raise AssertionError("the CPU path asked for the kernel library")

    monkeypatch.setattr(_cuda, "lib", no_library)
    _cuda.reset_counts()
    data = CASES["mixed"]
    lens, dists = _parse(data)
    got = _port(data, lens, dists)
    want = _port(data, lens, dists, fn=emit.emit_block_plain)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    assert _cuda.LAUNCHES["emit"] == 0


def test_entry_point_matches_its_signature():
    """csrc/emit.cu's s4_emit takes as many parameters as its _SIGNATURES
    entry, a c_void_p for every pointer and for the stream."""
    import ctypes

    src = (ROOT / "smallz4_tpu_torch" / "csrc" / "emit.cu").read_text()
    proto = re.search(r"int s4_emit\(([^)]*)\)\s*\{", src).group(1)
    params = [" ".join(p.split()) for p in proto.split(",")]
    sig = _cuda._SIGNATURES["s4_emit"]
    assert len(params) == len(sig)
    for param, argtype in zip(params, sig):
        assert (argtype is ctypes.c_void_p) == ("*" in param), param
    assert sig[-1] is ctypes.c_void_p and params[-1].startswith("void*")


# -- on the card --------------------------------------------------------------

def _cuda_case(data: bytes, lens, dists):
    """The kernel on the card against the plain version (all output bytes,
    n_out) and native.emit_block (the payload); one count a call, no host
    sync inside the call."""
    block = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    args = [block.cuda(), torch.from_numpy(np.asarray(lens, np.int32)).cuda(),
            torch.from_numpy(np.asarray(dists, np.int32)).cuda()]
    want, want_n = emit.emit_block_plain(*args)
    before = _cuda.LAUNCHES["emit"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, n_out = emit.emit_block_device(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _cuda.LAUNCHES["emit"] == before + 1
    assert int(n_out) == int(want_n)
    assert torch.equal(out, want)
    n = int(n_out)
    assert out[:n].cpu().numpy().tobytes() == native.emit_block(
        data, np.asarray(lens, np.int32), np.asarray(dists, np.int32))


def _fixture() -> bytes:
    import lzma

    return lzma.decompress((ROOT / "benchdata" / "realcorpus.bin.xz")
                           .read_bytes())


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_emit_kernel_cases(card, case):
    data = CASES[case]
    _cuda_case(data, *_parse(data))


@pytest.mark.cuda
def test_emit_kernel_tiny_blocks(card):
    rng = np.random.default_rng(3)
    for n in range(1, 21):
        data = (b"abcabcab" * 3)[:n] if n % 2 else rng.integers(
            97, 100, n, dtype=np.uint8).tobytes()
        _cuda_case(data, *_parse(data))


@pytest.mark.cuda
def test_emit_kernel_real_block(card):
    """The real fixture's first 4 MiB block, its claims parsed by the
    device DP."""
    from smallz4_tpu_torch.ops import parse

    data = _fixture()[:fmt.MAX_BLOCK_SIZE]
    n = len(data)
    lens = np.zeros(n, np.int32)
    dists = np.zeros(n, np.int32)
    native.match_block_ex(np.frombuffer(data, np.uint8), base=0, bs=n,
                          level=9, lookback=0, cut_pos=-1, lens=lens,
                          dists=dists)
    lens[n - 11:] = 1
    dists[n - 11:] = 0
    choice, _, conv = parse.estimate_costs_device(
        torch.from_numpy(lens).cuda(), torch.from_numpy(dists).cuda(), n)
    assert bool(conv)
    choice = choice.cpu().numpy()
    _cuda_case(data, choice, np.where(choice > 1, dists, 0))


@pytest.mark.cuda
def test_emit_kernel_blocks_of_many_sizes(card):
    """Blocks of 4 KiB-1 MiB of the real fixture in turn on one stream, as
    the resident encode of small objects calls the emit: each call keeps
    the state words of the calls of other sizes before it."""
    real = _fixture()
    rng = np.random.default_rng(4)
    at = 0
    for n in np.exp(rng.uniform(np.log(4096), np.log(1 << 20), 24)):
        data = real[at:at + int(n)]
        at += int(n)
        _cuda_case(data, *_parse(data))


@pytest.mark.cuda
def test_emit_kernel_state_words_hold_one_kind(card):
    """Each tile's state words sit at one place whatever N (7 words a
    tile after the counter: the chain's status, the look-back's status,
    then 5 words of payload), so a status word is never payload of a call
    of another size: payload words that read as ready for the next call's
    epoch change nothing."""
    data = CASES["mixed"] * 120  # 600,000 bytes: 37 tiles
    lens, dists = _parse(data)
    dev = torch.device("cuda", torch.cuda.current_device())
    words = _cuda.lib().s4_emit_status_words(len(data))
    state, epoch = _cuda.tile_state("emit", dev, words)
    payload = state[1:1 + words].view(words // 7, 7)[:, 2:]
    payload.fill_((((epoch + 1) << 2 | 2) << 32) | 5)
    _cuda_case(data, lens, dists)


@pytest.mark.cuda
def test_emit_kernel_all_literals(card):
    """One sequence of 4,194,304 literals."""
    n = fmt.MAX_BLOCK_SIZE
    data = np.random.default_rng(11).integers(0, 256, n,
                                              dtype=np.uint8).tobytes()
    _cuda_case(data, np.ones(n, np.int32), np.zeros(n, np.int32))


@pytest.mark.cuda
def test_emit_kernel_one_byte_value(card):
    """A 4 MiB block of one byte: matches of 65,535 (extension chains of
    257 bytes) from every position, chains that never merge."""
    data = b"z" * fmt.MAX_BLOCK_SIZE
    _cuda_case(data, *_parse(data))
