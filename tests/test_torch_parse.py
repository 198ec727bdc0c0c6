"""The device optimal parse of the port (smallz4_tpu_torch/ops/parse.py;
kernel csrc/parse.cu).

On the CPU, ``estimate_costs_device`` (the plain policy iteration) must equal
the JAX package's ``estimate_costs_device`` (jit on the CPU) exactly, with
tolerance 0: choice, cost and converged, on the cases of tests/test_parse.py
(text, padded text, random bytes, literal runs across the 15/270
thresholds, byte runs with the MAX_SAME_LETTER shortcut, deep tiers, mixed
adversarial), each padded to a common N, and at max_iters 1, 2 and 3 where
the reference is cut.  Its choice must equal ``native.estimate_costs``.
Tests marked ``cuda`` hold the kernel against the plain version on the
card, on the same cases, a 1 MiB block of the real fixture's claims and a
65,535-long repeat, and count its launches.

The kernel evaluates a policy on two levels (each tile resolves its jumps
in shared memory, global pointer jumping runs over the entries only):
``_two_level_eval`` is a numpy model of that evaluation, held equal to the
port's and the JAX package's ``_policy_eval`` at a tile of 64 and at the
kernel's.  The synthetic worst cases of ``chip_smoke.parse_claims``
(claims that land on tile edges and on limit, every position an entry,
N not a multiple of the tile, seeded claims across many tiles) run at N <=
2^17 against the JAX package (tests/test_torch_parse_claims.py) and at
phase 3e's sizes on the card.
"""
import lzma
import pathlib

import numpy as np
import pytest
import torch

from chip_smoke import PARSE_CASES, PARSE_TILE, parse_claims
from smallz4_tpu_torch import format as fmt
from smallz4_tpu_torch import native
from smallz4_tpu_torch.ops import _cuda, parse

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_SMALL = 8192        # the common padded length of the small cases
N_LARGE = 1 << 17     # the shortcut needs a block past MAX_SAME_LETTER
MODEL_TILE = 64       # the model's small tile: N_SMALL holds 128 of them
# the N of parse_claims' cases on the CPU
CLAIM_N = {"periodic": N_LARGE, "tile edges": N_LARGE, "limit landing":
           1 << 16, "odd N": 3 * PARSE_TILE + 777, "synthetic": N_LARGE}


def _claims(data: bytes):
    """Level-9 claims of one block (the DP's input), the last 11 positions
    literals."""
    n = len(data)
    lens = np.zeros(n, np.int32)
    dists = np.zeros(n, np.int32)
    native.match_block_ex(np.frombuffer(data, np.uint8), base=0, bs=n,
                          level=9, lookback=0, cut_pos=-1, lens=lens,
                          dists=dists)
    tail = min(fmt.BLOCK_END_NO_MATCH - 1, n)
    lens[n - tail:] = 1
    dists[n - tail:] = 0
    return lens, dists


def _mixed_adversarial():
    rng = np.random.default_rng(7)
    frag = bytearray(rng.integers(97, 103, 120, dtype=np.uint8).tobytes())
    parts = []
    while sum(map(len, parts)) < 6000:
        frag[int(rng.integers(0, len(frag)))] ^= 1
        parts.append(bytes(frag))
        if rng.random() < 0.3:
            parts.append(bytes([int(rng.integers(97, 100))]) * 50)
        if rng.random() < 0.2:
            parts.append(rng.integers(0, 256, 200, dtype=np.uint8).tobytes())
    return b"".join(parts)[:6000]


def _cases():
    rng = np.random.default_rng(1)
    lit_runs = b"".join([rng.integers(0, 256, 300, dtype=np.uint8).tobytes(),
                         b"needle" * 8,
                         rng.integers(0, 256, 700, dtype=np.uint8).tobytes(),
                         b"needle" * 8,
                         rng.integers(0, 256, 300, dtype=np.uint8).tobytes()])
    frag = np.random.default_rng(3).integers(32, 127, 700,
                                             dtype=np.uint8).tobytes()
    return {
        "text": (b"the quick brown fox jumps over the lazy dog. " * 40)[:1600],
        "text padded": (b"lz4 block stream token frame parse " * 60)[:1800],
        "random": np.random.default_rng(0).integers(
            0, 256, 2000, dtype=np.uint8).tobytes(),
        "literal runs": lit_runs,
        "byte runs": b"x" * 900 + b"abcd" * 30 + b"y" * 400 + b"z" * 80,
        "shortcut": (b"Q" * (fmt.MAX_SAME_LETTER + 4000)
                     + b"tail data here" * 10),
        "deep tiers": frag + b"-=-" + frag + b"+" + frag[:500] + frag,
        "mixed adversarial": _mixed_adversarial(),
    }


CASES = _cases()


def _padded(data: bytes):
    """(lens, dists) padded to the case's common N with literals, n."""
    n = len(data)
    N = N_SMALL if n <= N_SMALL else N_LARGE
    lens, dists = _claims(data)
    dl = np.ones(N, np.int32)
    dd = np.zeros(N, np.int32)
    dl[:n] = lens
    dd[:n] = dists
    return dl, dd, n


def _inputs(case: str):
    """(lens, dists, n, block bytes or None): a CASES block padded, or the
    claims of parse_claims' case at its CPU size."""
    if case in CASES:
        return (*_padded(CASES[case]), CASES[case])
    return (*parse_claims(np, case, CLAIM_N[case], seed=13), None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain policy iteration runs many tensor operations over up to
    2^17 positions; with several test workers on one host, torch's
    intra-op threads oversubscribe the cores and stall each other (this
    file took 47 s alone and 15 minutes beside one other such worker)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jparse():
    pytest.importorskip("jax")
    import jax
    from smallz4_tpu.ops import parse as jp

    yield jp
    jax.clear_caches()


def _reference(jparse, dl, dd, n, max_iters):
    import jax.numpy as jnp

    choice, cost, conv = jparse.estimate_costs_device(
        jnp.asarray(dl), jnp.asarray(dd), n, max_iters=max_iters)
    return np.asarray(choice), np.asarray(cost), bool(conv)


def _port(dl, dd, n, max_iters=48, device="cpu"):
    return parse.policy_iteration(torch.from_numpy(dl).to(device),
                                  torch.from_numpy(dd).to(device), n,
                                  max_iters)


@pytest.mark.parametrize("case", list(CASES))
def test_estimate_costs_equals_reference(jparse, case):
    """The blocks of CASES; parse_claims' cases are in
    tests/test_torch_parse_claims.py, so that a run split by file takes
    the longest cases on two workers."""
    estimate_costs_equals_reference(jparse, case)


def estimate_costs_equals_reference(jparse, case):
    dl, dd, n, data = _inputs(case)
    want_choice, want_cost, want_conv = _reference(jparse, dl, dd, n, 48)
    choice, cost, conv = parse.estimate_costs_device(
        torch.from_numpy(dl), torch.from_numpy(dd), n)
    assert bool(conv) and want_conv
    np.testing.assert_array_equal(choice.numpy(), want_choice)
    np.testing.assert_array_equal(cost.numpy(), want_cost)
    # the converged parse is the native DP's
    lens = dl[:n].copy()
    native.estimate_costs(lens, dd[:n].copy())
    np.testing.assert_array_equal(choice.numpy()[:n], lens)
    if data is not None:  # claims of parse_claims have no block bytes
        assert native.emit_block(data, choice.numpy()[:n].copy(), dd[:n]) \
            == native.emit_block(data, lens, dd[:n])


def _two_level_eval(choice, limit: int, n_end: int, tile: int):
    """numpy model of csrc/parse.cu's policy evaluation: (cost, entries,
    global rounds).  Each position's first jump and step as the reference
    computes them (a literal to i + 1 at 1 or 2 bytes by its run, a match
    to i + length, the tail i >= limit to itself at 0); each tile resolves
    its jumps until they leave it or rest in the tail; the first jumps
    that leave a tile below limit are the entries; synchronous pointer
    jumping over the entries only until every entry's exit is in the tail;
    then cost = sum to the exit + the exit's sum."""
    choice = np.asarray(choice, np.int64)
    N = choice.shape[0]
    idx = np.arange(N)
    term = idx >= limit
    lit = ((choice <= 1) | term) & (idx < n_end)
    stops = np.minimum.accumulate(np.where(lit, N, idx)[::-1])[::-1]
    num_lit = np.append(stops[1:], N) - idx  # to the next non-literal
    extra = (num_lit == 15) | ((num_lit >= 270)
                               & ((num_lit - 15) % 255 == 0))
    match = np.where(choice <= 18, 3, 4 + (choice - 19) // 255)
    step = np.where(term, 0, np.where(lit, 1 + extra, match))
    first = np.where(term, idx,
                     np.minimum(idx + np.where(lit, 1, choice), N - 1))
    tend = (idx // tile + 1) * tile
    ex, acc = first.copy(), step.copy()
    while True:  # inside the tiles
        inside = (ex < tend) & (ex < limit)
        if not inside.any():
            break
        acc, ex = (np.where(inside, acc + acc[ex], acc),
                   np.where(inside, ex[ex], ex))
    entries = np.unique(first[(first >= tend) & (first < limit)])
    rounds = 0
    while True:  # across the tiles
        e = entries[ex[entries] < limit]
        if not e.size:
            break
        x = ex[e]
        acc[e], ex[e] = acc[e] + acc[x], ex[x]
        rounds += 1
    return acc + np.where(ex < limit, acc[ex], 0), entries.size, rounds


def _policies(case: str):
    """(choice, n) pairs: for a CASES block or a parse_claims case the
    first policy (every clamped claim) and the converged one; for
    "random policy k" three seeded policies at N_SMALL whose matches reach
    4..18, 19..300 and 300..3,000 positions (across many model tiles)."""
    if case.startswith("random policy"):
        rng = np.random.default_rng(int(case.split()[-1]))
        out = []
        for _ in range(3):
            kind = rng.random(N_SMALL)
            choice = np.select(
                [kind < 0.5, kind < 0.75, kind < 0.92],
                [1, rng.integers(4, 19, N_SMALL),
                 rng.integers(19, 301, N_SMALL)],
                rng.integers(300, 3001, N_SMALL)).astype(np.int32)
            out.append((choice, int(rng.integers(N_SMALL - 600,
                                                 N_SMALL + 1))))
        return out
    dl, dd, n, _ = _inputs(case)
    lens, dists = torch.from_numpy(dl), torch.from_numpy(dd)
    first = parse._claims(lens, dists, n)[0].numpy()
    return [(first, n), (parse.estimate_costs_device(lens, dists, n)[0]
                         .numpy(), n)]


@pytest.mark.parametrize("case", list(CASES) + list(PARSE_CASES)
                         + [f"random policy {k}" for k in range(4)])
def test_two_level_model_equals_policy_eval(jparse, case):
    """The model of the kernel's evaluation equals the port's and the JAX
    package's _policy_eval exactly, at the model tile and the kernel's;
    its global rounds stay within log2 of the tiles (each entry hop
    crosses a tile edge)."""
    import jax.numpy as jnp

    for choice, n in _policies(case):
        limit = n - fmt.BLOCK_END_LITERALS
        want = parse._policy_eval(torch.from_numpy(choice), limit, n).numpy()
        np.testing.assert_array_equal(
            np.asarray(jparse._policy_eval(jnp.asarray(choice), limit, n)),
            want)
        for tile in (MODEL_TILE, PARSE_TILE):
            cost, entries, rounds = _two_level_eval(choice, limit, n, tile)
            np.testing.assert_array_equal(cost, want)
            tiles = -(-choice.shape[0] // tile)
            assert entries <= choice.shape[0]
            assert rounds <= max(1, int(np.ceil(np.log2(tiles))))


@pytest.mark.parametrize("max_iters", [1, 2, 3])
def test_round_cap_equals_reference(jparse, max_iters):
    """The mixed case takes 3 rounds: cut at 1 and 2, the outputs and the
    converged flag still equal the reference's."""
    dl, dd, n = _padded(CASES["mixed adversarial"])
    want_choice, want_cost, want_conv = _reference(jparse, dl, dd, n,
                                                   max_iters)
    choice, cost, conv, rounds = _port(dl, dd, n, max_iters)
    assert bool(conv) == want_conv == (max_iters >= 3)
    assert int(rounds) == max_iters
    np.testing.assert_array_equal(choice.numpy(), want_choice)
    np.testing.assert_array_equal(cost.numpy(), want_cost)


def test_zero_rounds_and_short_blocks():
    """max_iters 0 returns the first policy unconverged; blocks shorter than
    the literal tail are all literals at zero cost."""
    dl, dd, n = _padded(CASES["text"])
    choice, cost, conv, rounds = _port(dl, dd, n, 0)
    assert not bool(conv) and int(rounds) == 0
    L, _, _ = parse._claims(torch.from_numpy(dl), torch.from_numpy(dd), n)
    np.testing.assert_array_equal(choice.numpy(), L.numpy())
    for n in (0, 3, 5):
        choice, cost, conv, rounds = _port(np.full(16, 9, np.int32),
                                           np.ones(16, np.int32), n)
        assert bool(conv) and int(rounds) == 1
        assert (choice == 1).all() and (cost == 0).all()


@pytest.mark.parametrize("bad", ["dtype", "shape", "n", "max_iters"])
def test_estimate_costs_refuses_bad_inputs(bad):
    lens = torch.ones(64, dtype=torch.int32)
    dists = torch.zeros(64, dtype=torch.int32)
    n, max_iters = 64, 48
    if bad == "dtype":
        lens = lens.long()
    elif bad == "shape":
        dists = dists[:32]
    elif bad == "n":
        n = 65
    else:
        max_iters = -1
    with pytest.raises(ValueError):
        parse.estimate_costs_device(lens, dists, n, max_iters)


def _real_block(size: int) -> bytes:
    data = lzma.decompress((ROOT / "benchdata" / "realcorpus.bin.xz")
                           .read_bytes())
    return data[:size]


def _cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _kernel_equals_plain(dl, dd, n, max_iters=48):
    dev = _cuda_device()
    before = _cuda.LAUNCHES["parse"]
    got = _port(dl, dd, n, max_iters, dev)
    assert _cuda.LAUNCHES["parse"] == before + 1
    want = parse.policy_iteration_plain(torch.from_numpy(dl).to(dev),
                                        torch.from_numpy(dd).to(dev), n,
                                        max_iters)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_plain_cuda(case):
    dl, dd, n = _padded(CASES[case])
    choice = _kernel_equals_plain(dl, dd, n)[0]
    lens = dl[:n].copy()
    native.estimate_costs(lens, dd[:n].copy())
    np.testing.assert_array_equal(choice.cpu().numpy()[:n], lens)


@pytest.mark.cuda
@pytest.mark.parametrize("max_iters", [0, 1, 2, 3])
def test_kernel_round_cap_cuda(max_iters):
    dl, dd, n = _padded(CASES["mixed adversarial"])
    _, _, conv, rounds = _kernel_equals_plain(dl, dd, n, max_iters)
    assert bool(conv) == (max_iters >= 3) and int(rounds) == max_iters


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 3, 5, 16])
def test_kernel_short_blocks_cuda(n):
    """A grid of one partial tile: n = 16 takes matches at distance 1,
    blocks of at most 5 lie inside the literal tail (zero cost)."""
    lens = np.full(16, 9, np.int32)
    lens[-11:] = 1
    _, cost, conv, rounds = _kernel_equals_plain(lens, np.ones(16, np.int32),
                                                 n)
    assert bool(conv)
    if n <= 5:
        assert int(rounds) == 1 and not bool(cost.any())


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["realcorpus 1 MiB", "repeat 65535"])
def test_kernel_large_blocks_cuda(which):
    """A 1 MiB block of the real fixture's claims (and cut after one
    round), and a block holding a 65,535-long repeat of a 700-byte
    fragment, whose claims reach the table's deepest tiers."""
    if which == "repeat 65535":
        frag = np.random.default_rng(4).integers(0, 256, 700,
                                                 dtype=np.uint8).tobytes()
        data = (frag * 100)[:700 + 65535] + b"end of block" * 4
    else:
        data = _real_block(1 << 20)
    dl, dd = _claims(data)
    n = len(data)
    choice = _kernel_equals_plain(dl, dd, n)[0]
    lens = dl.copy()
    native.estimate_costs(lens, dd.copy())
    np.testing.assert_array_equal(choice.cpu().numpy(), lens)
    _kernel_equals_plain(dl, dd, n, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PARSE_CASES))
def test_kernel_worst_cases_cuda(case):
    """parse_claims' cases at phase 3e's sizes (4 MiB but for limit
    landing at 1 MiB and odd N at 2^20 + 777): claims landing on tile
    edges and on limit, every position an entry, seeded claims across
    many tiles; the converged choice equals native.estimate_costs (the
    periodic claims at 4 MiB take more than the 48 rounds of the cap)."""
    dl, dd, n = parse_claims(np, case, PARSE_CASES[case], seed=13)
    choice, _, conv, rounds = _kernel_equals_plain(dl, dd, n)
    if not bool(conv):
        assert int(rounds) == 48
        return
    lens = dl[:n].copy()
    native.estimate_costs(lens, dd[:n].copy())
    np.testing.assert_array_equal(choice.cpu().numpy()[:n], lens)


@pytest.mark.cuda
@pytest.mark.parametrize("max_iters", [1, 2])
def test_kernel_round_cap_4mib_cuda(max_iters):
    """The first 4 MiB block of the real fixture cut after one and after
    two improvements: unconverged, equal to the plain version."""
    _cuda_device()
    dl, dd = _claims(_real_block(4 << 20))
    _, _, conv, rounds = _kernel_equals_plain(dl, dd, len(dl), max_iters)
    assert not bool(conv) and int(rounds) == max_iters


@pytest.mark.cuda
def test_kernel_one_launch_cuda():
    """One device launch of the kernel a call (torch.profiler)."""
    from chip_smoke import device_ms

    dev = _cuda_device()
    dl, dd, n = _padded(CASES["mixed adversarial"])
    lens, dists = (torch.from_numpy(a).to(dev) for a in (dl, dd))
    _, per_call = device_ms(torch, lambda: parse.estimate_costs_device(
        lens, dists, n), 3, name="parse")
    assert per_call == 1
