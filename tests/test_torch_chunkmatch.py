"""PyTorch port of the chunk-merge match search
(smallz4_tpu_torch/ops/chunkmatch.py).

The port's plain path must return the reference's arrays bit for bit on
the same numpy inputs: records, the sorted chunk, probe_pair's four outputs
(with the boundary cut live and not), the packed results and the batched
match_chunks against the reference's stepwise scan.  The reference
(smallz4_tpu/ops/chunkmatch.py) runs its Pallas kernels in interpret mode
at C = 1024.  Tests marked ``cuda`` hold the CUDA kernels against the plain
versions and skip without a card.
"""
import numpy as np
import pytest
import torch

from smallz4_tpu_torch import format as fmt
from smallz4_tpu_torch import native
from smallz4_tpu_torch.ops import chunkmatch as tcm

C = 1024   # test chunk size
N_CHUNKS = 5


def _corpus(seed, n):
    """Text-like runs, byte runs, noise and long repeats: every certificate
    path fires at C = 1024."""
    rng = np.random.default_rng(seed)
    parts = []
    while sum(map(len, parts)) < n:
        r = rng.random()
        if r < 0.25:
            parts.append(bytes(rng.integers(0, 256, 150, dtype=np.uint8)))
        elif r < 0.55:
            parts.append(bytes(rng.integers(97, 101, 250, dtype=np.uint8)))
        elif r < 0.8 and parts:
            parts.append(parts[rng.integers(0, len(parts))])
        else:
            parts.append(bytes([int(rng.integers(0, 256))])
                         * int(rng.integers(5, 300)))
    return b"".join(parts)[:n]


def _padded(data=None):
    if data is None:
        data = _corpus(11, N_CHUNKS * C)
    padded = np.zeros(len(data) + tcm.LOOK, np.uint8)
    padded[: len(data)] = np.frombuffer(data, np.uint8)
    return data, padded


def _chunk_buf(padded, ci, chunk=C):
    return padded[ci * chunk: ci * chunk + chunk + tcm.LOOK]


def _hi(n, ci, chunk=C):
    return min(chunk, n - fmt.BLOCK_END_NO_MATCH + 1 - ci * chunk)


def _cut(padded, ci, chunk=C):
    """Boundary cut at the end of chunk ci-1 (halo-local coords)."""
    pos = chunk - fmt.BLOCK_END_NO_MATCH
    start = (ci - 1) * chunk + pos
    return tcm.pack_cut_gram(padded[start: start + 4].tobytes()), pos


CUTS = {"cut_off": lambda padded: (0, -1), "cut_live": lambda p: _cut(p, 1)}


@pytest.fixture(scope="module")
def ref():
    """Reference outputs (interpret mode), computed once per module."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from smallz4_tpu.ops import chunkmatch as cm

    assert cm.LOOK == tcm.LOOK and cm.PROBES == tcm.PROBES
    data, padded = _padded()
    n = len(data)
    i32 = jnp.int32
    out = {}
    with pltpu.force_tpu_interpret_mode():
        out["records"] = cm.make_records(
            jnp.asarray(_chunk_buf(padded, 0)), i32(3), i32(C - 100), chunk=C)
        out["sorted"] = [cm.sort_chunk(jnp.asarray(_chunk_buf(padded, ci)),
                                       i32(0), i32(_hi(n, ci)), chunk=C)
                         for ci in range(N_CHUNKS)]
        out["empty_halo"] = cm.empty_halo(chunk=C)
        limit = n - fmt.BLOCK_END_LITERALS - C
        for name, cut in CUTS.items():
            cg, cp = cut(padded)
            out["probe_" + name] = cm.probe_pair(
                out["sorted"][0], out["sorted"][1], i32(cg), i32(cp), i32(0),
                i32(_hi(n, 1)), i32(limit), chunk=C)
        out["pack"] = cm.pack_results(*out["probe_cut_off"], chunk=C)
        G = N_CHUNKS - 1
        cand = np.array([_hi(n, ci) for ci in range(1, N_CHUNKS)], np.int32)
        lim = np.array([n - fmt.BLOCK_END_LITERALS - ci * C
                        for ci in range(1, N_CHUNKS)], np.int32)
        bufs = np.stack([_chunk_buf(padded, ci) for ci in range(1, N_CHUNKS)])
        cg, cp = _cut(padded, 1)
        out["scan_in"] = (bufs, cand, lim, cg, cp)
        out["scan"] = cm.match_chunks(
            out["sorted"][0], jnp.asarray(bufs), jnp.asarray(cand),
            jnp.asarray(cand), jnp.asarray(lim), i32(cg), i32(cp),
            n_chunks=G, head_cap=C, chunk=C)
    out = jax.tree_util.tree_map(np.asarray, out)
    jax.clear_caches()
    return out


def test_make_records_equals_reference(ref):
    _, padded = _padded()
    got = tcm.make_records(torch.from_numpy(_chunk_buf(padded, 0)), 3,
                           C - 100, chunk=C)
    assert got.dtype == torch.int32 and got.shape == (6, C)
    assert torch.equal(got, tcm.planes_from_reference(ref["records"]))


@pytest.mark.parametrize("ci", range(N_CHUNKS))
def test_sort_chunk_equals_reference(ref, ci):
    data, padded = _padded()
    bufs = torch.from_numpy(np.stack([_chunk_buf(padded, c)
                                      for c in range(N_CHUNKS)]))
    his = [_hi(len(data), c) for c in range(N_CHUNKS)]
    got = tcm.sort_chunk(bufs, 0, torch.tensor(his, dtype=torch.int32),
                         chunk=C)
    assert torch.equal(got[ci], tcm.planes_from_reference(ref["sorted"][ci]))


def test_empty_halo_equals_reference(ref):
    assert torch.equal(tcm.empty_halo(chunk=C),
                       tcm.planes_from_reference(ref["empty_halo"]))


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_probe_pair_equals_reference(ref, cut):
    """lens, dists, conv and lk, with the reference's sorted records fed in
    through planes_from_reference (the halo carry)."""
    data, padded = _padded()
    n = len(data)
    cg, cp = CUTS[cut](padded)
    halo, cur = (tcm.planes_from_reference(p) for p in ref["sorted"][:2])
    got = tcm.probe_pair(halo, cur, cg, cp, 0, _hi(n, 1),
                         n - fmt.BLOCK_END_LITERALS - C, chunk=C)
    want = ref["probe_" + cut]
    for g, w, name in zip(got, want, ("lens", "dists", "conv", "lk")):
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype),
                                      err_msg=name)
    assert want[2].sum() > C // 4  # the certificates are not vacuous


def test_boundary_cut_changes_claims(ref):
    """The live cut must actually remove candidates on this corpus (else
    the cut_live case above proves nothing)."""
    off, live = ref["probe_cut_off"], ref["probe_cut_live"]
    assert any((a != b).any() for a, b in zip(off, live))


def test_pack_results_equals_reference(ref):
    lens, dists, conv, lk = (torch.from_numpy(a.astype(t)) for a, t in zip(
        ref["probe_cut_off"], (np.int32, np.int32, bool, bool)))
    bits, packed, count, cbits, kbits = tcm.pack_results(
        lens[None], dists[None], conv[None], lk[None], chunk=C)
    w_bits, w_packed, w_count, w_cbits, w_kbits = ref["pack"]
    cnt = int(w_count)
    assert int(count[0]) == cnt
    np.testing.assert_array_equal(packed[0, :cnt].numpy(), w_packed[:cnt])
    np.testing.assert_array_equal(bits[0].numpy(), w_bits)
    np.testing.assert_array_equal(cbits[0].numpy(), w_cbits)
    np.testing.assert_array_equal(kbits[0].numpy(), w_kbits)


def test_match_chunks_equals_reference_scan(ref):
    """One batched call over G chunks equals the reference's scan: packed
    results per chunk and the carried halo."""
    bufs, cand, lim, cg, cp = ref["scan_in"]
    G = len(cand)
    halo = tcm.planes_from_reference(ref["sorted"][0])
    nxt, (bits, packed, count, cbits, kbits) = tcm.match_chunks(
        halo, torch.from_numpy(bufs), torch.from_numpy(cand),
        torch.from_numpy(cand), torch.from_numpy(lim), cg, cp,
        n_chunks=G, head_cap=C, chunk=C)
    w_halo, (w_bits, w_packed, w_count, w_cbits, w_kbits) = ref["scan"]
    for a, b in zip(tcm.planes_to_reference(nxt), w_halo):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(count.numpy(), w_count)
    np.testing.assert_array_equal(bits.numpy(), w_bits)
    np.testing.assert_array_equal(cbits.numpy(), w_cbits)
    np.testing.assert_array_equal(kbits.numpy(), w_kbits)
    for j in range(G):
        cnt = int(w_count[j])
        np.testing.assert_array_equal(packed[j, :cnt].numpy(),
                                      w_packed[j, :cnt])


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_planes_roundtrip_bit_for_bit(dtype):
    rng = np.random.default_rng(2)
    planes = tuple(rng.integers(0, 1 << 32, (3, 64), dtype=np.uint64)
                   .astype(np.uint32).view(dtype) for _ in range(6))
    t = tcm.planes_from_reference(planes)
    assert t.dtype == torch.int32 and t.shape == (3, 6, 64)
    back = tcm.planes_to_reference(t)
    for a, b in zip(back, planes):
        assert a.dtype == np.uint32
        np.testing.assert_array_equal(a, b.view(np.uint32))


def _claims(seed, n):
    """Realistic claims: matches with decay interiors, literals, and a
    saturated run."""
    rng = np.random.default_rng(seed)
    lens = np.ones(n, np.int32)
    dists = np.zeros(n, np.int32)
    i = 0
    while i < n:
        if rng.random() < 0.4:
            L = int(rng.integers(4, 60))
            d = int(rng.integers(1, 500))
            for k in range(min(int(rng.integers(1, L + 3)), n - i)):
                lens[i + k] = L - k if L - k >= 4 else 1
                dists[i + k] = d if L - k >= 4 else 0
            i += L
        else:
            i += int(rng.integers(1, 8))
    lens[n // 2: n // 2 + 40] = 65535
    dists[n // 2: n // 2 + 40] = 1
    conv = rng.random(n) < 0.8
    return lens, dists, conv, conv | (rng.random(n) < 0.5)


def test_pack_plain_inverts_with_native_unpack():
    """Plain pack over two rows; the host's native.unpack_claims and the
    copied numpy unpack_rows / unpack_bits_rows invert it exactly."""
    rows = [_claims(s, C) for s in (4, 5)]
    t = [torch.from_numpy(np.stack([r[i] for r in rows])) for i in range(4)]
    bits, packed, count, cbits, kbits = tcm.pack_results(*t, chunk=C)
    l2, d2 = tcm.unpack_rows(bits.numpy(), packed.numpy(), chunk=C)
    for j, (lens, dists, conv, lk) in enumerate(rows):
        cnt = int(count[j])
        assert 0 < cnt < C
        assert (packed[j, cnt:] == 0).all()
        l3, d3 = native.unpack_claims(bits[j].numpy(), packed[j, :cnt].numpy(),
                                      C)
        np.testing.assert_array_equal(l3, lens)
        np.testing.assert_array_equal(d3, dists)
        np.testing.assert_array_equal(l2[j], lens)
        np.testing.assert_array_equal(d2[j], dists)
    np.testing.assert_array_equal(tcm.unpack_bits_rows(cbits.numpy(), C),
                                  np.stack([r[2] for r in rows]))
    np.testing.assert_array_equal(tcm.unpack_bits_rows(kbits.numpy(), C),
                                  np.stack([r[3] for r in rows]))


def test_compact_plain_keeps_current_chunk_in_position_order():
    rng = np.random.default_rng(6)
    n = 2 * C
    local = rng.permutation(C).astype(np.int32)
    key = np.full(n, 16 * C, np.int32)
    slots = np.sort(rng.choice(n, C, replace=False))
    key[slots] = (local << 4) | rng.integers(0, 16, C, dtype=np.int32)
    pay = rng.integers(-1 << 31, 1 << 31, n, dtype=np.int64).astype(np.int32)
    okey, opay = tcm.compact(torch.from_numpy(key)[None],
                             torch.from_numpy(pay)[None], C)
    np.testing.assert_array_equal(okey[0].numpy() >> 4, np.arange(C))
    want = np.empty(C, np.int32)
    want[local] = pay[slots]
    np.testing.assert_array_equal(opay[0].numpy(), want)


def test_verify_words_7_not_implemented(monkeypatch):
    monkeypatch.setattr(tcm, "VERIFY_WORDS", 7)
    with pytest.raises(NotImplementedError, match="VERIFY_WORDS"):
        tcm.make_records(torch.zeros(C + tcm.LOOK, dtype=torch.uint8), 0, C,
                         chunk=C)


@pytest.mark.parametrize("text", ["8,16", "16,12", "12,2000", "x"])
def test_far_probes_validated(text):
    """The parser takes every comma list of positive offsets, as the
    reference does; the CUDA probe's check refuses the sets beyond
    csrc/probe.cu (an offset at or below EDGE, a set that does not
    increase, an offset above MAX_FAR_PROBE) and names the set."""
    if text == "x":
        with pytest.raises(ValueError, match="positive integers"):
            tcm._far_probes(text)
        return
    far = tcm._far_probes(text)
    assert far == tuple(int(v) for v in text.split(","))
    with pytest.raises(ValueError, match=text):
        tcm._check_kernel_probes(tcm.NEAR_PROBES + far)


@pytest.mark.parametrize("text", ["12,,16", "0", "12,-4", "1.5", "12,", " "])
def test_far_probes_refuses_non_positive_or_empty_items(text):
    with pytest.raises(ValueError, match="positive integers"):
        tcm._far_probes(text)


def test_far_probes_default_and_override():
    assert tcm._far_probes(None) == (12, 16, 24, 32, 48, 64, 96, 128, 160)
    assert tcm._far_probes("") == tcm._far_probes(None)
    assert tcm._far_probes("12,40") == (12, 40)
    assert tcm._far_probes("2000,12,12") == (2000, 12, 12)
    assert len(tcm._far_probes(",".join(map(str, range(9, 60))))) == 51


@pytest.mark.parametrize("far", [(), (12, 16, 24, 32, 48, 64, 96, 128, 160),
                                 (100,), tuple(range(9, 33)),
                                 (12, 16, 160, tcm.MAX_FAR_PROBE)], ids=str)
def test_kernel_probe_sets_accepted(far):
    tcm._check_kernel_probes(tcm.NEAR_PROBES + far)


@pytest.mark.parametrize("far", [(16, 12, 64), (12, 2000), tuple(range(9, 34)),
                                 (8, 16), (12, 12)], ids=str)
def test_probe_refuses_kernel_sets_only_on_cuda(monkeypatch, far):
    """probe() on a set beyond csrc/probe.cu: on the CPU the plain version
    runs; a CUDA tensor (the device check mocked) raises a ValueError that
    names the set, at the call, before any launch and without running the
    plain version."""
    monkeypatch.setattr(tcm, "PROBES", tcm.NEAR_PROBES + far)
    stages = _plain_stages(B=1)
    merged, gram, pos, lim, _ = stages
    want = tcm.probe_plain(merged, gram, pos, lim, C)
    got = tcm.probe(merged, gram, pos, lim, C)
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    def never(*args, **kwargs):
        raise AssertionError("must not run on the CUDA route")

    monkeypatch.setattr(tcm._cuda, "on_cuda", lambda t: True)
    monkeypatch.setattr(tcm._cuda, "launch", never)
    monkeypatch.setattr(tcm, "probe_plain", never)
    with pytest.raises(ValueError, match=",".join(map(str, far))):
        tcm.probe(merged, gram, pos, lim, C)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plain_stages(B=4, cut_rows=(0,), data=None, chunk=C, device="cpu"):
    """Intermediates of a B-chunk group (chunks 1..B of ``data``, chunk 0
    the halo) for the kernels: merged records sorted by their keys, and the
    per-row cut gram, cut position, match limit and candidate bound.  The
    sort and merge run on ``device``."""
    data, padded = _padded(data)
    n = len(data)
    bufs = torch.from_numpy(np.stack([_chunk_buf(padded, c, chunk)
                                      for c in range(1, B + 1)]))
    cand = torch.tensor([_hi(n, c, chunk) for c in range(1, B + 1)],
                        dtype=torch.int32)
    lim = torch.tensor([n - fmt.BLOCK_END_LITERALS - c * chunk
                        for c in range(1, B + 1)], dtype=torch.int32)
    cg, cp = _cut(padded, 1, chunk)
    gram = torch.tensor([cg if r in cut_rows else 0 for r in range(B)],
                        dtype=torch.int32)
    pos = torch.tensor([cp if r in cut_rows else -1 for r in range(B)],
                       dtype=torch.int32)
    halo = tcm.sort_chunk(torch.from_numpy(_chunk_buf(padded, 0, chunk))
                          .to(device), 0, chunk, chunk=chunk)
    cur = tcm.sort_chunk(bufs.to(device), 0, cand.to(device), chunk=chunk)
    halos = torch.cat([halo[None], cur[:-1]])
    merged = tcm.sortnet.merge_sorted(tcm._merged_input(halos, cur, chunk),
                                      n_keys=6, unique=True)
    return (merged,) + tuple(t.to(device) for t in (gram, pos, lim, cand))


def _few_symbols(n=N_CHUNKS * C):
    """Two symbols with long periodic stretches: many records tie on the
    whole 20-byte key."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2, n, dtype=np.uint8)
    x[n // 4: n // 2] = np.tile(np.array([0, 1, 1], np.uint8), n)[:n // 4]
    x[n // 2: n // 2 + n // 8] = 1
    return x.tobytes()


STAGE_DATA = {"corpus": None, "few_symbols": _few_symbols()}


@pytest.mark.parametrize("data", sorted(STAGE_DATA))
def test_probe_lcp_composed_equals_direct(data):
    """On merged records sorted by their 20-byte key, the LCP with the
    record at +-k (every offset of PROBES) is the least adjacent LCP over
    the window between them: what the CUDA probe computes from its
    min-table equals probe_plain's direct compare."""
    merged = _plain_stages(data=STAGE_DATA[data])[0]
    n = merged.shape[-1]
    w = [merged[:, i] for i in range(5)]
    adj = tcm._lcp_be([x[:, :-1] ^ x[:, 1:] for x in w])
    ties = 0
    for k in tcm.PROBES:
        for sgn in (1, -1):
            # slots s with s + sgn*k in range; window a[min(s, s+sgn*k) ..)
            slots = torch.arange(k, n) if sgn < 0 else torch.arange(n - k)
            nb = slots + sgn * k
            direct = tcm._lcp_be([x[:, slots] ^ x[:, nb] for x in w])
            composed = adj.unfold(1, k, 1).min(-1).values
            assert torch.equal(composed, direct), (k, sgn)
        ties += int((direct == tcm.KEY_REACH).sum())
    assert ties > 0  # the windows cover groups of equal keys


@pytest.mark.parametrize("data", sorted(STAGE_DATA))
def test_merged_combo_bit29_clear(data):
    """The merged records' combo is invalid bit 31 | pos bits 0-16: bit 29,
    where the reference puts a record's own cut test, and bit 17, where the
    CUDA probe's derived word marks a record that is no candidate, are
    clear."""
    merged = _plain_stages(data=STAGE_DATA[data])[0]
    assert not ((merged[:, 5] >> 29) & 1).any()
    assert ((merged[:, 5] & ~(tcm.INVALID_BIT | tcm.POS_MASK)) == 0).all()


@pytest.mark.cuda
def test_probe_compact_pack_kernels_equal_plain_cuda():
    dev = _cuda_or_skip()
    merged, gram, pos, lim, cand = (t.to(dev) for t in _plain_stages())
    pay, key = tcm.probe(merged, gram, pos, lim, C)
    w_pay, w_key = tcm.probe_plain(merged, gram, pos, lim, C)
    torch.cuda.synchronize()
    assert torch.equal(pay, w_pay) and torch.equal(key, w_key)
    okey, opay = tcm.compact(key, pay, C)
    w_okey, w_opay = tcm.compact_plain(key, pay, C)
    assert torch.equal(okey, w_okey) and torch.equal(opay, w_opay)
    claims = tcm._claims(okey, opay, pos, torch.zeros_like(cand), cand, lim, C)
    got = tcm.pack_results(*claims, chunk=C)
    want = tcm.pack_results_plain(*claims, chunk=C)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _probe_equals_plain(stages):
    merged, gram, pos, lim, _ = stages
    got = tcm.probe(merged, gram, pos, lim, merged.shape[-1] // 2)
    want = tcm.probe_plain(merged, gram, pos, lim, merged.shape[-1] // 2)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# far probes after the near 1..8: none, one (not a power of two), and the
# largest halo MAX_FAR_PROBE
FAR_SETS = {"near_only": (), "one_far": (100,),
            "far_1024": (12, 16, 160, tcm.MAX_FAR_PROBE)}


@pytest.mark.cuda
@pytest.mark.parametrize("far", sorted(FAR_SETS))
def test_probe_kernel_probe_sets_cuda(monkeypatch, far):
    dev = _cuda_or_skip()
    monkeypatch.setattr(tcm, "PROBES", tcm.NEAR_PROBES + FAR_SETS[far])
    _probe_equals_plain(_plain_stages(device=dev))


# constant bytes (every key LCP 20), few symbols (ties), one row, every
# row cut
PROBE_CASES = {"constant": dict(data=b"a" * (N_CHUNKS * C)),
               "few_symbols": dict(data=_few_symbols()),
               "one_row": dict(B=1),
               "all_cut": dict(cut_rows=range(4))}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probe_kernel_inputs_cuda(case):
    dev = _cuda_or_skip()
    _probe_equals_plain(_plain_stages(device=dev, **PROBE_CASES[case]))


@pytest.mark.cuda
def test_probe_kernel_production_shape_cuda():
    """[8, 6, 131072]: eight 64 Ki chunks of make_corpus, sorted and merged
    on the card, a live cut in row 0."""
    dev = _cuda_or_skip()
    from bench import make_corpus

    stages = _plain_stages(B=8, data=make_corpus(9 * tcm.CHUNK),
                           chunk=tcm.CHUNK, device=dev)
    assert stages[0].shape == (8, 6, 2 * tcm.CHUNK)
    _probe_equals_plain(stages)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [C, tcm.CHUNK], ids=str)
def test_claims_chain_kernel_cuda(chunk):
    """_claims runs its same-distance doubling through the chain kernel
    (one launch) and equals the CPU's tensor passes, at the test chunk and
    at the production chunk of 65,536 positions."""
    dev = _cuda_or_skip()
    data = None
    if chunk != C:
        from bench import make_corpus

        data = make_corpus(5 * chunk)
    merged, gram, pos, lim, cand = _plain_stages(data=data, chunk=chunk,
                                                 device=dev)
    pay, key = tcm.probe(merged, gram, pos, lim, chunk)
    okey, opay = tcm.compact(key, pay, chunk)
    args = (okey, opay, pos, torch.zeros_like(cand), cand, lim, chunk)
    want = tcm._claims(*(a.cpu() if torch.is_tensor(a) else a
                         for a in args))
    before = dict(tcm._cuda.LAUNCHES)
    got = tcm._claims(*args)
    torch.cuda.synchronize()
    assert tcm._cuda.LAUNCHES["chain"] == before["chain"] + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_match_chunks_cuda_equals_cpu():
    dev = _cuda_or_skip()
    data, padded = _padded()
    n = len(data)
    G = N_CHUNKS - 1
    bufs = np.stack([_chunk_buf(padded, c) for c in range(1, N_CHUNKS)])
    cand = np.array([_hi(n, c) for c in range(1, N_CHUNKS)], np.int32)
    lim = np.array([n - fmt.BLOCK_END_LITERALS - c * C
                    for c in range(1, N_CHUNKS)], np.int32)
    cg, cp = _cut(padded, 1)
    halo = tcm.sort_chunk(torch.from_numpy(_chunk_buf(padded, 0)), 0, C,
                          chunk=C)
    args = (torch.from_numpy(bufs), torch.from_numpy(cand),
            torch.from_numpy(cand), torch.from_numpy(lim))
    want = tcm.match_chunks(halo, *args, cg, cp, n_chunks=G, head_cap=C,
                            chunk=C)
    got = tcm.match_chunks(halo.to(dev), *(a.to(dev) for a in args), cg, cp,
                           n_chunks=G, head_cap=C, chunk=C)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g.cpu(), w)
