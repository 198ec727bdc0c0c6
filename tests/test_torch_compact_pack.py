"""The chunk engine's compaction and head/delta pack on their worst cases
(smallz4_tpu_torch/ops/chunkmatch.py ``compact``, ``pack_results``;
kernels csrc/compact.cu and csrc/pack.cu).

The rows come from ``chip_smoke.compact_rows`` and ``chip_smoke.pack_rows``
(numpy, seeded): current records all ahead of the halo's, all behind it,
or interleaved at random; every position a head, slot 0 the only head, or
heads only in the row's last eighth, with conv and lk random, all ones or
all zeros.  On the CPU the plain versions must equal the JAX package
bit for bit (tolerance 0) at C = 1024: compaction against
``_pallas_planes(_compact_kernel)`` and the 1-key ``sort_records`` unsort
that follows it in ``probe_pair``, the pack against ``pack_results``, both
in interpret mode.  Tests marked ``cuda`` hold the kernels against the
plain versions (exact) at C = 1024 and [64, 65536], B = 1, odd and
unaligned shapes, and count one device launch a call.
"""
import functools
import types

import numpy as np
import pytest
import torch

from chip_smoke import (COMPACT_ORDERS, PACK_CASES, compact_rows,
                        device_ms, pack_rows)
from smallz4_tpu_torch.ops import _cuda
from smallz4_tpu_torch.ops import chunkmatch as tcm

C = 1024   # test chunk size
ROWS = 2   # rows a reference case


@pytest.fixture(scope="module")
def ref():
    """The JAX package's compaction + unsort and pack, in interpret mode,
    on every worst-case row at C = 1024, computed once per module."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from smallz4_tpu.ops import chunkmatch as cm
    from smallz4_tpu.ops import sortnet

    @jax.jit
    def compact_unsort(key, pay):
        c_key, c_pay = cm._pallas_planes(
            functools.partial(cm._compact_kernel, C), [key, pay], 2)
        return sortnet.sort_records(c_key[:C].view(jnp.uint32), c_pay[:C],
                                    n_keys=1, unique=True)

    out = {}
    with pltpu.force_tpu_interpret_mode():
        for seed, order in enumerate(COMPACT_ORDERS):
            key, pay = compact_rows(np, ROWS, C, order, seed)
            out[order] = [compact_unsort(jnp.asarray(k), jnp.asarray(p))
                          for k, p in zip(key, pay)]
        for seed, case in enumerate(PACK_CASES):
            rows = pack_rows(np, ROWS, C, case, seed)
            out[case] = [cm.pack_results(*(jnp.asarray(a[j]) for a in rows),
                                         chunk=C) for j in range(ROWS)]
    out = jax.tree_util.tree_map(np.asarray, out)
    jax.clear_caches()
    return out


@pytest.mark.parametrize("order", COMPACT_ORDERS)
def test_compact_plain_equals_reference(ref, order):
    key, pay = compact_rows(np, ROWS, C, order, COMPACT_ORDERS.index(order))
    okey, opay = tcm.compact(torch.from_numpy(key), torch.from_numpy(pay), C)
    for j, (w_key, w_pay) in enumerate(ref[order]):
        np.testing.assert_array_equal(okey[j].numpy(), w_key.view(np.int32))
        np.testing.assert_array_equal(opay[j].numpy(), w_pay)
    np.testing.assert_array_equal(okey.numpy() >> 4,
                                  np.tile(np.arange(C), (ROWS, 1)))


@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_plain_equals_reference(ref, case):
    rows = pack_rows(np, ROWS, C, case, PACK_CASES.index(case))
    bits, packed, count, cbits, kbits = tcm.pack_results(
        *map(torch.from_numpy, rows), chunk=C)
    want_count = {"every head": C, "slot 0 only": 1,
                  "last tile only": 1 + C // 8}[case]
    for j, (w_bits, w_packed, w_count, w_cbits, w_kbits) in enumerate(
            ref[case]):
        cnt = int(w_count)
        assert int(count[j]) == cnt == want_count
        np.testing.assert_array_equal(packed[j, :cnt].numpy(), w_packed[:cnt])
        assert not packed[j, cnt:].any()  # the port zeros the tail
        np.testing.assert_array_equal(bits[j].numpy(), w_bits)
        np.testing.assert_array_equal(cbits[j].numpy(), w_cbits)
        np.testing.assert_array_equal(kbits[j].numpy(), w_kbits)


def _never(*args, **kwargs):
    raise AssertionError("must not run on the CUDA route")


#: the limits csrc/compact.cu and csrc/pack.cu export (chunk, rows)
LIMITS = {"compact": (1 << 16, 65535), "pack": (1 << 16, 65535)}
_LIB = types.SimpleNamespace(**{
    f"s4_{k}_max_{what}": (lambda v=v: v) for k, lim in LIMITS.items()
    for what, v in zip(("chunk", "rows"), lim)})

# (kernel, B, chunk, n or None): shapes outside csrc/compact.cu and pack.cu
REFUSED = [("compact", 1, 1 << 17, None), ("compact", 1, 0, None),
           ("compact", 2, 1024, 2047), ("compact", 65536, 1, None),
           ("pack", 1, 1 << 17, None), ("pack", 65536, 32, None)]


@pytest.mark.parametrize("kernel,B,chunk,n", REFUSED, ids=str)
def test_kernels_refuse_shapes_outside_design(monkeypatch, kernel, B, chunk,
                                              n):
    """A CUDA tensor (the device check and the library's limits mocked) of
    a shape the kernels do not take raises a ValueError that names the
    limit, at the call, before any launch and without running the plain
    version."""
    monkeypatch.setattr(_cuda, "on_cuda", lambda t: True)
    monkeypatch.setattr(_cuda, "lib", lambda: _LIB)
    monkeypatch.setattr(_cuda, "launch", _never)
    monkeypatch.setattr(tcm, "compact_plain", _never)
    monkeypatch.setattr(tcm, "pack_results_plain", _never)
    if kernel == "compact":
        key = torch.zeros(B, 2 * chunk if n is None else n, dtype=torch.int32)
        with pytest.raises(ValueError, match="compact"):
            tcm.compact(key, key, chunk)
    else:
        lens = torch.zeros(B, chunk, dtype=torch.int32)
        flag = torch.zeros(B, chunk, dtype=torch.bool)
        with pytest.raises(ValueError, match=f"chunk from 32 to {1 << 16}"
                           if B == 1 else "rows"):
            tcm.pack_results(lens, lens, flag, flag, chunk=chunk)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(LIMITS))
def test_kernel_limits_cuda(kernel):
    """The built library exports the limits the refusal test assumes."""
    _cuda_or_skip()
    lib = _cuda.lib()
    assert (getattr(lib, f"s4_{kernel}_max_chunk")(),
            getattr(lib, f"s4_{kernel}_max_rows")()) == LIMITS[kernel]


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x that starts one element past its allocation,
    off 16-byte alignment (the compaction's scalar path; the pack's wrapper
    copies such a view before its launch)."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


# (B, chunk, order, unaligned)
COMPACT_CUDA = ([(64, 1 << 16, o, False) for o in COMPACT_ORDERS]
                + [(4, C, "interleaved", False),
                   (1, 1 << 16, "interleaved", False),
                   (1, 1, "interleaved", False),
                   (3, 5000, "halo first", False),
                   (2, 65535, "interleaved", False),
                   (2, C, "interleaved", True)])


@pytest.mark.cuda
@pytest.mark.parametrize("B,chunk,order,unaligned", COMPACT_CUDA, ids=str)
def test_compact_kernel_equals_plain_cuda(B, chunk, order, unaligned):
    dev = _cuda_or_skip()
    key, pay = (torch.from_numpy(a).to(dev)
                for a in compact_rows(np, B, chunk, order, B + chunk))
    if unaligned:
        key, pay = _unaligned(key), _unaligned(pay)
    before = dict(_cuda.LAUNCHES)
    got = tcm.compact(key, pay, chunk)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["compact"] == before["compact"] + 1
    for g, w in zip(got, tcm.compact_plain(key, pay, chunk)):
        assert torch.equal(g, w)


# (B, chunk, case, unaligned)
PACK_CUDA = ([(64, 1 << 16, c, False) for c in PACK_CASES]
             + [(1, 1 << 16, "every head", False)]
             + [(2, ch, c, False) for ch in (32, 96, C) for c in PACK_CASES]
             + [(3, 65504, "last tile only", False),
                (2, C, "every head", True)])


@pytest.mark.cuda
@pytest.mark.parametrize("B,chunk,case,unaligned", PACK_CUDA, ids=str)
def test_pack_kernel_equals_plain_cuda(B, chunk, case, unaligned):
    dev = _cuda_or_skip()
    rows = [torch.from_numpy(a).to(dev)
            for a in pack_rows(np, B, chunk, case, B + chunk)]
    if unaligned:
        rows = [_unaligned(a) for a in rows]
    before = dict(_cuda.LAUNCHES)
    got = tcm.pack_results(*rows, chunk=chunk)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["pack"] == before["pack"] + 1
    for g, w in zip(got, tcm.pack_results_plain(*rows, chunk=chunk)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["compact", "pack"])
def test_kernels_one_device_launch_cuda(kernel):
    """At the production shape [64, 65536] a call is one device launch
    (torch.profiler) and one count on the wrapper."""
    dev = _cuda_or_skip()
    if kernel == "compact":
        args = [torch.from_numpy(a).to(dev) for a in
                compact_rows(np, 64, 1 << 16, "interleaved", 3)]

        def call():
            return tcm.compact(*args, 1 << 16)
    else:
        args = [torch.from_numpy(a).to(dev) for a in
                pack_rows(np, 64, 1 << 16, "every head", 3)]

        def call():
            return tcm.pack_results(*args, chunk=1 << 16)
    before = _cuda.LAUNCHES[kernel]
    _, per_call = device_ms(torch, call, 5)
    assert per_call == 1
    assert _cuda.LAUNCHES[kernel] > before
