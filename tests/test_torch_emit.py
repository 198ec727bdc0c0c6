"""The device sequence emit of the port (smallz4_tpu_torch/ops/emit.py).

``emit_block_device`` (PyTorch tensor ops) on the CPU must equal the JAX
package's ``emit_block_device`` (jit on the CPU) over all its output bytes
and ``native.emit_block`` over the payload, byte for byte, on the cases of
tests/test_emit.py: text, all literals, literal runs and match lengths whose
extensions chain through 255s, adjacent matches, mixed data and tiny
blocks; the payload must decode back to the block.  A test marked ``cuda``
runs it on the card against the CPU.
"""
import numpy as np
import pytest
import torch

from smallz4_tpu_torch import format as fmt
from smallz4_tpu_torch import native
from smallz4_tpu_torch.ops import emit


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


def _port(data, lens, dists, device="cpu"):
    block = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    out, n_out = emit.emit_block_device(
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
