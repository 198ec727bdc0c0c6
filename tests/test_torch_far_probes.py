"""Far probe sets that the reference takes and csrc/probe.cu does not.

``SMALLZ4_TPU_FAR_PROBES`` is read when both ``chunkmatch`` modules are
imported, so each set runs in a subprocess with the variable set for the
reference and the port alike.  There the port's plain ``probe_pair`` (the
CPU route) must return the reference's four arrays, with the reference's
Pallas kernels in interpret mode at C = 1024, on the corpus of
tests/test_torch_chunkmatch.py, with the boundary cut live and not.  The
sets: an offset above MAX_FAR_PROBE (2,000 of the 2,048 merged slots) and a
set that does not increase.
"""
import os
import pathlib
import subprocess
import sys

import pytest

TESTS = pathlib.Path(__file__).resolve().parent

SCRIPT = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

jax.config.update("jax_platforms", "cpu")
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import test_torch_chunkmatch as base
from smallz4_tpu.ops import chunkmatch as cm
from smallz4_tpu_torch import format as fmt
from smallz4_tpu_torch.ops import chunkmatch as tcm

far = tuple(int(v) for v in sys.argv[3].split(","))
assert cm.PROBES == tcm.PROBES == tcm.NEAR_PROBES + far, (cm.PROBES, far)
C = base.C
data, padded = base._padded()
n = len(data)
limit = n - fmt.BLOCK_END_LITERALS - C
i32 = jnp.int32
for name, cut in sorted(base.CUTS.items()):
    cg, cp = cut(padded)
    with pltpu.force_tpu_interpret_mode():
        sorted_ = [cm.sort_chunk(jnp.asarray(base._chunk_buf(padded, ci)),
                                 i32(0), i32(base._hi(n, ci)), chunk=C)
                   for ci in (0, 1)]
        want = cm.probe_pair(sorted_[0], sorted_[1], i32(cg), i32(cp), i32(0),
                             i32(base._hi(n, 1)), i32(limit), chunk=C)
    halo, cur = (tcm.planes_from_reference([np.asarray(p) for p in s])
                 for s in sorted_)
    got = tcm.probe_pair(halo, cur, cg, cp, 0, base._hi(n, 1), limit,
                         chunk=C)
    for g, w, field in zip(got, want, ("lens", "dists", "conv", "lk")):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype),
                                      err_msg=f"{name} {field}")
    assert np.asarray(want[2]).sum() > C // 4
print("EQUAL")
"""


@pytest.mark.parametrize("text", ["12,2000", "16,12,64"])
def test_far_probe_set_equals_reference(text):
    pytest.importorskip("jax")
    env = dict(os.environ, SMALLZ4_TPU_FAR_PROBES=text, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(TESTS), str(TESTS.parent), text],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().endswith("EQUAL")
