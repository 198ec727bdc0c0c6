"""The device optimal parse of the port (smallz4_tpu_torch/ops/parse.py)
on the synthetic worst cases of ``chip_smoke.parse_claims`` (claims that
land on tile edges and on limit, every position an entry, N not a
multiple of the tile, seeded claims across many tiles), at N <= 2^17 on
the CPU: the plain policy iteration against the JAX package's
``estimate_costs_device`` and ``native.estimate_costs``, as
tests/test_torch_parse.py holds the blocks of its cases.  The cases live
in a file of their own so that a run split by file does not put them and
that file's longest case on one worker.
"""
import pytest

from chip_smoke import PARSE_CASES
from test_torch_parse import (  # noqa: F401
    _one_torch_thread, estimate_costs_equals_reference, jparse)


@pytest.mark.parametrize("case", list(PARSE_CASES))
def test_estimate_costs_equals_reference(jparse, case):  # noqa: F811
    estimate_costs_equals_reference(jparse, case)
