"""The persistent host worker pool of the device pipeline.

The port's copy of ``smallz4_tpu/parallel/host.py`` ``_pool``: the native
matcher keeps about 90 MB of thread-local tables warm per worker, so the
threads outlive individual ``compress()`` calls.
"""
from __future__ import annotations

import concurrent.futures as cf
import os

_POOL: cf.ThreadPoolExecutor | None = None
_POOL_SIZE = 0


def _pool(threads: int | None) -> cf.ThreadPoolExecutor:
    """The shared executor, grown (never shrunk) to ``threads`` workers
    (default: one per core, at most 32)."""
    global _POOL, _POOL_SIZE
    want = threads or min(32, os.cpu_count() or 1)
    if _POOL is None or _POOL_SIZE < want:
        _POOL = cf.ThreadPoolExecutor(max_workers=want)
        _POOL_SIZE = want
    return _POOL
