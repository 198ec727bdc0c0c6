"""The one traffic generator: it reads a mix's data file and makes requests.

A mix (``bench_port/traffic/<name>.json``) names an operation (``encode``
or ``decode``), a source fixture, a law of request sizes and how request
content is cut from the source.  Every seed gets the same sizes (the
law's mid-quantiles); the seed draws the order and, unless the mix fixes
it, the content.  A run sends the cycle again and again, in a closed
loop, one request after another.

Keys of a mix file:
  op             "encode" | "decode"
  source         a fixture of ``corpus.FIXTURES``
  sizes          {"min", "max", "count"}: log-uniform request sizes, bytes
  pieces         {"min", "max"}: log-uniform lengths of the source pieces
                 each request is joined from
  content        "seeded" (the default: the seed orders the pieces, so
                 each seed's requests hold other bytes) | "fixed" (the
                 same requests for every seed, byte for byte, in the
                 seed's order: a path whose work follows the bytes does
                 the same work under every seed)
  warm           "largest" (the largest request once) | "cycle" (the whole
                 cycle once): set-up's warm requests
  trace_requests requests profiled in a traced run

The comparison with the reference takes, for every distinct request of
the cycle, one of its answers in the window, drawn from the seed.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np

from . import corpus

TRAFFIC = pathlib.Path(__file__).resolve().parent.parent / "traffic"


def load(name: str) -> dict:
    return json.loads((TRAFFIC / f"{name}.json").read_text())


class Traffic:
    """One seed's cycle of requests.  ``cycle[k]`` is a dict with ``data``
    (the source bytes) and, for a decode mix, ``frame`` (its encoding,
    made in set-up)."""

    def __init__(self, mix: dict, seed: int, prepare=None):
        self.mix = mix
        rng = np.random.default_rng(seed)
        sizes = corpus.log_uniform_sizes(mix["sizes"]["min"],
                                         mix["sizes"]["max"],
                                         mix["sizes"]["count"])
        order = rng.permutation(len(sizes))
        source = corpus.fixture(mix["source"])
        fixed = mix.get("content", "seeded") == "fixed"
        stream = corpus.recombine(
            source, sum(sizes), np.random.default_rng(0) if fixed else rng,
            mix["pieces"]["min"], mix["pieces"]["max"])
        cut = order if not fixed else range(len(sizes))
        at, data = 0, {}
        for k in cut:  # a fixed mix cuts request k from the same bytes
            data[k] = stream[at: at + sizes[k]]
            at += sizes[k]
        self.cycle = [{"data": data[k]} for k in order]
        if mix["op"] == "decode":
            for r in self.cycle:
                r["frame"] = prepare(r["data"])
        self.check_rng = np.random.default_rng([seed, 1])

    def warm(self) -> list:
        if self.mix["warm"] == "cycle":
            return list(self.cycle)
        return [max(self.cycle, key=lambda r: len(r["data"]))]


class EachRequest:
    """For each distinct request of the cycle, one of the window's answers
    to it, drawn uniformly from the seed (a reservoir of one a request)."""

    def __init__(self, rng: np.random.Generator):
        self.rng, self.seen, self.by_request = rng, {}, {}

    def offer(self, k: int, item) -> None:
        n = self.seen.get(k, 0) + 1
        self.seen[k] = n
        if int(self.rng.integers(0, n)) == 0:
            self.by_request[k] = item

    @property
    def kept(self) -> list:
        return [self.by_request[k] for k in sorted(self.by_request)]
