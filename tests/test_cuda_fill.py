"""CUDA paired fill (native/graph_sw_cuda.cu) on the card: against the
scalar oracle on random graphs and against the plain XLA fill at
production shapes. Needs an NVIDIA GPU; skips elsewhere. Run on the card:

    JAX_PLATFORMS=cuda python -m pytest tests/test_cuda_fill.py -m gpu
"""
import random

import numpy as np
import pytest

from paragraph_tpu.graph.model import SequenceGraph
from paragraph_tpu.ops.multi_sw import PairedGraphSW

import test_multi_sw as cases

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("case,seed", cases.ORACLE_CASES,
                         ids=cases.ORACLE_IDS)
def test_cuda_fill_matches_oracle(gpu, case, seed):
    graphs, rpp = case(random.Random(seed))
    sw = PairedGraphSW(graphs, engine="cuda")
    cases.check_against_oracle(graphs, rpp, sw.score_pairs(rpp))


def _deletion_case(rng, n_events, n_reads, read_len):
    def seq(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    graphs, rpp = [], []
    for _ in range(n_events):
        g = SequenceGraph(["source", "LF", "MID", "RF", "sink"],
                          ["X", seq(150), seq(300), seq(150), "X"])
        for f, t in [(0, 1), (1, 2), (1, 3), (2, 3), (3, 4)]:
            g.add_edge(f, t)
        ref = g.node_seq(1) + g.node_seq(2) + g.node_seq(3)
        alt = g.node_seq(1) + g.node_seq(3)
        reads = []
        for i in range(n_reads):
            src = ref if i % 2 == 0 else alt
            start = rng.randrange(0, max(1, len(src) - read_len))
            read = list(src[start:start + read_len])
            for j in range(len(read)):
                if rng.random() < 0.01:
                    read[j] = rng.choice("ACGT")
            reads.append("".join(read))
        graphs.append(g)
        rpp.append(reads)
    return graphs, rpp


@pytest.mark.parametrize("read_len", [150, 250])
def test_cuda_equals_xla_at_production_shapes(gpu, read_len):
    graphs, rpp = _deletion_case(random.Random(read_len), 32, 96, read_len)
    got = PairedGraphSW(graphs, engine="cuda").score_pairs(rpp)
    want = PairedGraphSW(graphs, engine="xla").score_pairs(rpp)
    for k in range(len(graphs)):
        for side in range(2):
            for a, b in zip(got[k][side], want[k][side]):
                assert np.array_equal(a, b), (k, side)
