"""PairedGraphSW (single-upload 4-orientation protocol): the on-device
orientation derivation must reproduce host-side string reversal and
complement exactly, so every orientation of every read matches the
scalar oracle (ops/multi_sw.py expand_orientations)."""
import random

from paragraph_tpu.graph.model import SequenceGraph
from paragraph_tpu.ops.multi_sw import PairedGraphSW

from test_gssw_vs_reference import _random_graph, _read_from_graph
from test_multi_sw import check_against_oracle


def _make_graph(seqs, edges):
    g = SequenceGraph([f"n{i}" for i in range(len(seqs))], seqs)
    for f, t in edges:
        g.add_edge(f, t)
    return g


def test_paired_matches_legacy_batches():
    """The paired layout's f_out/r_out equal the two legacy batches
    ([fwd + revcomp] vs the graph, their reversals vs the reversed graph)
    scored read by read with the scalar oracle."""
    rng = random.Random(909)
    graphs = []
    reads_per_pair = []
    for _ in range(3):
        seqs, edges = _random_graph(rng, max_nodes=5, max_len=20)
        graphs.append(_make_graph(seqs, edges))
        reads = []
        for _ in range(4):
            r = _read_from_graph(rng, seqs, edges,
                                 read_len=rng.randint(6, 25))
            if r:
                reads.append(r)
        reads_per_pair.append(reads)

    got = PairedGraphSW(graphs).score_pairs(reads_per_pair)
    check_against_oracle(graphs, reads_per_pair, got)


def test_paired_chunking_keeps_pairs_together():
    rng = random.Random(910)
    graphs = []
    reads_per_pair = []
    for _ in range(4):
        seqs, edges = _random_graph(rng, max_nodes=4, max_len=16)
        graphs.append(_make_graph(seqs, edges))
        r = _read_from_graph(rng, seqs, edges, read_len=10)
        reads_per_pair.append([r] if r else ["ACGTACGT"])
    # force one pair per chunk
    paired = PairedGraphSW(graphs, col_budget=1)
    assert len(paired.chunk_pairs) == 4
    got = paired.score_pairs(reads_per_pair)
    one = PairedGraphSW(graphs)
    want = one.score_pairs(reads_per_pair)
    for k in range(4):
        for side in range(2):
            for a, b in zip(got[k][side], want[k][side]):
                assert (a == b).all()


def test_blob_form_matches_string_form():
    """(blob, lens) pair inputs (the pipelined orchestrator's wire form)
    must score identically to list-of-strings inputs."""
    import numpy as np

    rng = random.Random(4242)
    graphs = []
    reads_per_pair = []
    for _ in range(3):
        seqs, edges = _random_graph(rng, max_nodes=4, max_len=18)
        graphs.append(_make_graph(seqs, edges))
        reads = []
        for _ in range(rng.randint(0, 5)):
            r = _read_from_graph(rng, seqs, edges,
                                 read_len=rng.randint(6, 20))
            if r:
                reads.append(r)
        reads_per_pair.append(reads)

    sw = PairedGraphSW(graphs)
    want = sw.score_pairs(reads_per_pair)

    blobs = []
    for reads in reads_per_pair:
        up = [r.upper() for r in reads]
        lens = np.fromiter((len(r) for r in up), np.int32, count=len(up))
        blobs.append(("".join(up).encode(), lens))
    got = PairedGraphSW(graphs).score_pairs(blobs)

    for (gf, gr), (wf, wr) in zip(got, want):
        for a, b in zip(gf + gr, wf + wr):
            assert np.array_equal(a, b)
