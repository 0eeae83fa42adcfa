"""Smoke tests for the CLI tool surface on the reference's bundled
round-trip fixture (share/test-data/round-trip-genotyping)."""
import gzip
import json
import os
import subprocess
import sys

import pytest

DATA = "/root/reference/share/test-data/round-trip-genotyping"
ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def _run(args, **kw):
    return subprocess.run(
        [sys.executable, "-m", "paragraph_tpu.cli.main"] + args,
        capture_output=True, text=True, env=ENV, timeout=240,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        **kw)


def test_vcf2paragraph_and_downstream_tools(tmp_path):
    graph_json = str(tmp_path / "graph.json")
    r = _run(["vcf2paragraph", f"{DATA}/candidates.vcf", graph_json,
              "-r", f"{DATA}/dummy.fa", "-T", "chr1", "--alt-paths"])
    assert r.returncode == 0, r.stderr
    desc = json.load(open(graph_json))
    assert desc["nodes"] and desc["edges"] and desc["paths"]

    # graph-to-fasta: one contig per path
    fasta_out = str(tmp_path / "paths.fa")
    r = _run(["graph-to-fasta", "-g", graph_json, "-r", f"{DATA}/dummy.fa",
              "-o", fasta_out])
    assert r.returncode == 0, r.stderr
    names = [l[1:].strip() for l in open(fasta_out) if l.startswith(">")]
    assert len(names) == len(desc["paths"])

    # paragraph2dot
    dot_out = str(tmp_path / "graph.dot")
    r = _run(["paragraph2dot", graph_json, dot_out])
    assert r.returncode == 0, r.stderr
    assert "digraph" in open(dot_out).read()

    # kmerstats
    r = _run(["kmerstats", "-g", graph_json, "-r", f"{DATA}/dummy.fa",
              "-k", "12"])
    assert r.returncode == 0, r.stderr
    stats = json.loads(r.stdout)
    assert stats["kmer_length"] == 12 and stats["kmers"] > 0

    # simulate-reads
    sim_out = str(tmp_path / "sim.fa")
    r = _run(["simulate-reads", "-g", graph_json, "-r", f"{DATA}/dummy.fa",
              "-o", sim_out, "-l", "30", "-d", "2"])
    assert r.returncode == 0, r.stderr
    assert open(sim_out).read().count(">") > 0

    # addVariants round-trips the graph JSON (without --alt-paths: alt
    # path labels are not registered haplotype sequences, and
    # GraphContainer.check rejects them — same as the reference loader)
    plain = str(tmp_path / "plain.json")
    r = _run(["vcf2paragraph", f"{DATA}/candidates.vcf", plain,
              "-r", f"{DATA}/dummy.fa", "-T", "chr1"])
    assert r.returncode == 0, r.stderr
    added = str(tmp_path / "added.json")
    r = _run(["addVariants", plain, added])
    assert r.returncode == 0, r.stderr
    assert json.load(open(added))["nodes"]


def test_idxdepth_cli():
    r = _run(["idxdepth", "-b", f"{DATA}/sample1.bam",
              "-r", f"{DATA}/dummy.fa"])
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout)
    assert "contigs" in out or "autosome" in out


def test_msa2vcf_cli(tmp_path):
    msa = tmp_path / "msa.fa"
    msa.write_text(">ref\nACGTACGTAC\n>alt1\nACGTA-GTAC\n>alt2\nACCTACGTAC\n")
    out = str(tmp_path / "out.vcf")
    r = _run(["msa2vcf", str(msa), out])
    assert r.returncode == 0, r.stderr
    body = open(out).read()
    assert "#CHROM" in body


def test_compare_alignments_cli(tmp_path):
    aln = tmp_path / "a.json"
    aln.write_text(json.dumps({"alignments": [
        {"fragmentId": "f1", "graphCigar": "0[10M]", "graphMapq": 60}]}))
    r = _run(["compare-alignments", str(aln), str(aln)])
    assert r.returncode == 0, r.stderr
