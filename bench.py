#!/usr/bin/env python3
"""Benchmark: graph Smith-Waterman fill throughput (cells/s) on the GPU.

Measures the paired device fill on a realistic SV graph against the
original gssw C library (compiled from the read-only reference at
/root/reference/external/gssw) running single-threaded on the host CPU —
the same single-core baseline BASELINE.md's ≥100× target refers to.
Fails when JAX finds no GPU.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def build_case(read_len=150, n_reads=8192, seed=7):
    # 8192 reads -> 32768 scored lanes (4 orientations) per dispatch
    from paragraph_tpu.graph.model import SequenceGraph

    rng = np.random.RandomState(seed)
    bases = "ACGT"

    def seq(n):
        return "".join(bases[i] for i in rng.randint(0, 4, n))

    # shortdeletion-style graph with source/sink (the dominant production
    # shape: 2 flanks + deleted interval, ~600 graph bases)
    g = SequenceGraph(
        ["source", "LF", "MID", "RF", "sink"],
        ["X", seq(150), seq(300), seq(150), "X"])
    for f, t in [(0, 1), (1, 2), (1, 3), (2, 3), (3, 4)]:
        g.add_edge(f, t)

    ref = g.node_seq(1) + g.node_seq(2) + g.node_seq(3)
    alt = g.node_seq(1) + g.node_seq(3)
    reads = []
    for i in range(n_reads):
        src = ref if i % 2 == 0 else alt
        start = rng.randint(0, len(src) - read_len)
        read = list(src[start:start + read_len])
        for j in range(len(read)):
            if rng.random_sample() < 0.01:
                read[j] = bases[rng.randint(0, 4)]
        reads.append("".join(read))
    return g, reads


def bench_device(g, reads, repeats=3):
    # Paired fill (full 4-orientation GraphAligner protocol, reads
    # uploaded once, variants derived on device)
    from paragraph_tpu.ops.multi_sw import PairedGraphSW

    m = ((max(len(r) for r in reads) + 31) // 32) * 32
    sw = PairedGraphSW([g])
    sw.score_pairs([reads])  # warmup / compile

    a = sw.chunk_arrays[0]
    # per read: 2 fills on the forward stream (fwd + revcomp) and 2
    # on the reversed stream — same 4-fill protocol the CPU baseline
    # below runs
    cells = len(reads) * 2 * (a.col_len[0] + a.col_len[1]) * m

    depth = 5
    elapsed = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        handles = [sw.score_pairs_device([reads]) for _ in range(depth)]
        for h in handles:
            sw.finalize_pairs(h)
        elapsed = min(elapsed, (time.perf_counter() - t0) / depth)
    report = sw.engine_report()
    print(f"KERNEL_STATS {json.dumps(report)}", file=sys.stderr,
          flush=True)
    return cells / elapsed, elapsed


def bench_reference_cpu(g, reads, max_reads=128):
    """Single-core gssw baseline (4 fills per read like GraphAligner)."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    try:
        from gssw_oracle import GsswRef
    except Exception:
        return None
    try:
        ref_lib = GsswRef()
    except Exception:
        return None

    from paragraph_tpu.align.graph_aligner import reverse_complement

    node_seqs = [g.node_seq(i) for i in range(g.num_nodes)]
    edges = g.edges()
    rg = g.reversed()
    rnode_seqs = [rg.node_seq(i) for i in range(rg.num_nodes)]
    redges = rg.edges()

    sample = reads[:max_reads]
    t0 = time.perf_counter()
    for r in sample:
        rc = reverse_complement(r)
        ref_lib.align(node_seqs, edges, r)
        ref_lib.align(node_seqs, edges, rc)
        ref_lib.align(rnode_seqs, redges, r[::-1])
        ref_lib.align(rnode_seqs, redges, rc[::-1])
    elapsed = time.perf_counter() - t0

    L = sum(len(s) for s in node_seqs)
    cells = sum(4 * L * ((len(r) + 15) // 16) * 16 for r in sample)
    return cells / elapsed


def _device_worker():
    """Entry for the watchdog subprocess: prints the device cells/s plus
    the device it ran on. Exits non-zero when JAX finds no GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU (platform {dev.platform!r})")
    n_reads = 8192
    g, reads = build_case(n_reads=n_reads)
    repeats = 6
    cells_per_s, _ = bench_device(g, reads, repeats=repeats)
    print(f"DEVICE_RESULT {cells_per_s} {dev.platform} {n_reads} {repeats} "
          f"{dev.device_kind}", flush=True)


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--device-worker":
        _device_worker()
        return

    g, reads = build_case()

    # Device benchmark under a watchdog, so a hung device run cannot stall
    # the harness. No GPU, or a failed run, is a failure (exit code 1):
    # there is no CPU fallback.
    import subprocess

    def run_worker(env, timeout):
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--device-worker"],
                capture_output=True, text=True, timeout=timeout, env=env)
        except (subprocess.TimeoutExpired, OSError):
            return None
        for line in proc.stdout.splitlines():
            if line.startswith("DEVICE_RESULT "):
                parts = line.split()
                return {"cells_per_s": float(parts[1]),
                        "platform": parts[2],
                        "n_reads": int(parts[3]),
                        "dispatches": int(parts[4]),
                        "device_kind": " ".join(parts[5:])}
        return None

    result = run_worker(dict(os.environ), timeout=780)
    gpu_ok = result is not None and result["platform"] == "gpu"

    device_cells_per_s = result["cells_per_s"] if result else 0.0
    baseline = bench_reference_cpu(g, reads)
    vs = (device_cells_per_s / baseline) if baseline else 0.0
    out = {
        "metric": "graph_sw_cells_per_second",
        "value": round(device_cells_per_s, 1),
        "unit": "cells/s",
        "vs_baseline": round(vs, 2),
        "platform": result["platform"] if result else "none",
        "device_kind": result["device_kind"] if result else "none",
        "card": _card(),
        "batch_reads": result["n_reads"] if result else 0,
        "dispatches": result["dispatches"] if result else 0,
        "baseline_cells_per_s": round(baseline or 0.0, 1),
    }
    # north-star system metric (BASELINE.md "SVs genotyped/sec at 30x"):
    # a 300-event end-to-end run in a watchdogged subprocess, recorded
    # alongside the kernel microbenchmark so every round's BENCH_r*.json
    # carries both. A hung/failed e2e marks the keys, never the bench.
    if gpu_ok:
        try:
            proc = subprocess.run(
                [sys.executable,
                 os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "bench_e2e.py"), "--events", "1000"],
                capture_output=True, text=True, timeout=600)
            line = proc.stdout.strip().splitlines()[-1]
            e2e = json.loads(line)
            out["sv_genotyping_throughput_30x"] = e2e["value"]
            out["e2e_vs_baseline"] = e2e["vs_baseline"]
            for dline in proc.stderr.splitlines():
                if '"genotype_accuracy"' in dline:
                    out["e2e_detail"] = json.loads(dline)
                    break
        except (subprocess.TimeoutExpired, OSError, ValueError,
                IndexError, KeyError) as exc:
            out["sv_genotyping_throughput_30x"] = None
            out["e2e_error"] = f"{type(exc).__name__}: {exc}"
        # population config (BASELINE.json's N-sample run in single-chip
        # miniature): 8 samples x 150 events through the pipelined
        # sharded device genotyping engine
        try:
            proc = subprocess.run(
                [sys.executable,
                 os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "bench_population.py"),
                 "--events", "150", "--samples", "8"],
                capture_output=True, text=True, timeout=600)
            line = proc.stdout.strip().splitlines()[-1]
            pop = json.loads(line)
            out["sv_sample_throughput"] = pop["value"]
            for dline in proc.stderr.splitlines():
                if '"confident_accuracy"' in dline:
                    out["population_detail"] = json.loads(dline)
                    break
        except (subprocess.TimeoutExpired, OSError, ValueError,
                IndexError, KeyError) as exc:
            out["sv_sample_throughput"] = None
            out["population_error"] = f"{type(exc).__name__}: {exc}"

    if not gpu_ok:
        out["failed"] = True
        out["failure"] = "no GPU, or the device run failed or timed out"
    elif baseline and vs < 30:
        # regression gate against the single-core gssw baseline
        out["failed"] = True
        out["failure"] = (f"kernel throughput regression: {vs:.1f}x "
                          "baseline (threshold 30x)")
    print(json.dumps(out))
    if out.get("failed"):
        sys.exit(1)


if __name__ == "__main__":
    main()
