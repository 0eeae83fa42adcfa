#!/usr/bin/env python3
"""Population-scale benchmark: SV·sample throughput on a multi-sample
manifest (BASELINE.json's pod-sharded "~100k SV × N-sample population
run" config in single-chip miniature).

Runs the full multigrmpy pipeline over N samples × M events with the
auto-selected genotyping engine (the sharded float32 device engine for
this shape — pipeline/grmpy.py gt_engine="auto"), measures wall-clock,
and scores per-sample calls against the planted per-sample truth.

Prints one JSON line {"metric": "sv_sample_throughput", ...} plus an
accuracy/engine detail line on stderr.
"""
import argparse
import gzip
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "tools"))

REFERENCE_SV_PER_S = 1.0  # per sample, same favourable end as bench_e2e


def score_population(genotypes_vcf, events, sample_names):
    """Confident-call accuracy per sample vs the planted gts."""
    calls = {}
    with gzip.open(genotypes_vcf, "rt") as f:
        samples = []
        for line in f:
            if line.startswith("##"):
                continue
            parts = line.rstrip("\n").split("\t")
            if line.startswith("#"):
                samples = parts[9:]
                continue
            fmt = parts[8].split(":")
            gt_i = fmt.index("GT")
            ft_i = fmt.index("FT") if "FT" in fmt else None
            per = {}
            for name, col in zip(samples, parts[9:]):
                vals = col.split(":")
                ft = vals[ft_i] if ft_i is not None else ""
                per[name] = (vals[gt_i], ft)
            calls[int(parts[1])] = per
    n_conf = n_ok = 0
    for ev in events:
        per = calls.get(ev["pos"], {})
        for name in sample_names:
            want = ev.get("gts", {}).get(name, ev["gt"])
            got, ft = per.get(name, ("missing", ""))
            if ft not in ("", "PASS", "."):
                continue  # unconfident; bench_e2e tracks these classes
            n_conf += 1
            if (got == want or (got == "1/0" and want == "0/1")
                    or (want == "0/0" and got in ("0/0", "./."))):
                n_ok += 1
    return n_conf, n_ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=150)
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--engine", default="auto")
    args = ap.parse_args()

    from make_workload import generate

    wl = (f"/tmp/bench_pop_wl{args.events}x{args.samples}_s{args.seed}")
    truth_path = os.path.join(wl, "truth.json")
    if os.path.isfile(truth_path):
        events = json.load(open(truth_path))
        if len(events) != args.events or "gts" not in events[0] or len(
                events[0]["gts"]) != args.samples:
            events = generate(wl, n_events=args.events, seed=args.seed,
                              n_samples=args.samples)
    else:
        events = generate(wl, n_events=args.events, seed=args.seed,
                          n_samples=args.samples)
    sample_names = sorted(events[0]["gts"])

    import logging

    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="[%(asctime)s] [%(name)s] [%(levelname)s] [%(message)s]")

    # one-time backend initialisation is set-up, not pipeline time
    import numpy as np
    import jax

    np.asarray(jax.numpy.zeros((8, 128)) + 1)

    from paragraph_tpu.pipeline.multigrmpy import MultigrmpyOptions, run

    t0 = time.perf_counter()
    result = run(MultigrmpyOptions(
        input=os.path.join(wl, "candidates.vcf"),
        manifest=os.path.join(wl, "samples.txt"),
        reference=os.path.join(wl, "ref.fa"),
        output=os.path.join(wl, "out_bench"),
        split_type="superloci",
        gt_engine=args.engine,
    ))
    elapsed = time.perf_counter() - t0

    n_conf, n_ok = score_population(result["genotypes_vcf"], events,
                                    sample_names)
    sv_samples = len(events) * len(sample_names)
    print(json.dumps({
        "metric": "sv_sample_throughput",
        "value": round(sv_samples / elapsed, 2),
        "unit": "SV*sample/s",
        "vs_baseline": round(sv_samples / elapsed / REFERENCE_SV_PER_S, 2),
    }))
    print(json.dumps({
        "events": len(events), "samples": len(sample_names),
        "elapsed_s": round(elapsed, 2),
        "engine": args.engine,
        "confident_calls": n_conf,
        "confident_accuracy": round(n_ok / n_conf, 4) if n_conf else None,
    }), file=sys.stderr)


if __name__ == "__main__":
    main()
