#!/usr/bin/env python3
"""End-to-end system benchmark: SVs genotyped per second at 30x.

This is the north-star metric from BASELINE.md ("SVs genotyped/sec at
30x"): the FULL multigrmpy pipeline — VCF→graph conversion, BAM
extraction, device graph-SW scoring, host analysis, genotyping, VCF
emission — on a synthetic mixed DEL/INS/DUP/INV + nested DEL+SNP
workload with planted genotypes (tests/tools/make_workload.py), measured
wall-clock after a device warm-up. The reference's published figure is
1-2 s per SV on one CPU core (/root/reference/README.md:105), i.e.
0.5-1 SV/s; vs_baseline uses the favourable 1.0 SV/s end of that range.

Prints one JSON line {"metric", "value", "unit", "vs_baseline"} plus a
detail line with accuracy and peak RSS on stderr.
"""
import argparse
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "tools"))

REFERENCE_SV_PER_S = 1.0  # 1-2 s/SV on one core -> favourable end


def check_truth(genotypes_vcf, genotypes_json, events):
    """Score calls against the planted truth and CLASSIFY every miss.

    Returns (n_ok, misses) where each miss is a dict with a `reason`:
      - low_gq           GQ < 10 — the model itself says the call is
                         uninformative (e.g. a DUP whose duplicated
                         segment is shorter than the read length: no
                         read can span it, so breakpoint evidence is
                         intrinsically ~0; the reference genotyper has
                         the same behaviour — CombinedGenotype.cpp:46-83
                         reports the consensus of failed breakpoints)
      - filtered         FT != PASS (CONFLICT / BP_NO_GT / GQ ...):
                         the pipeline flagged the event as not
                         confidently callable
      - unexpected       a confident call (PASS, GQ >= 10) that
                         disagrees with the truth — a real defect
    """
    import gzip

    calls = {}
    fts = {}
    gqs = {}
    with gzip.open(genotypes_vcf, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            fmt = parts[8].split(":")
            vals = parts[9].split(":")
            pos = int(parts[1])
            calls[pos] = vals[fmt.index("GT")]
            fts[pos] = vals[fmt.index("FT")] if "FT" in fmt else ""
            gq = -1
            if "GQ" in fmt:
                try:
                    gq = int(vals[fmt.index("GQ")])
                except ValueError:
                    pass
            elif "PL" in fmt:
                # derive: phred distance from the best to the runner-up GT
                try:
                    pls = sorted(int(x) for x in
                                 vals[fmt.index("PL")].split(","))
                    gq = pls[1] - pls[0]
                except (ValueError, IndexError):
                    pass
            gqs[pos] = gq
    bp_gts = {}
    with gzip.open(genotypes_json, "rt") as f:
        for rec in json.load(f):
            for bp in rec["samples"]["sample"].get(
                    "breakpoints", {}).values():
                for a in set(bp["counts"]["alleles"]) - {"REF"}:
                    bp_gts.setdefault(a, set()).add(bp["gt"].get("GT", "."))
    n_ok = 0
    misses = []
    for i, ev in enumerate(events):
        got = calls.get(ev["pos"], "missing")
        want = ev["gt"]
        ok = (got == want or (got == "1/0" and want == "0/1")
              or (want == "0/0" and got in ("0/0", "./.")))
        if not ok and ev["kind"] == "DELSNP":
            allele = f"ev{i}:1"
            want_bp = {"0/1": f"REF/{allele}",
                       "1/1": f"{allele}/{allele}",
                       "0/0": "REF/REF"}[want]
            ok = (got == "." and "UNMATCHED" in fts.get(ev["pos"], "")
                  and bp_gts.get(allele) == {want_bp})
        if ok:
            n_ok += 1
            continue
        ft = fts.get(ev["pos"], "")
        gq = gqs.get(ev["pos"], -1)
        if ft not in ("", "PASS"):
            # a flagged call with high consensus GQ deserves its own
            # class: the pipeline says "unreliable" while the model says
            # "confident" — track these separately instead of burying
            # them under `filtered` (they are the DUP evidence-starvation
            # signature, docs/DUP_HET_ANALYSIS.md)
            reason = "suspect" if gq >= 10 else "filtered"
        elif 0 <= gq < 10:
            reason = "low_gq"
        else:
            reason = "unexpected"
        misses.append({"event": i, "kind": ev["kind"], "pos": ev["pos"],
                       "want": want, "got": got, "FT": ft, "GQ": gq,
                       "reason": reason})
    return n_ok, misses


def per_kind_recall(events, misses):
    """{kind: {"total": N, "ok": N, "recall": f, <reason counts>}}."""
    missed_by_event = {m["event"]: m["reason"] for m in misses}
    table = {}
    for i, ev in enumerate(events):
        row = table.setdefault(ev["kind"], {"total": 0, "ok": 0})
        row["total"] += 1
        reason = missed_by_event.get(i)
        if reason is None:
            row["ok"] += 1
        else:
            row[reason] = row.get(reason, 0) + 1
    for row in table.values():
        row["recall"] = round(row["ok"] / row["total"], 4)
    return table


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=1000)
    ap.add_argument("--workload", default="",
                    help="existing workload dir (else generated in /tmp)")
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()

    from make_workload import generate

    wl = args.workload or f"/tmp/bench_e2e_wl{args.events}_s{args.seed}"
    truth_path = os.path.join(wl, "truth.json")
    if os.path.isfile(truth_path):
        events = json.load(open(truth_path))
        if len(events) != args.events:
            events = generate(wl, n_events=args.events, seed=args.seed)
    else:
        events = generate(wl, n_events=args.events, seed=args.seed)

    # stage breakdown ([pipeline] stage seconds + [kernel] lines from
    # pipeline/parallel_grmpy.py) goes to stderr so every bench run
    # records where the budget went
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
    ))
    elapsed = time.perf_counter() - t0

    n_ok, misses = check_truth(result["genotypes_vcf"],
                               result["genotypes_json"], events)
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    rss_child = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1024
    sv_per_s = len(events) / elapsed
    n_unexpected = sum(m["reason"] == "unexpected" for m in misses)
    print(json.dumps({
        "metric": "sv_genotyping_throughput_30x",
        "value": round(sv_per_s, 2),
        "unit": "SV/s",
        "vs_baseline": round(sv_per_s / REFERENCE_SV_PER_S, 2),
    }))
    print(json.dumps({
        "events": len(events), "elapsed_s": round(elapsed, 2),
        "genotype_accuracy": round(n_ok / len(events), 4),
        "explained_accuracy": round(
            (len(events) - n_unexpected) / len(events), 4),
        "unexpected_misses": n_unexpected,
        "suspect_misses": sum(m["reason"] == "suspect" for m in misses),
        "peak_rss_main_mb": round(rss_mb, 1),
        "peak_rss_worker_mb": round(rss_child, 1),
    }), file=sys.stderr)
    print(json.dumps({"per_kind_recall": per_kind_recall(events, misses)}),
          file=sys.stderr)
    for m in misses:
        print(json.dumps({"miss": m}), file=sys.stderr)


if __name__ == "__main__":
    main()
