#!/usr/bin/env python3
"""Smoke run of the genotyping engine on one NVIDIA GPU.

    python chip_smoke.py               # one card: phases 1-4
    python chip_smoke.py --four-cards  # the event-sharded path on 4 cards

Phases (one process, one card):

1. Header: the card's name and power limit, JAX's devices; rebuild the
   native traceback library and the CUDA fill from source.
2. Kernel at real widths: one production-shaped dispatch (32 events of a
   generated single-sample 30x workload with their real read sets),
   scored by the CUDA kernel and by the plain XLA fill, compared exactly;
   a sample of reads checked against the scalar oracle (align/gssw.py);
   the random-graph cases of the gpu-marked tests run on the kernel.
3. End to end: ``multigrmpy`` on 256 generated events (8 pipelined
   rounds of 32), with the device engine named on every event, genotype
   accuracy >= 0.97 against the planted truth and no unexpected miss.
4. Cohort: 8 samples x 32 events, where the automatic rule picks the
   float32 device genotyping engine; its confident calls must equal the
   float64 host engine's.

``--four-cards`` runs phase 3's workload once on one card and once
sharded over four (ShardedPairedSW), one process after the other, and
requires byte-identical genotypes.

The last line of standard output is one JSON object naming the device;
the script exits non-zero, and prints no such line, when JAX finds no GPU
or any phase fails.
"""
import argparse
import glob
import gzip
import json
import logging
import os
import shutil
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_work")

SEED = 11           # workload generator seed
ACCURACY_MIN = 0.97
GL_ABS_TOL = 5e-3   # float32 vs float64 genotype likelihoods
GL_REL_TOL = 2e-4


def die(msg: str, code: int = 2) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def check_checkout() -> None:
    for rel in ("paragraph_tpu", "native/graph_sw_cuda.cu",
                "tests/tools/make_workload.py", "bench_e2e.py"):
        if not os.path.exists(os.path.join(ROOT, rel)):
            die(f"{rel} not found next to chip_smoke.py: run it from a "
                "checkout of the repository")
    for p in (ROOT, os.path.join(ROOT, "tests"),
              os.path.join(ROOT, "tests", "tools")):
        if p not in sys.path:
            sys.path.insert(0, p)


def gpu_devices():
    """JAX's devices; exits non-zero unless they are GPUs."""
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as exc:
        die(f"JAX found no usable backend: {exc}", 3)
    if devices[0].platform != "gpu":
        die(f"JAX found no GPU (platform {devices[0].platform!r})", 3)
    return devices


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip()


def build_libraries() -> float:
    """Rebuild the native traceback library and the CUDA fill from the
    sources on this machine (set-up time)."""
    from paragraph_tpu.ops import cuda_sw

    t0 = time.perf_counter()
    subprocess.run(["make", "-C", os.path.join(ROOT, "native"), "-B"],
                   check=True, capture_output=True)
    cuda_sw.build(force=True)
    return time.perf_counter() - t0


def make_workload(name: str, **kw) -> tuple:
    from make_workload import generate

    wl = os.path.join(WORK, name)
    shutil.rmtree(wl, ignore_errors=True)
    t0 = time.perf_counter()
    events = generate(wl, **kw)
    return wl, events, time.perf_counter() - t0


def device_time(trace_dir: str, kernel_name: str = "") -> dict:
    """Reduce a jax.profiler trace to device time: the union of all GPU
    kernel intervals (busy) and the summed duration of the events whose
    name contains `kernel_name`."""
    import jax

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise RuntimeError(f"no trace under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(paths[0])
    intervals, named_ns, n_events, lines = [], 0.0, 0, set()
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            # kernels sit on the stream lines; "XLA Ops"/"XLA Modules"
            # lines repeat them as annotations
            if not line.name.startswith("Stream"):
                continue
            lines.add(line.name)
            for ev in line.events:
                n_events += 1
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                if kernel_name and kernel_name in ev.name:
                    named_ns += ev.duration_ns
    intervals.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return {"busy_ms": busy / 1e6, "named_ms": named_ns / 1e6,
            "gpu_events": n_events, "lines": sorted(lines)}


def phase_kernel(wl: str, n_events: int = 32) -> None:
    """Phase 2: one production-shaped dispatch, CUDA kernel vs XLA fill."""
    import random

    import jax
    import numpy as np

    from paragraph_tpu.genotyping.sample_info import load_manifest
    from paragraph_tpu.graph.model import SequenceGraph
    from paragraph_tpu.align.gssw import GraphSW
    from paragraph_tpu.align.graph_aligner import reverse_complement
    from paragraph_tpu.ops.multi_sw import PairedGraphSW, paired_fill
    from paragraph_tpu.pipeline.multigrmpy import (MultigrmpyOptions,
                                                   load_graph_description)
    from paragraph_tpu.pipeline.parallel_grmpy import (_extract_reads_map,
                                                       _root_desc)
    import test_multi_sw as cases

    ref = os.path.join(wl, "ref.fa")
    descs = load_graph_description(MultigrmpyOptions(
        input=os.path.join(wl, "candidates.vcf"), reference=ref,
        output=os.path.join(WORK, "phase2"),
        split_type="superloci"))[:n_events]
    (sample,) = load_manifest(os.path.join(wl, "samples.txt"))
    specs = [(sample.sample_name, sample.filename, sample.index_filename)]
    graphs, batches = [], []
    for d in descs:
        graphs.append(SequenceGraph.from_json(_root_desc(d), ref))
        reads = _extract_reads_map(d, ref, specs, 10000)[sample.sample_name]
        batches.append([r.bases.upper() for r in reads if r.bases])
    n_reads = [len(b) for b in batches]

    outs = {}
    for engine in ("cuda", "xla"):
        sw = PairedGraphSW(graphs, engine=engine)
        assert len(sw.chunk_pairs) == 1, sw.chunk_pairs
        pad = sw.pad_rows(batches)
        args, statics, t = sw.prepare_dispatch(0, batches, pad)
        t0 = time.perf_counter()
        compiled = paired_fill.lower(*args, **statics).compile()
        compile_s = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        out = compiled(*args)
        out.block_until_ready()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            compiled(*args).block_until_ready()
            walls.append(time.perf_counter() - t0)
        trace_dir = os.path.join(WORK, f"trace_{engine}")
        shutil.rmtree(trace_dir, ignore_errors=True)
        with jax.profiler.trace(trace_dir):
            compiled(*args).block_until_ready()
        dt = device_time(trace_dir, "paired_fill_kernel")
        outs[engine] = np.asarray(out)
        # the scorer's own path (tables, slicing) must agree as well
        outs[engine + "_pairs"] = sw.score_pairs(batches)
        col_len = sw.chunk_arrays[0].col_len[:2 * len(graphs)]
        cells = int(t["tile_col_len"].astype(np.int64).sum()) \
            * statics["TB"] * t["m"]
        print(f"[phase2] engine={engine} compile_s={compile_s:.3f} "
              f"wall_s={['%.6f' % w for w in walls]} "
              f"device_busy_ms={dt['busy_ms']:.4f} "
              f"kernel_ms={dt['named_ms']:.4f} gpu_events={dt['gpu_events']} "
              f"stream_lines={dt['lines']} cells={cells} "
              f"tiles={len(t['tile_event'])} M={t['m']} "
              f"N={statics['N']} P={statics['P']}", flush=True)
        print(f"[phase2] engine={engine} memory_analysis: {mem}",
              flush=True)

    print(f"[phase2] events={len(graphs)} reads/event "
          f"min={min(n_reads)} mean={np.mean(n_reads):.1f} "
          f"max={max(n_reads)} graph columns/event/orientation "
          f"mean={np.mean(col_len):.1f} max={max(col_len)}", flush=True)
    if not np.array_equal(outs["cuda"], outs["xla"]):
        bad = np.argwhere(outs["cuda"] != outs["xla"])
        raise AssertionError(
            f"CUDA fill != XLA fill at {len(bad)} entries, first "
            f"{bad[:5].tolist()}")
    for k, (c, x) in enumerate(zip(outs["cuda_pairs"], outs["xla_pairs"])):
        for side in range(2):
            for a, b in zip(c[side], x[side]):
                assert np.array_equal(a, b), (k, side)
    print(f"[phase2] CUDA == XLA exactly on all {outs['cuda'].shape[1]} "
          "lanes x 4 outputs", flush=True)

    # a sample of reads, every orientation, vs the scalar oracle
    checked = 0
    for k in range(0, len(graphs), 8):
        reads = batches[k][:3]
        if not reads:
            continue
        f_out, r_out = outs["cuda_pairs"][k]
        fwd = reads + [reverse_complement(r) for r in reads]
        n = len(batches[k])
        idx = list(range(len(reads))) + [n + i for i in range(len(reads))]
        for graph, out in ((graphs[k], f_out),
                           (graphs[k].reversed(), r_out)):
            scalar = GraphSW(graph)
            for pos, i in enumerate(idx):
                read = fwd[pos] if graph is graphs[k] else fwd[pos][::-1]
                fills, mn, ms = scalar.fill(read)
                f = fills[mn]
                want = (ms, mn, f.ref_end1, f.read_end1,
                        int(scalar.ends_at_multiple_nodes(fills, ms)))
                got = tuple(int(x[i]) for x in out)
                assert got == want, (k, i, got, want)
                checked += 1
    print(f"[phase2] {checked} sampled fills match the scalar oracle",
          flush=True)

    # the gpu-marked tests' random-graph cases, on the kernel
    for case, seed in cases.ORACLE_CASES:
        g, rpp = case(random.Random(seed))
        cases.check_against_oracle(
            g, rpp, PairedGraphSW(g, engine="cuda").score_pairs(rpp))
    print("[phase2] random-graph oracle cases pass on the CUDA kernel",
          flush=True)


def run_e2e(wl: str, events: list, out_dir: str, log_lines: list) -> dict:
    """multigrmpy on a generated workload; checks engine and accuracy."""
    from bench_e2e import check_truth
    from paragraph_tpu.ops.multi_sw import select_engine
    from paragraph_tpu.pipeline.multigrmpy import MultigrmpyOptions, run

    import jax

    class Keep(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith(("[pipeline]", "[kernel]")):
                log_lines.append(msg)

    logger = logging.getLogger("grmpy")
    logger.setLevel(logging.INFO)
    handler = Keep()
    logger.addHandler(handler)
    try:
        t0 = time.perf_counter()
        result = run(MultigrmpyOptions(
            input=os.path.join(wl, "candidates.vcf"),
            manifest=os.path.join(wl, "samples.txt"),
            reference=os.path.join(wl, "ref.fa"),
            output=out_dir, split_type="superloci"))
        elapsed = time.perf_counter() - t0
    finally:
        logger.removeHandler(handler)
    with gzip.open(result["genotypes_json"], "rt") as f:
        records = json.load(f)
    want = select_engine(jax.devices()[0].platform)
    engines = [s.get("engine") for rec in records
               for s in rec["samples"].values()]
    n_ok, misses = check_truth(result["genotypes_vcf"],
                               result["genotypes_json"], events)
    return {
        "events": len(events), "elapsed_s": elapsed,
        "sv_per_s": len(events) / elapsed,
        "accuracy": n_ok / len(events),
        "unexpected": sum(m["reason"] == "unexpected" for m in misses),
        "engine_ok": bool(engines) and all(e == want for e in engines),
        "engines": sorted(set(map(str, engines))),
        "genotypes_json": result["genotypes_json"],
        "genotypes_vcf": result["genotypes_vcf"],
        "devices": jax.device_count(),
    }


def check_e2e(res: dict, tag: str) -> None:
    print(f"[{tag}] events={res['events']} elapsed_s={res['elapsed_s']:.3f} "
          f"sv_per_s={res['sv_per_s']:.3f} accuracy={res['accuracy']:.4f} "
          f"unexpected={res['unexpected']} engines={res['engines']} "
          f"devices={res['devices']}", flush=True)
    assert res["engine_ok"], f"engine on some event is not the device " \
        f"engine: {res['engines']}"
    assert res["accuracy"] >= ACCURACY_MIN, res["accuracy"]
    assert res["unexpected"] == 0, res["unexpected"]


def phase_cohort(n_events: int = 32, n_samples: int = 8) -> None:
    """Phase 4: float32 device genotyping vs the float64 host engine."""
    from paragraph_tpu.pipeline.multigrmpy import MultigrmpyOptions, run

    wl, _, gen_s = make_workload("cohort", n_events=n_events,
                                 n_samples=n_samples, seed=17)
    outs, secs = {}, {}
    for engine in ("auto", "host"):
        t0 = time.perf_counter()
        result = run(MultigrmpyOptions(
            input=os.path.join(wl, "candidates.vcf"),
            manifest=os.path.join(wl, "samples.txt"),
            reference=os.path.join(wl, "ref.fa"),
            output=os.path.join(wl, f"out_{engine}"),
            split_type="superloci", gt_engine=engine))
        secs[engine] = time.perf_counter() - t0
        with gzip.open(result["genotypes_json"], "rt") as f:
            outs[engine] = json.load(f)
    dev, host = outs["auto"], outs["host"]
    assert len(dev) == len(host)
    n_conf = n_bp = 0
    for rh, rd in zip(host, dev):
        for name, sh in rh["samples"].items():
            sd = rd["samples"][name]
            gh, gd = sh["gt"], sd["gt"]
            if gh.get("GQ", 0) >= 10 and "PASS" in gh.get("filters", []):
                assert gd["GT"] == gh["GT"], (rh.get("graphinfo"), gh, gd)
                n_conf += 1
            for bp, bh in sh.get("breakpoints", {}).items():
                bd = sd["breakpoints"][bp]
                assert bd["counts"] == bh["counts"], bp
                for k, v in bh["gt"].get("GL", {}).items():
                    assert abs(bd["gt"]["GL"][k] - v) <= max(
                        GL_ABS_TOL, GL_REL_TOL * abs(v)), (bp, k)
                n_bp += 1
    assert n_conf > 0
    print(f"[phase4] samples={n_samples} events={n_events} "
          f"generate_s={gen_s:.1f} device_engine_s={secs['auto']:.3f} "
          f"host_engine_s={secs['host']:.3f} confident_calls_equal={n_conf} "
          f"breakpoint_GLs_within(abs {GL_ABS_TOL}, rel {GL_REL_TOL})="
          f"{n_bp}", flush=True)


def one_card(args) -> int:
    devices = gpu_devices()
    import jax

    card = nvidia_smi()
    print(card, flush=True)
    print(f"[phase1] jax.devices()={devices} "
          f"device_kind={devices[0].device_kind} jax={jax.__version__}",
          flush=True)
    failed = []

    def phase(name, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f}s",
                  flush=True)
            return out
        except Exception:  # noqa: BLE001 - report every phase
            traceback.print_exc()
            print(f"[{name}] FAILED", flush=True)
            failed.append(name)
            return None

    def header():
        build_s = build_libraries()
        from paragraph_tpu.align.native import native_available

        assert native_available(), "native traceback library unavailable"
        print(f"[phase1] rebuilt native + CUDA libraries in {build_s:.1f}s",
              flush=True)

    phase("phase1", header)
    wl, events, gen_s = make_workload("single", n_events=args.events,
                                      seed=SEED)
    print(f"[setup] generated {len(events)} events at 30x in {gen_s:.1f}s",
          flush=True)
    phase("phase2", lambda: phase_kernel(wl))
    log_lines = []

    def e2e():
        res = run_e2e(wl, events, os.path.join(WORK, "out_single"),
                      log_lines)
        for line in log_lines:
            print(f"[phase3] {line}", flush=True)
        check_e2e(res, "phase3")
        print(f"[phase3] {res['sv_per_s']:.3f} SV/s on {card}", flush=True)

    phase("phase3", e2e)
    phase("phase4", phase_cohort)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


def e2e_child(args) -> int:
    """One multigrmpy run for --four-cards; writes its summary JSON."""
    gpu_devices()
    with open(os.path.join(args.child, "truth.json")) as f:
        events = json.load(f)
    log_lines = []
    res = run_e2e(args.child, events, args.child_out, log_lines)
    res["log"] = log_lines
    with open(os.path.join(args.child_out, "summary.json"), "w") as f:
        json.dump(res, f)
    return 0


def four_cards(args) -> int:
    """Phase 3's workload on one card, then sharded over four; the two
    processes run one after the other, so each card has one process."""
    build_s = build_libraries()
    wl, events, gen_s = make_workload("single", n_events=args.events,
                                      seed=SEED)
    print(f"[setup] built libraries in {build_s:.1f}s, generated "
          f"{len(events)} events in {gen_s:.1f}s", flush=True)
    summaries = {}
    for tag, env_extra in (("one_card", {"CUDA_VISIBLE_DEVICES": "0"}),
                           ("four_cards", {})):
        out_dir = os.path.join(WORK, f"out_{tag}")
        os.makedirs(out_dir, exist_ok=True)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", wl,
             "--child-out", out_dir],
            env=dict(os.environ, **env_extra))
        if proc.returncode != 0:
            die(f"{tag} run failed with exit code {proc.returncode}", 1)
        with open(os.path.join(out_dir, "summary.json")) as f:
            summaries[tag] = json.load(f)
        for line in summaries[tag]["log"]:
            print(f"[{tag}] {line}", flush=True)
        check_e2e(summaries[tag], tag)
    one, four = summaries["one_card"], summaries["four_cards"]
    assert one["devices"] == 1 and four["devices"] == 4, (one, four)
    assert any("ShardedPairedSW" in line for line in four["log"]), \
        "the four-card run did not shard events"

    def vcf_records(path):
        with gzip.open(path, "rt") as f:
            return [line for line in f if not line.startswith("#")]

    with gzip.open(one["genotypes_json"], "rb") as f:
        a = f.read()
    with gzip.open(four["genotypes_json"], "rb") as f:
        b = f.read()
    assert a == b, "genotypes.json differs between one and four cards"
    assert vcf_records(one["genotypes_vcf"]) == vcf_records(
        four["genotypes_vcf"]), "genotype VCF records differ"
    print(f"[four_cards] genotypes byte-identical: {len(a)} bytes of "
          f"genotypes.json, {len(vcf_records(one['genotypes_vcf']))} VCF "
          f"records; one card {one['sv_per_s']:.3f} SV/s, four cards "
          f"{four['sv_per_s']:.3f} SV/s", flush=True)
    devices = gpu_devices()
    print(nvidia_smi(), flush=True)
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded path and its "
                         "1-card comparison")
    ap.add_argument("--events", type=int, default=256,
                    help="events in the generated single-sample workload")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--child-out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    check_checkout()
    if args.child:
        return e2e_child(args)
    os.makedirs(WORK, exist_ok=True)
    try:
        return four_cards(args) if args.four_cards else one_card(args)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
