"""No fallback hides the device: a failing device scorer raises out of
grmpy and multigrmpy instead of degrading to a slower engine, and the
engine that ran is named in every event's statistics."""
import gzip
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    from make_workload import generate

    out = str(tmp_path_factory.mktemp("wl"))
    generate(out, n_events=8, depth=6, seed=21)
    return out


class _Boom:
    def __init__(self, graphs, **kw):
        raise RuntimeError("synthetic device failure")


def _break_scorers(monkeypatch):
    import paragraph_tpu.ops.multi_sw as multi_sw
    import paragraph_tpu.parallel.distributed as distributed

    # both scorers: the mesh path shards through ShardedPairedSW, a
    # single device goes through PairedGraphSW
    monkeypatch.setattr(multi_sw, "PairedGraphSW", _Boom)
    monkeypatch.setattr(distributed, "ShardedPairedSW", _Boom)


@pytest.mark.parametrize("threads", [1, 2],
                         ids=["batch_path", "pipelined_path"])
def test_failing_device_scorer_raises(workload, monkeypatch, tmp_path,
                                      threads):
    """threads=1 takes the single-process batch path
    (grmpy.align_samples_batched); threads=2 the worker-pool pipeline
    (parallel_grmpy). Neither may fall back."""
    from paragraph_tpu.cli.main import main

    _break_scorers(monkeypatch)
    with pytest.raises(RuntimeError, match="synthetic device failure"):
        main(["multigrmpy", "-i", os.path.join(workload, "candidates.vcf"),
              "-m", os.path.join(workload, "samples.txt"),
              "-r", os.path.join(workload, "ref.fa"),
              "-o", str(tmp_path / "out"), "-t", str(threads)])


def test_engine_named_on_every_event(workload, tmp_path):
    from paragraph_tpu.pipeline.multigrmpy import MultigrmpyOptions, run

    result = run(MultigrmpyOptions(
        input=os.path.join(workload, "candidates.vcf"),
        manifest=os.path.join(workload, "samples.txt"),
        reference=os.path.join(workload, "ref.fa"),
        output=str(tmp_path / "out"), threads=1))
    with gzip.open(result["genotypes_json"], "rt") as f:
        records = json.load(f)
    assert len(records) == 9  # 8 events, one DELSNP split by line
    engines = {rec["samples"]["sample"]["engine"] for rec in records}
    assert engines == {"xla"}


def test_maybe_profile_noop_and_enabled(tmp_path, monkeypatch):
    """maybe_profile is a no-op without the env var and never raises
    with it set (profiler failures degrade to a warning)."""
    from paragraph_tpu.utils import profiling

    monkeypatch.delenv(profiling.ENV_VAR, raising=False)
    with profiling.maybe_profile("t"):
        x = 1
    assert x == 1

    monkeypatch.setenv(profiling.ENV_VAR, str(tmp_path))
    with profiling.maybe_profile("t"):
        x = 2
    assert x == 2
