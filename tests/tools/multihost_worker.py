"""Worker entry for the 2-process jax.distributed CPU test
(tests/test_multihost.py): initializes the process group, runs the
multi-host grmpy pipeline on its event shard, and (process 0) writes the
merged results JSON."""
import json
import os
import sys


def main():
    coord, pid, nproc, wl, out = sys.argv[1:6]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

    import jax

    jax.config.update("jax_platforms", "cpu")

    from paragraph_tpu.genotyping.sample_info import load_manifest
    from paragraph_tpu.parallel import multihost
    from paragraph_tpu.pipeline.multigrmpy import (MultigrmpyOptions,
                                                   load_graph_description)

    multihost.initialize(coord, int(nproc), int(pid))
    assert jax.process_count() == int(nproc)
    assert jax.device_count() == 4 * int(nproc)
    assert len(jax.local_devices()) == 4

    opts = MultigrmpyOptions(
        input=os.path.join(wl, "candidates.vcf"),
        reference=os.path.join(wl, "ref.fa"),
        output=os.path.join(wl, f"mh_out{pid}"),
        split_type="superloci",
    )
    graphs = load_graph_description(opts)
    manifest = load_manifest(os.path.join(wl, "samples.txt"))
    results = multihost.run_grmpy_multihost(graphs, opts.reference,
                                            manifest)
    if int(pid) == 0:
        with open(out, "w") as f:
            json.dump(results, f, sort_keys=True)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
