"""Per-process entry for the real two-process jax.distributed test.

Each test subprocess runs this with a distinct process id; the two
processes form a gloo-backed CPU collective group, split the
divide-and-conquer subtrees between them, all-gather root states over the
network (parallel/distributed.py:exchange_subtree_states_collective), and
host 0 merges + writes the final MSA. Invoked by
test_distributed.py::test_two_process_jax_distributed.

Usage: python dist_runner.py PORT PROCESS_ID OUT_FILE TEMP_DIR
           [SEQ_FA TREE_NWK MAX_SUBTREE BACKEND NDEV]

The long form gives each process its own NDEV-device CPU mesh and runs
the device batcher per host (subtree dispatch x sharded kernel x
collective exchange — the exact composition of a real pod run).
"""
import os
import sys

import jax

# the test runs on CPU devices (gloo collectives), like the rest of the suite
jax.config.update("jax_platforms", "cpu")


def main() -> int:
    port, pid, out, temp = sys.argv[1:5]
    seq = sys.argv[5] if len(sys.argv) > 5 \
        else "/root/reference/dataset/RNASim.fa"
    tree = sys.argv[6] if len(sys.argv) > 6 \
        else "/root/reference/dataset/RNASim.nwk"
    msub = sys.argv[7] if len(sys.argv) > 7 else "200"
    backend = sys.argv[8] if len(sys.argv) > 8 else "native"
    if len(sys.argv) > 9:
        jax.config.update("jax_num_cpu_devices", int(sys.argv[9]))
        # pin every pair to this host's device mesh so the sharded
        # kernel really runs (both paths are bit-identical anyway)
        os.environ["TWILIGHT_FORCE_DEVICE"] = "1"
        os.environ["TWILIGHT_NO_STEAL"] = "1"
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=2, process_id=int(pid))
    from twilight_tpu import cli
    return cli.main(["-t", tree, "-i", seq,
                     "-m", msub, "-d", temp, "-k", "--backend", backend,
                     "--pair-batch", "8",
                     "--overwrite", "-o", out])


if __name__ == "__main__":
    sys.exit(main())
