"""Multi-chip sharding tests on a virtual 8-device CPU mesh.

Validates that the shard_map-wrapped batch kernel produces bit-identical
paths to the NumPy oracle when a level's pair batch is sharded over the
mesh's "pairs" axis (the SPMD form of the reference's
per-GPU batch stealing, cuda/alignment-gpu.cu:231-252)."""
import numpy as np

import jax

from twilight_tpu.parallel import sharding

from conftest import random_profile_pair
from test_talco_kernel import nuc_matrix, pack_jax_batch, run_oracle


def test_virtual_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_kernel_matches_oracle(rng):
    mesh = sharding.make_pair_mesh()
    padlen, flen, marker = 256, 256, 1024
    kern = sharding.get_sharded_batch_kernel(
        padlen, flen, 6, marker, nuc_matrix().tobytes(), 6, mesh)

    cases = [(100 + 7 * i, 100 + 5 * i) for i in range(8)]
    pairs = [random_profile_pair(rng, r, q) for r, q in cases]
    b = sharding.pad_batch_to_mesh(len(pairs), mesh)
    assert b == 8
    out, tail = kern(*pack_jax_batch(pairs, padlen, flen))
    out, tail = np.asarray(out), np.asarray(tail)
    for i, (fr, fq) in enumerate(pairs):
        gold, gerr = run_oracle(fr, fq)
        assert int(tail[i, 1]) == gerr == 0
        assert int(tail[i, 0]) == len(gold)
        np.testing.assert_array_equal(out[i, :len(gold)], gold)
