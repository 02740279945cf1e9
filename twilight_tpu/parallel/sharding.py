"""Multi-chip execution: shard per-level pair batches over a device mesh.

The reference scales across GPUs with a TBB thread per device and atomic
round-robin batch stealing (/root/reference/src/cuda/alignment-gpu.cu:231-252)
— devices share nothing and results merge on the host. Here it is SPMD: one
`jax.sharding.Mesh` with a single "pairs" axis, the batched TALCO kernel
wrapped in `jax.shard_map` so each device runs its slice of the level's pair
batch. No collectives are needed inside a level (pairs are independent);
subtree-root profile exchange at divide-and-conquer merge boundaries is an
all-gather at the host layer.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np


def make_pair_mesh(devices: Optional[Sequence] = None, axis: str = "pairs"):
    """1-D mesh over all (or the given) devices."""
    import jax
    from jax.sharding import Mesh
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devs), (axis,))


@functools.lru_cache(maxsize=64)
def get_sharded_batch_kernel(padlen: int, flen: int, p: int, marker: int,
                             matrix_bytes: bytes, msize: int, mesh,
                             axis: str = "pairs"):
    """shard_map-wrapped batched TALCO kernel (talco_jax layout).

    All four args (ref, qry, meta_i, meta_f) carry a leading `pairs` axis
    and are sharded over `axis`. The batch size must be a multiple of
    the mesh size (hosts pad with dummy pairs, mirroring the reference's power-of-two launch rounding,
    alignment-gpu.cu:202-204).
    """
    import jax
    from jax.sharding import PartitionSpec as P

    from ..ops import talco_jax

    matrix = np.frombuffer(matrix_bytes, dtype=np.float32).reshape(msize,
                                                                   msize)
    batched = talco_jax.make_batched(padlen, flen, p, marker, matrix)
    # check_vma=False: the kernel's lax.while_loop carries start as
    # unvarying constants and become device-varying after the first
    # iteration, which the VMA checker rejects even though every output is
    # legitimately per-pair (fully sharded, no cross-device reuse).
    sharded = jax.shard_map(
        batched, mesh=mesh,
        in_specs=(P(axis),) * 4,
        out_specs=(P(axis), P(axis)),
        check_vma=False)
    return jax.jit(sharded)


def pad_batch_to_mesh(n_pairs: int, mesh) -> int:
    """Smallest batch >= n_pairs divisible by the mesh size."""
    size = mesh.devices.size
    return ((n_pairs + size - 1) // size) * size
