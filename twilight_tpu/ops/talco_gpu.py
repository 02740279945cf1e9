"""TALCO-XDrop on NVIDIA GPUs: the CUDA kernel in talco_cuda.cu, called
from JAX through the foreign function interface.

The library is compiled with nvcc at first use, from the committed source
only, into native/build/ under a name keyed on the source, the flags and
the host (native.built_path), and registered as an FFI target for the CUDA
platform. The kernel reads the packed layout of ops/talco_jax.py (see
talco_jax.pack_pair_into) with `off = 0, tot = padlen`, and returns the
same (paths int8 [B, MAXALN], tail int32 [B, 3] = len, err, cells) as
talco_jax.get_batch_kernel.

Its band rows live in shared memory, so the static window FLEN is bounded
by the block's shared-memory plan (`max_window`); a pair whose band
outgrows it is aligned by the host kernel, which the batcher counts.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import threading

import numpy as np

from .. import native

SOURCE = os.path.join(os.path.dirname(__file__), "talco_cuda.cu")
TARGET = "twilight_talco_xdrop"
THREADS = 256
# Hopper: a block may opt in to 227 KB of the SM's 256 KB shared memory
SMEM_LIMIT = 232448
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_registered = []


def shared_bytes(flen: int, msize: int, threads: int = THREADS) -> int:
    """Dynamic shared memory of one block (talco_cuda.cu SharedBytes):
    14 band rows of FLEN + 2 words, the matrix, the reduction slots."""
    return (56 * (flen + 2) + 4 * msize * msize
            + 4 * 4 * 2 * (threads // 32) + 4 * 8)


def max_window(msize: int, threads: int = THREADS) -> int:
    """Widest power-of-two static window whose band fits shared memory."""
    w = 1
    while shared_bytes(2 * w, msize, threads) <= SMEM_LIMIT:
        w *= 2
    return w


def nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> str:
    import jax
    import jax.ffi
    flags = NVCC_FLAGS + ["-I", jax.ffi.include_dir()]
    return native.built_path("talco_cuda", [SOURCE], flags,
                             extra=jax.__version__)


def build_library() -> str:
    """Compile talco_cuda.cu for this host unless already built."""
    import jax.ffi
    so = library_path()
    if not os.path.exists(so):
        cmd = [nvcc(), *NVCC_FLAGS, "-I", jax.ffi.include_dir()]
        native.build(lambda out: cmd + ["-o", out, SOURCE], so)
    return so


def register() -> None:
    """Build (once) and register the FFI target for platform CUDA."""
    with _lock:
        if _registered:
            return
        import jax.ffi
        lib = ctypes.cdll.LoadLibrary(build_library())
        jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.TalcoXdrop),
                                    platform="CUDA")
        _registered.append(lib)


def maxaln(padlen: int) -> int:
    return 2 * padlen + 8


def call(ref, qry, meta_i, meta_f, matrix, *, padlen: int, flen: int,
         marker: int, threads: int = THREADS):
    """One launch over a batch (traceable: use under jit / shard_map).
    `ref`/`qry` are [B, padlen, P8] rows packed with off = 0."""
    import jax
    import jax.numpy as jnp
    b = ref.shape[0]
    out_types = (
        jax.ShapeDtypeStruct((b, maxaln(padlen)), jnp.int8),     # paths
        jax.ShapeDtypeStruct((b, 3), jnp.int32),                 # tail
        jax.ShapeDtypeStruct((b, marker + 1, flen), jnp.int8),   # tb
        jax.ShapeDtypeStruct((b, 2, marker + 1), jnp.int32),     # ftr
        jax.ShapeDtypeStruct((b, marker + 8), jnp.int8),         # seg
    )
    paths, tail, *_ = jax.ffi.ffi_call(TARGET, out_types)(
        ref, qry, meta_i, meta_f, matrix, padlen=np.int32(padlen),
        off=np.int32(0), flen=np.int32(flen), marker=np.int32(marker),
        threads=np.int32(threads))
    return paths, tail


@functools.lru_cache(maxsize=64)
def get_batch_kernel(padlen: int, flen: int, marker: int,
                     matrix_bytes: bytes, msize: int, mesh=None,
                     threads: int = THREADS):
    """Jitted fn(ref, qry, meta_i, meta_f) -> (paths, tail). With a mesh,
    the batch axis is split over its "pairs" axis by shard_map (pairs are
    independent: no collectives)."""
    import jax
    from jax.sharding import PartitionSpec as P

    if shared_bytes(flen, msize, threads) > SMEM_LIMIT:
        raise ValueError(f"window {flen} exceeds the shared-memory plan "
                         f"(max {max_window(msize, threads)})")
    register()
    matrix = np.frombuffer(matrix_bytes, np.float32).reshape(msize, msize)

    def local(ref, qry, meta_i, meta_f):
        return call(ref, qry, meta_i, meta_f, matrix, padlen=padlen,
                    flen=flen, marker=marker, threads=threads)

    if mesh is None:
        return jax.jit(local)
    return jax.jit(jax.shard_map(local, mesh=mesh,
                                 in_specs=(P("pairs"),) * 4,
                                 out_specs=(P("pairs"), P("pairs")),
                                 check_vma=False))
