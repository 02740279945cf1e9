"""Sequence -> guide tree estimation.

Two distance modes:
  - unaligned sequences: hashed k-mer count profiles; distance is the
    cosine-angle metric d = -ln(max(cos, eps)) (Mash-like). The Gram matrix
    X @ X.T is a single large matmul — on a GPU in full f32 (precision
    pinned to HIGHEST, never TF32); NumPy otherwise.
  - aligned sequences (iterative re-estimation, replacing the workflow's
    FastTree step): normalized Hamming p-distance over non-gap columns,
    with gappy columns masked first (the reference workflow's reduceLen.py
    does the same masking before tree inference).

Scaling: PartTree-style recursion (MAFFT PartTree; the reference workflow
exposes it as the `parttree` tool option): when n > nj_cap, sample seeds,
NJ the seeds, assign every sequence to its nearest seed, recurse per group,
and graft subtrees onto the seed tree.
"""
from __future__ import annotations

import sys
import threading
from typing import List, Optional, Sequence

import numpy as np

from .nj import neighbor_joining

_ACCEL: List[bool] = []   # memoized probe result


def _maybe_accelerator() -> bool:
    """Whether JAX's default device is an accelerator (memoized)."""
    if _ACCEL:
        return _ACCEL[0]
    try:
        import jax
        ok = jax.devices()[0].platform != "cpu"
    except Exception:
        ok = False
    _ACCEL.append(ok)
    return ok


def _device_preferred(dev_fn, host_steps, deadline_s: float):
    """Prefer the device result (deterministic winner when the device
    answers — the device gram differs from host BLAS in low bits, so the
    winner must not be a timing race), but compute the host chunks WHILE
    waiting so a slow device (start-up, compile) costs at most the
    deadline, not deadline + host time."""
    import time as _t
    out: dict = {}
    t0 = _t.time()

    def _go():
        try:
            out["v"] = dev_fn(lambda: out.setdefault("probed", True))
        except BaseException as e:
            out["e"] = e

    th = threading.Thread(target=_go)
    th.start()
    host_res = None
    for step in host_steps:
        if step is not None:
            host_res = step
        if "v" in out or "e" in out:
            break
    if host_res is not None and "probed" not in out and "v" not in out:
        # the host finished before the device thread even got through
        # backend start-up; don't wait on it further
        return host_res
    th.join(max(0.0, deadline_s - (_t.time() - t0)))
    if th.is_alive():
        print(f"[twilight-tpu] device distance path exceeded "
              f"{deadline_s:.0f}s; using host result", file=sys.stderr)
        return host_res
    if "v" in out:
        return out["v"]
    if host_res is None:
        # device errored before the host generator ran to completion
        for step in host_steps:
            if step is not None:
                host_res = step
    return host_res


def _race_device(dev_fn, host_steps):
    """Device thread vs chunked host computation — both produce
    IDENTICAL values (exact integer counts / the same f32 matmul), so
    whichever finishes first wins and nothing waits on a slow device
    (same philosophy as the batcher's host work-stealing).
    `host_steps` is a generator that yields None per chunk and finally
    the result; the device result is polled between chunks."""
    out: dict = {}

    def _go():
        try:
            out["v"] = dev_fn()
        except BaseException as e:
            out["e"] = e

    th = threading.Thread(target=_go)
    th.start()
    res = None
    won = "host"
    for step in host_steps:
        if "v" in out:
            won = "device"
            res = out["v"]
            break
        if step is not None:
            res = step
    else:
        th.join(0.5)
    import os
    if os.environ.get("TWILIGHT_PROFILE"):
        print(f"  [profile] distance matrix: {won} path won",
              file=sys.stderr)
    return res


def kmer_profiles(seqs: Sequence[str], k: int = 8,
                  dim: int = 4096) -> np.ndarray:
    """Hashed k-mer count profile per sequence, L2-normalized f32 [n, dim].
    Byte-polynomial rolling hash — alphabet-agnostic (nucleotide or
    protein); windows containing gaps/ambiguity bytes ('-', '.', 'N', 'X')
    are dropped."""
    out = np.zeros((len(seqs), dim), dtype=np.float32)
    bad = np.zeros(256, dtype=bool)
    for b in b"-.NXnx*? ":
        bad[b] = True
    with np.errstate(over="ignore"):
        for si, s in enumerate(seqs):
            codes = np.frombuffer(s.upper().encode(), dtype=np.uint8)
            n = len(codes)
            if n < k:
                out[si, 0] = 1.0
                continue
            c = codes.astype(np.int64)
            invalid = bad[codes]
            h = np.zeros(n - k + 1, dtype=np.int64)
            ok = np.ones(n - k + 1, dtype=bool)
            for off in range(k):
                h = h * np.int64(131) + c[off:off + n - k + 1]
                ok &= ~invalid[off:off + n - k + 1]
            h = h[ok]
            if len(h) == 0:
                out[si, 0] = 1.0
                continue
            h = (h.astype(np.uint64)
                 * np.uint64(0x9E3779B97F4A7C15)).astype(np.int64)
            h &= np.int64(2**63 - 1)
            idx = (h >> np.int64(20)) % dim
            np.add.at(out[si], idx, 1.0)
            norm = np.linalg.norm(out[si])
            if norm > 0:
                out[si] /= norm
    return out


def _gram(x: np.ndarray) -> np.ndarray:
    """x @ x.T — device-preferred with a deadline when the host estimate
    justifies the round-trip (BLAS sgemm does ~3e10 flop/s on one core;
    a device costs start-up, a compile and a transfer, so small grams
    never go out). The host row-block gemm runs WHILE waiting, so a slow
    device costs at most the deadline; the winner is deterministic
    (device when it answers), since device and BLAS grams differ in low
    float bits."""
    n, dim = x.shape
    host_est_s = 2.0 * n * n * dim / 3e10

    def _host_steps():
        g = np.empty((n, n), dtype=np.float32)
        blk = max(512, n // 8)
        for i0 in range(0, n, blk):
            g[i0:i0 + blk] = x[i0:i0 + blk] @ x.T
            yield None
        yield g

    if host_est_s > 20.0:
        def _dev(mark_probed):
            # the accelerator probe runs INSIDE the device thread, so the
            # host row blocks compute while the backend starts
            if not _maybe_accelerator():
                raise RuntimeError("no accelerator")
            mark_probed()
            return np.asarray(gram_device_fn()(x))

        return _device_preferred(_dev, _host_steps(),
                                 deadline_s=max(90.0, host_est_s))
    return x @ x.T


def gram_device_fn():
    """Jitted device gram, pinned to full f32: a default-precision f32
    matmul may run in TF32 on a GPU, which keeps about three digits."""
    import jax
    import jax.numpy as jnp
    return jax.jit(lambda a: jnp.matmul(a, a.T,
                                        precision=jax.lax.Precision.HIGHEST))


def pairwise_distances(profiles: np.ndarray) -> np.ndarray:
    """Cosine-angle distance matrix from L2-normalized profiles."""
    cos = np.clip(_gram(profiles), 1e-6, 1.0)
    d = -np.log(cos)
    np.fill_diagonal(d, 0.0)
    return d.astype(np.float64)


def msa_distances(rows: Sequence[str], max_cols: int = 4096,
                  gappy: float = 0.9) -> np.ndarray:
    """p-distances from aligned rows: mask gappy columns, subsample columns,
    then mismatch fraction over mutually non-gap positions.

    On a JAX device the match/valid pair counts are per-letter one-hot
    contractions (bf16 0/1 inputs with f32 accumulation — counts are
    exact); the per-row NumPy loop is the fallback. At 10k
    rows the device path turns the ~n^2*cols hotspot of the iterative
    workflow's re-estimation step from minutes into seconds."""
    n = len(rows)
    mat = np.frombuffer("".join(rows).upper().encode(),
                        dtype=np.uint8).reshape(n, -1)
    is_gap = (mat == ord("-")) | (mat == ord("."))
    keep = is_gap.mean(axis=0) < gappy
    mat = mat[:, keep]
    is_gap = is_gap[:, keep]
    if mat.shape[1] > max_cols:
        step = mat.shape[1] // max_cols
        mat = mat[:, ::step]
        is_gap = is_gap[:, ::step]
    if n >= 256:
        # BLAS form of the same counts (one sgemm per letter + one for
        # the valid mask; counts are exact integers in f32): the SAME
        # distances as the device einsums bit-for-bit, so the two paths
        # can race — whichever finishes first wins, with no output
        # dependence on timing.
        def _host_steps():
            letters = [int(v) for v in np.unique(mat)
                       if v not in (ord("-"), ord("."))]
            valid = (~is_gap).astype(np.float32)
            m = np.zeros((n, n), dtype=np.float32)
            for l in letters:
                a = ((mat == l) & ~is_gap).astype(np.float32)
                m += a @ a.T
                yield None
            b = valid @ valid.T
            d = (b.astype(np.float64) - m.astype(np.float64)) \
                / np.maximum(b.astype(np.float64), 1.0)
            np.fill_diagonal(d, 0.0)
            yield d

        # cost gate before the device probe: ~6 sgemms of [n, cols] —
        # below ~20 s of host BLAS the device's start-up and compile cost
        # more than it could save
        host_est_s = 6.0 * 2.0 * n * n * mat.shape[1] / 3e10
        if host_est_s > 20.0:
            def _dev():
                # probe inside the racing thread (see _gram): a slow
                # backend start loses the race instead of stalling
                if not _maybe_accelerator():
                    raise RuntimeError("no accelerator")
                return _msa_distances_device(mat, is_gap)

            return _race_device(_dev, _host_steps())
        for step in _host_steps():
            if step is not None:
                return step
    d = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        both = ~(is_gap[i] | is_gap)          # [n, cols]
        diff = (mat[i] != mat) & both
        denom = np.maximum(both.sum(axis=1), 1)
        d[i] = diff.sum(axis=1) / denom
    np.fill_diagonal(d, 0.0)
    return d


def _msa_distances_device(mat: np.ndarray, is_gap: np.ndarray) -> np.ndarray:
    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform == "cpu":
        # counts are exact integers either way, so both paths give the
        # same distances — but the NumPy loop is the better CPU engine
        raise RuntimeError("no accelerator; use the NumPy path")
    letters = [int(v) for v in np.unique(mat)
               if v not in (ord("-"), ord("."))]
    n, cols = mat.shape
    oh = np.stack([(mat == l) for l in letters]).astype(np.float16)
    valid = (~is_gap).astype(np.float16)

    @jax.jit
    def counts(ohh, vh):
        ohh = ohh.astype(jnp.bfloat16)
        vh = vh.astype(jnp.bfloat16)
        m = jnp.einsum("lnc,lmc->nm", ohh, ohh,
                       preferred_element_type=jnp.float32)
        b = jnp.einsum("nc,mc->nm", vh, vh,
                       preferred_element_type=jnp.float32)
        return m, b

    m, b = counts(oh, valid)
    m = np.asarray(m, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    d = (b - m) / np.maximum(b, 1.0)
    np.fill_diagonal(d, 0.0)
    return d


def _nj_or_recurse(dist: np.ndarray, names: List[str], nj_cap: int,
                   rng: np.random.Generator) -> str:
    n = len(names)
    if n <= nj_cap:
        return neighbor_joining(dist, names)
    # PartTree-style: seeds -> NJ -> assign -> recurse
    n_seeds = max(2, int(np.sqrt(n)))
    seeds = rng.choice(n, size=n_seeds, replace=False)
    assign = np.argmin(dist[:, seeds], axis=1)
    groups = [np.nonzero(assign == gi)[0] for gi in range(n_seeds)]
    sub_newicks: List[Optional[str]] = [None] * n_seeds
    kept_seeds: List[int] = []
    for gi, grp in enumerate(groups):
        if len(grp) == 0:
            continue
        kept_seeds.append(gi)
        sub = dist[np.ix_(grp, grp)]
        nw = _nj_or_recurse(sub, [names[i] for i in grp], nj_cap, rng)
        sub_newicks[gi] = nw[:-1].rstrip()  # strip ';'
    if len(kept_seeds) == 1:
        return sub_newicks[kept_seeds[0]] + ";"
    seed_idx = seeds[kept_seeds]
    seed_dist = dist[np.ix_(seed_idx, seed_idx)]
    # the grafting below splices sub-newicks over placeholder leaf labels
    # via str.replace; grow the tag until no sequence name contains it so a
    # name like "x__G1__y" can never be rewritten (every placeholder
    # contains the tag, so tag-free names are replace-safe)
    tag = "__G"
    while any(tag in nm for nm in names):
        tag = "_" + tag
    placeholder = [f"{tag}{gi}__" for gi in kept_seeds]
    skeleton = neighbor_joining(seed_dist, placeholder)
    for gi in kept_seeds:
        skeleton = skeleton.replace(f"{tag}{gi}__", sub_newicks[gi])
    return skeleton


def build_guide_tree(names: Sequence[str], seqs: Sequence[str],
                     aligned: bool = False, k: int = 8,
                     nj_cap: int = 2000, seed: int = 0) -> str:
    """Estimate a Newick guide tree for the given sequences.

    aligned=False: k-mer sketch distances (initial iteration).
    aligned=True: MSA p-distances (re-estimation between iterations).
    """
    import os
    import time
    t0 = time.time()
    if aligned:
        dist = msa_distances(seqs)
    else:
        prof = kmer_profiles(seqs, k=k)
        if os.environ.get("TWILIGHT_PROFILE"):
            print(f"  [profile] k-mer profiles: {time.time() - t0:.1f}s",
                  file=sys.stderr)
        dist = pairwise_distances(prof)
    rng = np.random.default_rng(seed)
    print(f"[twilight-tpu] estimated distances for {len(names)} sequences "
          f"in {time.time() - t0:.1f}s", file=sys.stderr)
    t1 = time.time()
    nwk = _nj_or_recurse(dist, list(names), nj_cap, rng)
    if os.environ.get("TWILIGHT_PROFILE"):
        print(f"  [profile] NJ/PartTree: {time.time() - t1:.1f}s",
              file=sys.stderr)
    return nwk
