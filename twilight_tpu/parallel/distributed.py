"""Multi-host execution: dispatch divide-and-conquer subtrees across hosts.

The reference processes subtrees SEQUENTIALLY in one process
(/root/reference/src/twilight-main.cpp:139-176) and merges through temp
files + `cat` (io.cpp:465-488). With several hosts, each owning local
devices, the natural upgrade is: partition the guide tree once
(deterministic on every host), round-robin subtrees to hosts by leaf-count
(largest first), run each host's subtrees on its local devices, then exchange
subtree-root profiles and lengths via a `jax.distributed` all-gather (or the
shared-filesystem checkpoint files when no distributed runtime is up —
the same .state.npz files --resume uses), and let host 0 run the merge pass
and write the final MSA.

Usage (one command per host):
    python -m twilight_tpu ... --hosts N --host-id I [-d shared_tmp]
With jax.distributed initialized (JAX_COORDINATOR_ADDRESS etc.), N/I default
to the process count/index.
"""
from __future__ import annotations

import os
import time
from typing import List, Sequence, Tuple


def assign_subtrees(sizes: Sequence[Tuple[str, int]], n_hosts: int
                    ) -> List[List[str]]:
    """Greedy balanced assignment: sort subtrees by leaf count descending,
    give each to the currently least-loaded host. Deterministic (ties break
    by subtree name) so every host computes the same assignment without
    communication."""
    order = sorted(sizes, key=lambda kv: (-kv[1], kv[0]))
    loads = [0] * n_hosts
    out: List[List[str]] = [[] for _ in range(n_hosts)]
    for name, cnt in order:
        h = min(range(n_hosts), key=lambda i: (loads[i], i))
        out[h].append(name)
        loads[h] += cnt
    return out


def detect_topology(args_hosts: int = 0, args_host_id: int = -1
                    ) -> Tuple[int, int]:
    """(n_hosts, host_id) from flags, else jax.distributed, else (1, 0)."""
    if args_hosts > 0:
        if args_host_id >= 0:
            return args_hosts, args_host_id
        if args_hosts == 1:
            return 1, 0
        try:
            import jax
            if jax.process_count() == args_hosts:
                return args_hosts, jax.process_index()
        except Exception:
            pass
        raise ValueError(
            "--hosts N > 1 requires --host-id (or an initialized "
            "jax.distributed runtime with a matching process count): "
            "defaulting every process to host 0 would compute only host "
            "0's subtree shard and hang the exchange barrier")
    try:
        import jax
        if jax.process_count() > 1:
            return jax.process_count(), jax.process_index()
    except Exception:
        pass
    return 1, 0


def detect_topology_implicit() -> Tuple[int, int]:
    """(n_hosts, host_id) from an already-initialized jax.distributed
    runtime; (1, 0) otherwise. Never imports or initializes jax itself, so
    flag-less single-host CLI runs pay no backend startup."""
    import sys
    j = sys.modules.get("jax")
    if j is None:
        return 1, 0
    try:
        from jax._src import distributed as _dist
        if _dist.global_state.client is None:
            return 1, 0
        return j.process_count(), j.process_index()
    except Exception:
        return 1, 0


def distributed_live() -> bool:
    """True when a real jax.distributed runtime spans >1 process."""
    n, _ = detect_topology_implicit()
    return n > 1


def exchange_subtree_states_collective(local: dict) -> dict:
    """All-gather per-subtree root states across hosts via jax collectives.

    `local` maps subtree id -> {msa_freq, aln_len, aln_num, aln_weight} for
    the subtrees THIS host computed. Profiles are ragged ([len, P] f32, one
    per subtree), so each host serializes its dict to one npz byte blob;
    blob lengths are all-gathered first, then the zero-padded blobs. Every
    host gets every subtree's root state without touching the filesystem —
    the reference communicates only through temp files (io.cpp:347-354);
    SURVEY §5's plan is exactly this all-gather at partition
    boundaries. The bulk subalignment FASTAs still live in the shared temp
    dir (they are the checkpoint/restart path and are only streamed once by
    host 0's transitivity writer).

    Collective: must be called by ALL processes. Acts as the barrier that
    guarantees every host's subalignment files are fully written (each host
    writes them before reaching this point).
    """
    import io

    import numpy as np
    from jax.experimental import multihost_utils

    buf = io.BytesIO()
    np.savez(buf, **{f"{sid}:{key}": np.asarray(val)
                     for sid, st in local.items()
                     for key, val in st.items()})
    payload = np.frombuffer(buf.getvalue(), dtype=np.uint8)
    sizes = multihost_utils.process_allgather(
        np.array([payload.size], dtype=np.int64))
    padded = np.zeros(int(sizes.max()), dtype=np.uint8)
    padded[:payload.size] = payload
    blobs = multihost_utils.process_allgather(padded)
    merged: dict = {}
    for h in range(blobs.shape[0]):
        blob = blobs[h, :int(sizes[h, 0])].tobytes()
        if not blob:
            continue
        z = np.load(io.BytesIO(blob))
        for k in z.files:
            sid, key = k.rsplit(":", 1)
            merged.setdefault(int(sid), {})[key] = z[k]
    return merged


def exchange_subtree_states(option, subtree_ids: Sequence[int],
                            timeout_s: float = 3600.0) -> None:
    """Barrier until every subtree's checkpoint exists in the shared temp
    dir. The .state.npz + subalignment files written per subtree ARE the
    exchanged payload (shared-FS collective); when a real jax.distributed
    runtime is up, the barrier itself rides a tiny psum so hosts don't spin
    on NFS metadata."""
    try:
        import jax
        import jax.numpy as jnp
        if jax.process_count() > 1:
            # cheap synchronization: all-reduce a unit so no host races
            # ahead of the slowest writer before checking files
            jax.block_until_ready(
                jax.pmap(lambda x: jax.lax.psum(x, "i"), axis_name="i")(
                    jnp.ones((jax.local_device_count(),))))
    except Exception:
        pass
    deadline = time.time() + timeout_s
    missing = list(subtree_ids)
    while missing:
        missing = [
            s for s in missing
            if not (os.path.exists(os.path.join(
                option.temp_dir, f"subtree-{s}.state.npz")))]
        if not missing:
            break
        if time.time() > deadline:
            raise TimeoutError(
                f"subtree checkpoints never appeared: {missing}")
        time.sleep(1.0)
