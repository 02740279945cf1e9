"""Host batcher for the TALCO-XDrop device kernels.

Plays the role of the reference's GPU batch manager
(/root/reference/src/cuda/alignment-gpu.cu:182-450): buckets a level's pairs
by padded length, packs profiles (talco_jax.pack_pair_into), launches one
batched kernel per chunk of a bucket, and handles the per-pair outcomes:
  - error 6 (live band outgrew the kernel's static FLEN window): relaunch on
    a wider window — pairs start small (FLEN=512) because the X-drop band
    is usually narrow; past the widest window the device can hold, the
    pair is aligned by the host kernel and counted;
  - errors 1/2 (reference semantics: band collapse/limit): apply the
    reference's retry ladder (task != 0) or defer (task 0);
  - errors 3/4: the host ladder recomputes the pair.

Kernel per platform: `gpu` runs the CUDA kernel (ops/talco_gpu.py), any
other JAX platform runs the XLA-compiled plain version (ops/talco_jax.py).
With several local devices, launches are split over a 1-D "pairs" mesh by
shard_map. A launch that fails raises; it is never retried on the host.
"""
from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Options, Params

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# persistent compile cache when JAX_COMPILATION_CACHE_DIR is unset: one
# fixed path, so every run of this checkout finds what earlier runs cached
CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def select_devices(devs, option):
    """--devices/--device-index semantics of the reference GPU build
    (cuda/gpu-info.cu:14-61): the count is bounds-checked, an explicit
    index list must match the count, and every index must exist. Invalid
    selections are user errors that exit(1) like the reference — they do
    not fall back to the host kernel."""
    num, idx = option.device_num, option.device_index
    if num is None and idx is None:
        return devs
    maxn = len(devs)
    n = num if num is not None else maxn
    if n < 0 or n > maxn:
        print(f"ERROR: Invalid number of devices. Please request between "
              f"0 and {maxn}.", file=sys.stderr)
        raise SystemExit(1)
    if idx is not None:
        if len(idx) != n:
            print("ERROR: the number of requested devices does not match "
                  "the number of specified device indexes.",
                  file=sys.stderr)
            raise SystemExit(1)
        for i in idx:
            if i >= maxn or i < 0:
                print("ERROR: specified device index >= the number of "
                      "devices", file=sys.stderr)
                raise SystemExit(1)
        chosen = [devs[i] for i in idx]
    else:
        chosen = devs[:n]
    if not chosen:
        # --devices 0: host-only; cli.main skips kernel creation, but a
        # direct DeviceTalco caller must not index an empty list
        raise RuntimeError("0 devices requested")
    print(f"Maximum available devices: {maxn}. Using {len(chosen)} "
          f"devices.", file=sys.stderr)
    return chosen


def local_devices(jax_mod, backend: str):
    """This process's devices for --backend gpu|cpu, or JAX's default
    platform for auto. local_devices, not devices: under jax.distributed
    jax.devices() includes other hosts' devices, which must not enter this
    host's pairs mesh."""
    if backend in ("gpu", "cpu"):
        return jax_mod.local_devices(backend=backend)
    return jax_mod.local_devices()


def compile_cache_dir(platform: str) -> Optional[str]:
    """Where compiled programs persist: JAX_COMPILATION_CACHE_DIR when set
    (JAX reads it itself), else CACHE_DIR for GPU programs. CPU programs
    are not cached: their artifacts carry the host's machine features."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return CACHE_DIR if platform == "gpu" else None


def route_for(platform: str) -> str:
    """Kernel route: the CUDA kernel on GPUs, XLA's compile of talco_jax
    elsewhere."""
    return "cuda" if platform == "gpu" else "xla"


class _Deferred:
    """Device verdict for a task-0 pair whose DP failed (error 1/2): the
    reference defers it, and the host ladder would reach the same error,
    so it is not re-run."""

    def __repr__(self):
        return "DEFERRED"


DEFERRED = _Deferred()

# counters of the most recently closed batcher (read by chip_smoke.py)
LAST_STATS: Dict[str, object] = {}


class DeviceTalco:
    # align_pairs may pipeline the post phase against this call
    supports_on_final = True

    def __init__(self, option: Options, param: Params):
        import jax  # deferred so numpy-only runs never touch jax

        from . import talco_jax
        self._jax = jax
        self.option = option
        self.param = param
        devs = select_devices(local_devices(jax, option.device_backend),
                              option)
        self.device = devs[0]
        self.platform = self.device.platform
        self.route = route_for(self.platform)
        cache = compile_cache_dir(self.platform)
        if cache and not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update("jax_compilation_cache_dir", cache)
        # multi-device: a 1-D "pairs" mesh over the selected devices;
        # launches are sharded over it with shard_map (the reference's
        # multi-GPU round-robin batch stealing, cuda/alignment-gpu.cu:
        # 231-252, as SPMD data parallelism)
        self.mesh = None
        self.mesh_size = 1
        if len(devs) > 1 and not os.environ.get("TWILIGHT_NO_MESH"):
            from jax.sharding import Mesh
            self.mesh = Mesh(np.array(devs), ("pairs",))
            self.mesh_size = len(devs)
        # every (padlen, window, route, sharded) launch shape requested:
        # lets tests and dryrun_multichip assert which routes ran
        self.kernel_requests: list = []
        self.marker = 1 << 10
        self.base_flen = 1 << 12          # reference fLen (CPU semantics)
        # starting static FLEN window (smaller = cheaper launches, more
        # error-6 relaunches when a band outgrows it)
        self.init_window = int(os.environ.get("TWILIGHT_INIT_WINDOW",
                                              1 << 9))
        self.p = 6 if option.type == "n" else 22
        self.p8 = talco_jax.p8_of(self.p)
        self.matrix_bytes = param.scoring_matrix.astype(np.float32).tobytes()
        self.msize = param.matrix_size
        if self.route == "cuda":
            from . import talco_gpu
            self.max_window = talco_gpu.max_window(self.msize)
            talco_gpu.register()   # build the library now: fail at start
        else:
            self.max_window = 1 << 15
        self.stats = dict(device=0, stolen=0, window_host=0, rechecked=0,
                          launches=0, cells=0,
                          pairs_per_device=[0] * self.mesh_size)

    def describe(self) -> str:
        kern = ("CUDA kernel" if self.route == "cuda"
                else "XLA-compiled talco_jax")
        return (f"{self.platform} x{self.mesh_size} "
                f"({self.device.device_kind}), {kern}")

    def close(self) -> bool:
        """Publish this batcher's counters; launches are always joined
        before a call returns, so nothing is left running."""
        LAST_STATS.clear()
        LAST_STATS.update(self.stats, describe=self.describe())
        if self.stats["window_host"] or self.stats["rechecked"]:
            print(f"[twilight-tpu] device pairs: {self.stats['device']} "
                  f"resolved, {self.stats['stolen']} host-stolen, "
                  f"{self.stats['window_host']} wider than the device "
                  f"window (host), {self.stats['rechecked']} rechecked on "
                  f"the host (errors 3/4)", file=sys.stderr)
        return True

    def _batch_cap(self, padlen: int, window: int) -> int:
        """Most pairs per launch per device: --pair-batch for the 2048
        bucket at the starting window, scaled down for longer buckets
        (input bytes per launch stay constant) and wider windows (the
        per-pair traceback scratch grows with the window)."""
        cap = max(1, self.option.pair_batch)
        cap = cap * 2048 // max(padlen, 2048)
        cap = cap * self.init_window // max(window, self.init_window)
        return max(1, cap)

    def _launch_batch(self, n: int, padlen: int, window: int) -> int:
        """Launch size for n pending pairs. CUDA: a power of two times the
        mesh size, at most the cap (its launches compile in no time, and
        unused slots still cost input bytes). XLA: always the cap, one
        compiled program per (padlen, window) — a vmapped while loop runs
        as long as its longest pair, so unused slots cost little there."""
        nm = self.mesh_size
        cap = self._batch_cap(padlen, window)
        if self.route == "xla":
            return cap * nm
        per_dev = _next_pow2(max(1, -(-n // nm)))
        while per_dev > cap:
            per_dev //= 2
        return per_dev * nm

    def _kernel(self, padlen: int, flen: int):
        """(fn(ref, qry, meta_i, meta_f) -> (paths, tail), off, tot)."""
        sharded = self.mesh is not None
        self.kernel_requests.append((padlen, flen, self.route, sharded))
        mesh = self.mesh if sharded else None
        if self.route == "cuda":
            from . import talco_gpu
            return (talco_gpu.get_batch_kernel(
                padlen, flen, self.marker, self.matrix_bytes, self.msize,
                mesh), 0, padlen)
        if mesh is None:
            from . import talco_jax
            fn = talco_jax.get_batch_kernel(padlen, flen, self.p, self.marker,
                                            self.matrix_bytes, self.msize)
        else:
            from ..parallel import sharding
            fn = sharding.get_sharded_batch_kernel(
                padlen, flen, self.p, self.marker, self.matrix_bytes,
                self.msize, mesh)
        return fn, flen, 2 * flen + padlen

    def __call__(self, prepared, metas, database, option, param,
                 on_final=None) -> List[Optional[np.ndarray]]:
        import queue

        from ..pipeline.aligner import host_pool_size
        self._stolen_ids: set = set()
        note = on_final or (lambda i, p: None)
        task = database.current_task
        n = len(prepared)
        results: List[Optional[np.ndarray]] = [None] * n

        flen_param = [self.base_flen] * n   # reference ladder state
        xdrop = [int(1000 * -1 * param.gap_extend)] * n
        window = [self.init_window] * n     # static FLEN escalation state

        pending: List[int] = []
        for i, prep in enumerate(prepared):
            lens = prep[4]
            if lens[0] > 0 and lens[1] > 0:
                pending.append(i)
            else:
                note(i, None)  # zero-length side: post handles directly

        max_rounds = 30
        rounds = 0
        while pending and rounds < max_rounds:
            rounds += 1
            buckets: Dict[Tuple[int, int], List[int]] = {}
            for i in pending:
                # canonical padded lengths: every run compiles the same
                # few programs
                m = max(prepared[i][4])
                padlen = 2048 if m <= 2048 else (
                    32768 if m <= 32768 else _next_pow2(m))
                buckets.setdefault((padlen, window[i]), []).append(i)
            pending = []

            # phase 1: pack on the main thread, then hand each launch to
            # its own thread for dispatch and materialization; both release
            # the GIL, so the main thread steals host work meanwhile
            launches = []
            resq: "queue.Queue" = queue.Queue()
            threads = []

            def _run(li, kern, args):
                try:
                    with self._jax.default_device(self.device):
                        paths, tail = kern(*args)
                    paths.copy_to_host_async()
                    tail.copy_to_host_async()
                    resq.put((li, (np.asarray(paths), np.asarray(tail))))
                except Exception as exc:  # surface in main thread
                    resq.put((li, exc))

            for (padlen, w), idxs in buckets.items():
                if os.environ.get("TWILIGHT_PROFILE") \
                        and w > self.init_window:
                    print(f"    [dev] escalated bucket: padlen={padlen} "
                          f"window={w} pairs={len(idxs)}", file=sys.stderr)
                # sort by size so each launch holds similar pairs
                idxs.sort(key=lambda i: -(prepared[i][4][0]
                                          + prepared[i][4][1]))
                kern, off, tot = self._kernel(padlen, w)
                lo = 0
                while lo < len(idxs):
                    bs = self._launch_batch(len(idxs) - lo, padlen, w)
                    placed = self._place(idxs[lo:lo + bs], bs)
                    lo += bs
                    args = self._pack_batch(placed, prepared, metas, task,
                                            padlen, off, tot, bs,
                                            flen_param, xdrop)
                    li = len(launches)
                    launches.append((placed, padlen, w))
                    self.stats["launches"] += 1
                    for slot, _ in placed:
                        self.stats["pairs_per_device"][
                            slot * self.mesh_size // bs] += 1
                    th = threading.Thread(target=_run, args=(li, kern, args))
                    th.start()
                    threads.append(th)

            # phase 2: steal pairs onto the native host kernel while device
            # results are in flight. Both paths produce bit-identical
            # alignments, so whichever finishes first wins. Steal from the
            # tail: those results arrive last. On multi-core hosts extra
            # stealer threads drain the stack concurrently (reference: TBB
            # over the pair batch, alignment-cpu.cpp:46). A pair enters
            # host_done at CLAIM time; its result may land a moment later,
            # which is safe because both paths produce the same bits and
            # stealers are joined before results are read.
            host_done: set = set()
            # TWILIGHT_NO_STEAL pins every pair to the device path (used to
            # certify the device kernels and for clean device profiling)
            steal_stack = [] if os.environ.get("TWILIGHT_NO_STEAL") \
                else [i for (placed, *_) in launches for _, i in placed]
            steal_lock = threading.Lock()

            def _claim():
                with steal_lock:
                    while steal_stack:
                        cand = steal_stack.pop()
                        if cand not in host_done:
                            host_done.add(cand)
                            return cand
                return None

            def _steal_one(i):
                results[i] = self._host_align(prepared[i], metas[i], task)
                self._stolen_ids.add(i)
                note(i, results[i])

            def _stealer():
                while True:
                    i = _claim()
                    if i is None:
                        return
                    _steal_one(i)

            stealers = []
            for _ in range(min(host_pool_size(self.option) - 1,
                               len(steal_stack))):
                th = threading.Thread(target=_stealer)
                th.start()
                stealers.append(th)

            collected: set = set()
            try:
                while len(collected) < len(launches):
                    try:
                        li, arr = resq.get_nowait()
                    except queue.Empty:
                        i = _claim()
                        if i is not None:
                            _steal_one(i)
                            continue
                        if all(all(p in host_done
                                   for _, p in launches[lj][0])
                               for lj in range(len(launches))
                               if lj not in collected):
                            break   # the host took every remaining pair
                        try:
                            li, arr = resq.get(timeout=0.2)
                        except queue.Empty:
                            continue
                    collected.add(li)
                    if isinstance(arr, Exception):
                        raise arr
                    self._collect(launches[li], arr, results, prepared,
                                  metas, task, host_done, pending, window,
                                  flen_param, xdrop, note)
            finally:
                for th in stealers:
                    th.join()
                for th in threads:
                    th.join()
            self.stats["stolen"] += len(host_done)
        for i in pending:
            results[i] = None
            note(i, None)
        if os.environ.get("TWILIGHT_PROFILE"):
            print(f"    [dev] level done: device={self.stats['device']} "
                  f"host-stolen={len(self._stolen_ids)} "
                  f"steal_dp={getattr(self, '_steal_s', 0.0):.2f}s",
                  file=sys.stderr)
            self._steal_s = 0.0
        return results

    def _host_align(self, prep, meta, task):
        """Reference retry ladder on the native host kernel (same result
        bits as the device path; see pipeline/aligner.py)."""
        import time as _t
        t0 = _t.time()
        try:
            from ..pipeline.aligner import _run_talco_with_retries
            freq_ref, freq_qry, _, _, lens, gap_op, gap_ex = prep
            rnum, qnum = meta[2], meta[3]
            gap_char_zero = (task in (1, 2) or rnum > 10000 or qnum > 10000)
            path, needs_fallback = _run_talco_with_retries(
                freq_ref[:lens[0]], freq_qry[:lens[1]], gap_op, gap_ex,
                (float(rnum), float(qnum)), lens, self.param, gap_char_zero,
                task, self.option)
            return DEFERRED if needs_fallback else path
        finally:
            self._steal_s = getattr(self, "_steal_s", 0.0) + _t.time() - t0

    def _collect(self, launch, out, results, prepared, metas, task,
                 host_done, pending, window, flen_param, xdrop,
                 note=lambda i, p: None):
        """Postprocess one launch's materialized (paths, tail), skipping
        host-stolen pairs: success, window escalation (error 6), the
        reference retry ladder (errors 1/2), or a host recheck (3/4)."""
        placed, padlen, w = launch
        paths, tail = out
        for bi, i in placed:
            if i in host_done:
                continue
            ln, e, cells = (int(v) for v in tail[bi])
            self.stats["cells"] += cells
            if e == 0:
                results[i] = paths[bi, :ln].copy()
            elif e == 6:
                if window[i] < self.max_window:
                    window[i] = min(window[i] * 4, self.max_window)
                    pending.append(i)
                    continue
                # the band is wider than the device can hold
                self.stats["window_host"] += 1
                print(f"[twilight-tpu] pair band wider than the device "
                      f"window {self.max_window}: aligned on the host",
                      file=sys.stderr)
                results[i] = self._host_align(prepared[i], metas[i], task)
                note(i, results[i])
                continue
            elif e in (3, 4):
                self.stats["rechecked"] += 1
                results[i] = None
                note(i, None)
                continue
            elif task == 0:
                results[i] = DEFERRED
            else:
                lens = prepared[i][4]
                if e == 2:
                    flen_param[i] = min(
                        int(flen_param[i] * 1.2) << 1, min(lens))
                elif e == 1:
                    xdrop[i] = int(xdrop[i] * 2)
                    flen_param[i] = min(
                        int(xdrop[i] * 4) << 1, min(lens))
                # ladder growth may need a wider window too
                pending.append(i)
                continue
            self.stats["device"] += 1
            note(i, results[i])

    def _place(self, chunk, batch):
        """Launch slots for a size-sorted chunk: [(slot, pair)]. Mesh
        shard d owns slots [d*per, (d+1)*per); dealing the pairs round-
        robin over the shards gives each a similar share and similar
        sizes, however full the launch is."""
        nm = self.mesh_size
        per = batch // nm
        return [(d * per + j, c) for d in range(nm)
                for j, c in enumerate(chunk[d::nm])]

    def _pack_batch(self, placed, prepared, metas, task, padlen, off, tot,
                    batch, flen_param, xdrop):
        """Packed (ref, qry, meta_i, meta_f) for one launch; unused slots
        hold length-1 dummy pairs whose DP exits at once."""
        from . import talco_jax
        go, ge = self.param.gap_open, self.param.gap_extend
        ref = np.zeros((batch, tot, self.p8), dtype=np.float32)
        qry = np.zeros((batch, tot, self.p8), dtype=np.float32)
        meta_i = np.empty((batch, 4), dtype=np.int32)
        meta_i[:] = (1, 1, self.base_flen, 5000)
        meta_f = np.empty((batch, 5), dtype=np.float32)
        meta_f[:] = (1.0, 1.0, 0.0, go, ge)
        for bi, i in placed:
            freq_ref, freq_qry, _, _, lens, gap_op, gap_ex = prepared[i]
            rnum, qnum = metas[i][2], metas[i][3]
            talco_jax.pack_pair_into(
                ref[bi], qry[bi], freq_ref[:lens[0]], freq_qry[:lens[1]],
                gap_op, gap_ex, padlen, off)
            zero_gc = (task in (1, 2) or rnum > 10000 or qnum > 10000)
            meta_i[bi] = (lens[0], lens[1], flen_param[i], xdrop[i])
            meta_f[bi] = (rnum, qnum, 0.0 if zero_gc else ge, go, ge)
        return ref, qry, meta_i, meta_f


_persist_cache: Dict[tuple, "DeviceTalco"] = {}


class LazyDeviceKernel:
    """Non-blocking device-kernel handle for `--backend auto`.

    Building a DeviceTalco initializes the JAX backend and, on a GPU,
    builds the CUDA library — paid before the first pair aligns when built
    inline. This wrapper builds it in a background thread instead:
    align_pairs treats the kernel as absent while it is still building
    (early leaf levels run on the native host kernel), then dispatches to
    the device from the level after construction finishes. A failed build
    downgrades the run to host-only. Both engines are bit-identical, so
    WHERE each level runs never changes output bytes."""

    def __init__(self, option: Options, param: Params):
        self._inner = None
        self._err = None

        def _build():
            try:
                inner = DeviceTalco(option, param)
            except BaseException as e:  # incl. SystemExit from selection
                self._err = e
                print(f"[twilight-tpu] backend auto: device kernel "
                      f"unavailable ({e}); using the native host kernel",
                      file=sys.stderr)
                return
            print(f"[twilight-tpu] backend auto: DP on {inner.describe()}",
                  file=sys.stderr)
            self._inner = inner

        self._th = threading.Thread(target=_build, daemon=True)
        self._th.start()

    def poll_ready(self) -> bool:
        """True once the underlying batcher exists; False while building
        or after a failed build (align_pairs then skips the device)."""
        return self._inner is not None

    def __call__(self, *a, **k):
        return self._inner(*a, **k)

    def __getattr__(self, name):
        inner = object.__getattribute__(self, "_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    def close(self, timeout: float = 2.0) -> bool:
        self._th.join(timeout)
        inner = self._inner
        if inner is not None:
            return inner.close()
        return True


def make_device_kernel(option: Options, param: Params):
    if option.device_backend == "numpy":
        return None
    if (option.device_backend == "auto"
            and option.device_num is None and option.device_index is None
            and not os.environ.get("TWILIGHT_FORCE_DEVICE")
            and not os.environ.get("TWILIGHT_KERNEL_PERSIST")
            and not os.environ.get("TWILIGHT_NO_LAZY")):
        # auto = opportunistic: never let device init delay the host
        # pipeline. Explicit backends/selections keep the blocking build
        # (their errors must surface with the reference's exit semantics);
        # the workflow's persistent cache also stays synchronous.
        return LazyDeviceKernel(option, param)
    if os.environ.get("TWILIGHT_KERNEL_PERSIST"):
        # workflow mode: cli.main runs several times in one process
        # (iterative/placement iterations) — reuse the DeviceTalco so the
        # compiled programs carry across iterations
        key = (option.device_backend, option.type, option.pair_batch,
               param.scoring_matrix.tobytes(),
               float(param.gap_open), float(param.gap_extend))
        kern = _persist_cache.get(key)
        if kern is not None:
            kern.option = option
            kern.param = param
            return kern
        kern = DeviceTalco(option, param)
        kern.persistent = True
        _persist_cache[key] = kern
        return kern
    kern = DeviceTalco(option, param)
    if option.device_backend == "auto":
        print(f"[twilight-tpu] backend auto: DP on {kern.describe()}",
              file=sys.stderr)
    return kern


def close_persistent() -> None:
    """Close all cached kernels (workflow teardown)."""
    for kern in _persist_cache.values():
        kern.close()
    _persist_cache.clear()
