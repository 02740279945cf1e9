"""Batch pair aligner: per-level pipeline around the DP kernel.

Reference flow: /root/reference/src/alignment-cpu.cpp:36-183 — per pair:
profile → consensus → gappy removal → PSGP → TALCO DP (retry ladder on
band/x-drop errors) → splice gappy columns back → merge profiles → apply
path. The DP itself is pluggable: the NumPy oracle (exact reference
semantics), the native host kernel, or the batched device kernel; everything
around it is host code.
"""
from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

_PROFILE = bool(os.environ.get("TWILIGHT_PROFILE"))

from ..config import MERGE_MSA, PLACE_WO_TREE, Options, Params
from ..core.seqdb import SequenceDB
from ..ops import talco_host, talco_np
from ..ops.device_kernel import DEFERRED
from . import helpers

F32 = np.float32

# Host DP seconds per profile column, measured once at startup on THIS
# machine (one ~512-col pair through the active host kernel). Drives the
# device-vs-host dispatch estimate — the analogue of the reference's
# "GPU only when pairs >= 3*cpuNum" rule (cuda/alignment-gpu.cu:12-16).
# Fallback 15e-6 is the round-1 hand-measured figure for one Zen core.
_host_s_per_col: Optional[float] = None
# With host work-stealing as the safety net (device_kernel.py), the device
# threshold only gates how small a level is worth a launch at all.
_DEVICE_MIN_EST_S = 1.0


def host_s_per_col(option: Options, param: Params) -> float:
    """Calibrated host-kernel cost per profile column (cached)."""
    global _host_s_per_col
    if _host_s_per_col is not None:
        return _host_s_per_col
    try:
        from ..constants import profile_size
        n = 1024
        psize = profile_size(option.type)
        rng = np.random.default_rng(0)
        letters = rng.integers(0, param.matrix_size - 1, size=(2, n))
        q = letters[0].copy()
        mut = rng.random(n) < 0.1
        q[mut] = letters[1][mut]
        fr = np.zeros((n, psize), dtype=np.float32)
        fq = np.zeros((n, psize), dtype=np.float32)
        fr[np.arange(n), letters[0]] = 1.0
        fq[np.arange(n), q] = 1.0
        go = (np.full(n, param.gap_open, np.float32),) * 2
        ge = (np.full(n, param.gap_extend, np.float32),) * 2
        t0 = time.time()
        _run_talco_with_retries(fr, fq, go, ge, (1.0, 1.0), (n, n),
                                param, False, 0, option)
        _host_s_per_col = min(max((time.time() - t0) / (2 * n), 1e-6),
                              5e-4)
    except Exception:
        _host_s_per_col = 15e-6
    if _PROFILE:
        print(f"  [profile] host DP calibration: "
              f"{_host_s_per_col * 1e6:.1f} us/col", file=sys.stderr)
    return _host_s_per_col


def _prepare_pair(pair, database: SequenceDB, option: Options, param: Params):
    """Profile + consensus + gappy removal + PSGP for one pair."""
    ref, qry = pair
    has_r, has_q = helpers._has_freq(ref), helpers._has_freq(qry)
    freq_ref, freq_qry = helpers.calculate_profile(pair, database, option.type)
    dump = os.environ.get("TW_DEBUG_DUMP_PAIR")
    if dump and f"{ref.identifier}:{qry.identifier}" == dump:
        freq_ref[:ref.aln_len].tofile("/tmp/od_full_ref.bin")
        freq_qry[:qry.aln_len].tofile("/tmp/od_full_qry.bin")
        with open("/tmp/od_hasfreq.txt", "w") as f:
            f.write(f"{int(has_r)} {int(has_q)}\n")
        with open("/tmp/od_rows.txt", "w") as f:
            for s_idx in qry.seqs_included:
                if s_idx < 0:
                    f.write(f">NEG {s_idx}\n")
                    continue
                sq = database.sequences[s_idx]
                f.write(f">{sq.name}\n")
                f.write(bytes(sq.aln[:qry.aln_len]).decode("latin-1") + "\n")
    cons_r = helpers.get_consensus(freq_ref, option.type, ref.aln_len)
    cons_q = helpers.get_consensus(freq_qry, option.type, qry.aln_len)
    freq_ref, freq_qry, gappy, lens = helpers.remove_gappy_columns(
        freq_ref, freq_qry, pair, option.type, option.gappy_vertical,
        database.current_task)
    gap_op, gap_ex = helpers.calculate_psgp(
        freq_ref, freq_qry, pair, option.type, lens, param)
    return freq_ref, freq_qry, (cons_r, cons_q), gappy, lens, gap_op, gap_ex


def _run_talco_with_retries(freq_ref, freq_qry, gap_op, gap_ex, num, lens,
                            param: Params, gap_char_zero: bool,
                            current_task: int, option: Options
                            ) -> Tuple[Optional[np.ndarray], bool]:
    """Reference retry ladder (alignment-cpu.cpp:95-130). Returns
    (path or None, needs_fallback)."""
    tp = talco_np.TalcoRunParams(
        matrix=param.scoring_matrix,
        gap_open=param.gap_open,
        gap_extend=param.gap_extend,
        gap_char_score=0.0 if gap_char_zero else param.gap_extend,
        xdrop=int(1000 * -1 * param.gap_extend))
    impl = talco_np.align_freq
    if option.device_backend != "numpy" and talco_host.available():
        impl = talco_host.align_freq
    while True:
        aln, err = impl(tp, freq_ref, freq_qry, gap_op, gap_ex, num)
        if err == 0 and len(aln):
            return aln, False
        if current_task == 0 and err != 0:
            return None, True
        if err == 2:
            tp.flen = min(int(tp.flen * 1.2) << 1, min(lens[0], lens[1]))
        elif err == 1:
            tp.xdrop = int(tp.xdrop * 2)
            tp.flen = min(int(tp.xdrop * 4) << 1, min(lens[0], lens[1]))
        elif err == 3:
            raise RuntimeError("TALCO index error (errorType 3)")
        else:
            return aln, False


def _low_quality_flags(pair, database: SequenceDB, option: Options):
    ref, qry = pair
    low_r = False if (option.aln_mode == MERGE_MSA or ref.aln_num > 1) else \
        database.sequences[ref.seqs_included[0]].low_quality
    low_q = False if (option.aln_mode == MERGE_MSA or qry.aln_num > 1) else \
        database.sequences[qry.seqs_included[0]].low_quality
    return low_r, low_q


def host_pool_size(option: Options) -> int:
    return max(1, option.cpu_num if option.cpu_num > 0
               else (os.cpu_count() or 1))


def _precompute_host_paths(pairs, prepared, metas, device_paths,
                           database: SequenceDB, option: Options,
                           param: Params):
    """Run the host DP concurrently for every pair the post loop will need.

    The reference runs the whole per-pair pipeline under a TBB parallel_for
    (alignment-cpu.cpp:46); here only the DP itself is pooled — it dominates
    host time, its results are order-independent, and the native kernel
    (ctypes) releases the GIL, so threads scale on multi-core hosts while
    the mutating post phase stays sequential in pair order (parity).
    """
    task = database.current_task
    todo = []
    for n_idx, pair in enumerate(pairs):
        if device_paths is not None and device_paths[n_idx] is not None:
            continue
        ref_len, qry_len, _, _ = metas[n_idx]
        if ref_len == 0 or qry_len == 0:
            continue
        low_r, low_q = _low_quality_flags(pair, database, option)
        if low_r or low_q:
            continue
        todo.append(n_idx)
    if len(todo) < 2:
        return {}

    def _one(i):
        freq_ref, freq_qry, _, _, lens, gap_op, gap_ex = prepared[i]
        _, _, rn, qn = metas[i]
        gap_char_zero = (task == 1 or task == 2 or rn > 10000 or qn > 10000)
        return _run_talco_with_retries(
            freq_ref, freq_qry, gap_op, gap_ex, (float(rn), float(qn)),
            lens, param, gap_char_zero, task, option)

    results = {}
    with ThreadPoolExecutor(
            max_workers=min(host_pool_size(option), len(todo))) as ex:
        for i, res in zip(todo, ex.map(_one, todo)):
            results[i] = res
    return results


def _post_one(n_idx, pair, prep, meta, path, database: SequenceDB,
              option: Options, param: Params, task: int,
              fallback_pairs: List[int], recheck_none: bool) -> None:
    """Post-process one pair: gappy splice-back, profile merge, path
    application, fallback bookkeeping. Exactly the per-pair tail of the
    reference loop (alignment-cpu.cpp:131-175); must run in pair order
    (fallback append order feeds the deferred pass's unstable sort)."""
    ref, qry = pair
    ref_len, qry_len, ref_num, qry_num = meta
    freq_ref, freq_qry, consensus, gappy, lens, gap_op, gap_ex = prep
    gap_char_zero = (task == 1 or task == 2
                     or ref_num > 10000 or qry_num > 10000)

    aln_wo_gc: Optional[np.ndarray] = None
    if ref_len == 0:
        aln_wo_gc = np.ones(qry_len, dtype=np.int8)
    if qry_len == 0:
        aln_wo_gc = np.full(ref_len, 2, dtype=np.int8)

    low_r, low_q = _low_quality_flags(pair, database, option)

    if not low_r and not low_q:
        if aln_wo_gc is None:
            if path is DEFERRED:
                # the device kernel reached the host ladder's verdict
                fallback_pairs.append(n_idx)
                return
            if path is None and recheck_none:
                # the host ladder is the authority on deferral: confirm a
                # device/steal failure before deferring the pair
                num = (float(ref_num), float(qry_num))
                path, needs_fallback = _run_talco_with_retries(
                    freq_ref, freq_qry, gap_op, gap_ex, num, lens,
                    param, gap_char_zero, task, option)
                if needs_fallback:
                    fallback_pairs.append(n_idx)
                    return
            elif path is None:
                fallback_pairs.append(n_idx)
                return
            aln_wo_gc = path

    if task == 0 and (ref_num == 1 or qry_num == 1):
        if low_r or low_q:
            fallback_pairs.append(n_idx)
            return

    if aln_wo_gc is not None and len(aln_wo_gc):
        aln_w_gc = helpers.add_gappy_columns_back(
            aln_wo_gc, gappy, param, option.type, consensus)
        if os.environ.get("TW_DEBUG_LENS"):
            h = 1469598103934665603
            for a in aln_w_gc.tolist():
                h = ((h ^ (a & 0xFFFFFFFFFFFFFFFF))
                     * 1099511628211) % (1 << 64)
            print(f"DBGPATH {ref.identifier} {qry.identifier} "
                  f"{len(aln_w_gc)} {h:016x}", file=sys.stderr)
        ref_weight, qry_weight = ref.aln_weight, qry.aln_weight
        if option.aln_mode != PLACE_WO_TREE:
            helpers.update_frequency(pair, aln_w_gc,
                                     (ref_weight, qry_weight))
            helpers.update_alignment(pair, database, aln_w_gc, task)
        else:
            database.subtree_aln[qry.seqs_included[0]] = aln_w_gc


def align_pairs(pairs: List, database: SequenceDB, option: Options,
                param: Params, kernel=None,
                fallback_out: Optional[List[int]] = None) -> None:
    """Align one level's batch of node pairs.

    `kernel`, when given, is a batched DP callable
    (prepared_pairs -> list of (path | None)) used instead of the per-pair
    NumPy oracle; failed entries fall back to the oracle's retry ladder.
    When the device is used, the kernel call runs in a background thread
    and each pair's post phase runs (in pair order) as soon as its result
    is final — overlapping host post work with device compute, like the
    reference's per-pair TBB pipeline (alignment-cpu.cpp:46) but with the
    deterministic commit order the byte-parity bar requires.
    """
    fallback_pairs: List[int] = []
    task = database.current_task

    t0 = time.time()
    metas = [(p[0].aln_len, p[1].aln_len, p[0].aln_num, p[1].aln_num)
             for p in pairs]
    dump = os.environ.get("TW_DEBUG_DUMP_PAIR")
    pool = host_pool_size(option)
    if pool > 1 and len(pairs) > 3 and not dump:
        # prep is read-only on shared state (profile caching touches only
        # the pair's own nodes) and the native accumulate releases the
        # GIL, so prep pools across pairs like the reference's TBB
        # parallel_for over the per-pair pipeline (alignment-cpu.cpp:46)
        with ThreadPoolExecutor(max_workers=pool) as ex:
            prepared = list(ex.map(
                lambda pr: _prepare_pair(pr, database, option, param),
                pairs))
    else:
        prepared = [_prepare_pair(pair, database, option, param)
                    for pair in pairs]
    for n_idx, pair in enumerate(pairs):
        ref, qry = pair
        prep = prepared[n_idx]
        ref_len, qry_len, ref_num, qry_num = metas[n_idx]
        if dump and f"{ref.identifier}:{qry.identifier}" == dump:
            freq_ref, freq_qry, cons, gappy, lens, gap_op, gap_ex = prep
            np.savez(os.environ.get("TW_DEBUG_DUMP_FILE", "/tmp/pair.npz"),
                     freq_ref=freq_ref[:lens[0]], freq_qry=freq_qry[:lens[1]],
                     gap_op_r=gap_op[0], gap_op_q=gap_op[1],
                     gap_ex_r=gap_ex[0], gap_ex_q=gap_ex[1],
                     ref_num=ref_num, qry_num=qry_num,
                     task=task, ref_len=ref_len, qry_len=qry_len,
                     cons_r=cons[0], cons_q=cons[1],
                     gappy_r=np.asarray(gappy[0], dtype=np.int64),
                     gappy_q=np.asarray(gappy[1], dtype=np.int64))
    t_prep = time.time() - t0

    # batched device kernel over all prepared pairs, if provided and
    # the level is wide enough to amortize the launch round-trip
    t0 = time.time()
    use_device = False
    if kernel is not None:
        poll = getattr(kernel, "poll_ready", None)
        if poll is not None and not poll():
            # lazy auto-mode kernel still building (device discovery /
            # warm-up in a background thread): this level runs on the
            # host engine; later levels re-check. Bit-identical either
            # way, so the cutover level never changes output bytes.
            kernel = None
    if kernel is not None:
        est_host_s = sum(
            (prep[4][0] + prep[4][1]) * host_s_per_col(option, param)
            for prep in prepared) / host_pool_size(option)
        use_device = (est_host_s >= _DEVICE_MIN_EST_S
                      or not talco_host.available()
                      or bool(os.environ.get("TWILIGHT_FORCE_DEVICE")))

    if use_device and getattr(kernel, "supports_on_final", False):
        # pipelined: kernel in a background thread; post each pair in
        # ORDER as soon as its result is final
        import threading
        n = len(pairs)
        final = [False] * n
        paths: List[Optional[np.ndarray]] = [None] * n
        cond = threading.Condition()
        kernel_err: List[BaseException] = []

        def on_final(i, path):
            with cond:
                if not final[i]:
                    paths[i] = path
                    final[i] = True
                    cond.notify_all()

        def run_kernel():
            try:
                res = kernel(prepared, metas, database, option, param,
                             on_final=on_final)
                for i, r in enumerate(res):
                    on_final(i, r)
            except BaseException as e:  # surface in main thread
                kernel_err.append(e)
            finally:
                with cond:
                    for i in range(n):
                        final[i] = True
                    cond.notify_all()

        th = threading.Thread(target=run_kernel)
        th.start()
        t_post = 0.0
        for n_idx, pair in enumerate(pairs):
            with cond:
                while not final[n_idx] and not kernel_err:
                    cond.wait(0.5)
            if kernel_err:
                break
            tp0 = time.time()
            _post_one(n_idx, pair, prepared[n_idx], metas[n_idx],
                      paths[n_idx], database, option, param, task,
                      fallback_pairs, recheck_none=True)
            t_post += time.time() - tp0
        th.join()
        if kernel_err:
            raise kernel_err[0]
        if _PROFILE:
            print(f"  [profile] {len(pairs)} pairs: prep={t_prep:.2f}s "
                  f"device+post={time.time() - t0:.2f}s "
                  f"(post work {t_post:.2f}s, overlapped)",
                  file=sys.stderr)
    else:
        device_paths: Optional[List[Optional[np.ndarray]]] = None
        if use_device:
            device_paths = kernel(prepared, metas, database, option, param)
        t_dev = time.time() - t0
        t0 = time.time()

        host_paths = {}
        if host_pool_size(option) > 1:
            host_paths = _precompute_host_paths(
                pairs, prepared, metas, device_paths, database, option,
                param)

        for n_idx, pair in enumerate(pairs):
            path = device_paths[n_idx] if device_paths is not None else None
            recheck = True
            if path is None and n_idx in host_paths:
                path, needs_fallback = host_paths[n_idx]
                if needs_fallback:
                    path = None
                recheck = False
            _post_one(n_idx, pair, prepared[n_idx], metas[n_idx], path,
                      database, option, param, task, fallback_pairs,
                      recheck_none=recheck)

        if _PROFILE:
            print(f"  [profile] {len(pairs)} pairs: prep={t_prep:.2f}s "
                  f"device={t_dev:.2f}s post={time.time() - t0:.2f}s",
                  file=sys.stderr)

    if fallback_out is not None:
        # cross-level scheduling: the caller materializes deferrals in
        # global (level, index) order after all rounds — recording only
        # keeps the reference's fallback-list order intact
        fallback_out.extend(fallback_pairs)
    elif fallback_pairs:
        helpers.fallback_to_deferred(fallback_pairs, pairs, database,
                                     option.no_filter)
