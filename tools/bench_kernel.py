"""Parity and timing harness for the TALCO-XDrop device kernels.

Runs the two device kernels on the same packed pairs — the CUDA kernel
(ops/talco_gpu.py, route "cuda") and XLA's compile of the plain version
(ops/talco_jax.py, route "xla") — and holds every result to the NumPy
oracle (ops/talco_np.py) element for element: the same error code, and on
success the same int8 path. Pairs whose band outgrows the window relaunch
at 4x the window, as the batcher does.

Cases (all generated from --seed):
  nt         nucleotide pairs, 1.2-1.9 kb, padlen 2048
  prot       protein pairs (P=22, BLOSUM62), 300-500 aa, padlen 2048
  long       nucleotide pairs, 28-31 kb, padlen 32768
  wide       nucleotide pairs with a 600-column insertion: the band
             outgrows the 512 window, so they run at window 2048
  multitile  marker 64: several convergence tiles per pair
  err1       unrelated sequences, xdrop 40: error 1 (band collapse)
  err2       ladder fLen 16 with indels: error 2 (band over fLen)

Timing reports, per case and batch size, the warm time of one launch
(median of --iters, after a compile call), ms per pair, and live-band
cells/s (the DP cells the kernel computed, from its tail, over the launch
time). Device numbers come only from a GPU; on another platform the
script refuses to time.

Usage:
  python tools/bench_kernel.py [--routes cuda,xla] [--cases nt,prot,...]
                               [--batches 128,1024] [--iters 3] [--json]
  python tools/bench_kernel.py --parity-only [--routes cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

GO, GE = -50.0, -5.0
XDROP = 5000            # 1000 * -gap_extend, the production value
CASES = ("nt", "prot", "long", "wide", "multitile", "err1", "err2")


def _profile(codes, p):
    out = np.zeros((len(codes), p), np.float32)
    out[np.arange(len(codes)), codes] = 1.0
    return out


def _substitute(rng, seq, letters, mut=0.05):
    out = seq.copy()
    hit = rng.random(len(out)) < mut
    out[hit] = rng.integers(0, letters, int(hit.sum()))
    return out


def _related(rng, n, letters, mut=0.1, indel=0.02):
    base = rng.integers(0, letters, n)
    q = []
    for c in base:
        r = rng.random()
        if r < indel / 2:
            continue
        if r < indel:
            q.append(int(rng.integers(0, letters)))
        q.append(int(rng.integers(0, letters)) if rng.random() < mut
                 else int(c))
    return base, np.asarray(q)


def make_case(name: str, n: int, seed: int = 0) -> dict:
    """n pairs of one case: profiles, scoring and kernel shape."""
    from twilight_tpu.config import Params
    rng = np.random.default_rng([seed, CASES.index(name)])
    p, letters = (22, 20) if name == "prot" else (6, 4)
    param = Params.make("p" if p == 22 else "n")
    case = dict(name=name, p=p, matrix=param.scoring_matrix.astype(
        np.float32), padlen=2048, window=512, marker=1024, xdrop=XDROP,
        flen=4096, pairs=[])
    lo, hi = {"nt": (1200, 1900), "prot": (300, 500),
              "long": (28000, 31000), "wide": (900, 1000),
              "multitile": (300, 600), "err1": (150, 250),
              "err2": (300, 400)}[name]
    if name == "long":
        case["padlen"] = 32768
    if name == "wide":
        case["window"] = 2048
    if name == "multitile":
        case["marker"] = 64
    if name == "err1":
        case["xdrop"] = 40
    if name == "err2":
        case["flen"] = 16
    for k in range(n):
        ln = int(rng.integers(lo, hi))
        if name == "err1":
            a, b = rng.integers(0, 4, ln), rng.integers(0, 4, ln)
        else:
            a, b = _related(rng, ln, letters,
                            indel=0.06 if name == "err2" else 0.02)
            if name == "wide":
                b = np.concatenate([b[:ln // 2], rng.integers(0, 4, 600),
                                    b[ln // 2:]])
        fr, fq = _profile(a, p), _profile(b, p)
        num = 1.0
        if k % 2:
            # two-sequence profiles: add a substituted copy of each side
            fr = fr + _profile(_substitute(rng, a, letters), p)
            fq = fq + _profile(_substitute(rng, b, letters), p)
            num = 2.0
        case["pairs"].append((fr, fq, num))
    return case


def oracle(case) -> list:
    """(path, err) per pair from the NumPy oracle."""
    from twilight_tpu.ops import talco_np
    out = []
    for fr, fq, num in case["pairs"]:
        tp = talco_np.TalcoRunParams(case["matrix"], GO, GE, GE,
                                     case["xdrop"], flen=case["flen"],
                                     marker=case["marker"])
        go = (np.full(len(fr), GO, np.float32), np.full(len(fq), GO,
                                                        np.float32))
        ge = (np.full(len(fr), GE, np.float32), np.full(len(fq), GE,
                                                        np.float32))
        out.append(talco_np.align_freq(tp, fr, fq, go, ge, (num, num)))
    return out


def kernel_for(route: str, case: dict, window: int):
    """(fn, off, tot) for one route at one window."""
    m = case["matrix"]
    if route == "cuda":
        from twilight_tpu.ops import talco_gpu
        return (talco_gpu.get_batch_kernel(
            case["padlen"], window, case["marker"], m.tobytes(),
            m.shape[0]), 0, case["padlen"])
    from twilight_tpu.ops import talco_jax
    return (talco_jax.get_batch_kernel(
        case["padlen"], window, case["p"], case["marker"], m.tobytes(),
        m.shape[0]), window, 2 * window + case["padlen"])


def pack(case, idxs, batch, off, tot):
    """Packed (ref, qry, meta_i, meta_f) of pairs idxs, padded to batch
    with length-1 dummies (as the batcher does)."""
    from twilight_tpu.ops import talco_jax
    p8 = talco_jax.p8_of(case["p"])
    ref = np.zeros((batch, tot, p8), np.float32)
    qry = np.zeros((batch, tot, p8), np.float32)
    mi = np.tile(np.array([1, 1, 4096, 5000], np.int32), (batch, 1))
    mf = np.tile(np.array([1, 1, 0, GO, GE], np.float32), (batch, 1))
    for b, i in enumerate(idxs):
        fr, fq, num = case["pairs"][i]
        go = (np.full(len(fr), GO, np.float32), np.full(len(fq), GO,
                                                        np.float32))
        ge = (np.full(len(fr), GE, np.float32), np.full(len(fq), GE,
                                                        np.float32))
        talco_jax.pack_pair_into(ref[b], qry[b], fr, fq, go, ge,
                                 case["padlen"], off)
        mi[b] = (len(fr), len(fq), case["flen"], case["xdrop"])
        mf[b] = (num, num, GE, GO, GE)
    return ref, qry, mi, mf


def run_route(route: str, case: dict, batch: int, max_window: int) -> list:
    """(path, err) per pair through one route, relaunching error-6 pairs
    at 4x the window up to max_window."""
    res = [None] * len(case["pairs"])
    todo = list(range(len(case["pairs"])))
    window = case["window"]
    while todo:
        fn, off, tot = kernel_for(route, case, window)
        again = []
        for lo in range(0, len(todo), batch):
            idxs = todo[lo:lo + batch]
            paths, tail = fn(*pack(case, idxs, batch, off, tot))
            paths, tail = np.asarray(paths), np.asarray(tail)
            for b, i in enumerate(idxs):
                ln, err = int(tail[b, 0]), int(tail[b, 1])
                if err == 6 and window < max_window:
                    again.append(i)   # the batcher's window ladder
                else:
                    res[i] = (paths[b, :ln].copy() if err == 0
                              else np.zeros(0, np.int8), err)
        todo, window = again, min(window * 4, max_window)
    return res


def mismatches(got, gold) -> int:
    bad = 0
    for (path, err), (gpath, gerr) in zip(got, gold):
        if err != gerr or (err == 0 and not np.array_equal(path, gpath)):
            bad += 1
    return bad


def time_route(route: str, case: dict, batch: int, iters: int) -> dict:
    """Warm launch time of `batch` pairs (case pairs tiled) at the case's
    window: median of iters after one compile call."""
    import jax
    fn, off, tot = kernel_for(route, case, case["window"])
    n = len(case["pairs"])
    idxs = [i % n for i in range(batch)]
    args = jax.device_put(pack(case, idxs, batch, off, tot))
    t0 = time.perf_counter()
    paths, tail = fn(*args)
    tail = np.asarray(jax.block_until_ready(tail))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    t = statistics.median(times)
    cells = int(tail[:, 2].astype(np.int64).sum())
    return dict(route=route, case=case["name"], batch=batch,
                window=case["window"], launch_s=t, ms_per_pair=1e3 * t / batch,
                cells=cells, cells_per_s=cells / t, first_call_s=compile_s,
                err6=int((tail[:, 1] == 6).sum()))


def device_report() -> dict:
    import subprocess

    import jax
    d = jax.devices()[0]
    smi = ""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return dict(platform=d.platform, kind=d.device_kind,
                count=len(jax.devices()), nvidia_smi=smi)


PARITY_PAIRS = dict(nt=48, prot=24, long=3, wide=6, multitile=16, err1=6,
                    err2=6)


def parity(routes, cases, seed: int = 0, log=print) -> int:
    """Mismatch count over every (route, case); prints one line each."""
    from twilight_tpu.ops import talco_gpu
    total = 0
    for name in cases:
        case = make_case(name, PARITY_PAIRS[name], seed)
        gold = oracle(case)
        errs = sorted({e for _, e in gold})
        for route in routes:
            maxw = (talco_gpu.max_window(case["matrix"].shape[0])
                    if route == "cuda" else 1 << 15)
            got = run_route(route, case, 8 if name == "long" else 32, maxw)
            bad = mismatches(got, gold)
            total += bad
            log(f"parity {route:4s} {name:9s} pairs={len(gold):3d} "
                f"oracle_errs={errs} mismatches={bad}")
    return total


def e2e(routes, seed: int = 1) -> None:
    """sim10k --rooted through cli.main --backend gpu with each route as
    the batcher's kernel, every pair on the device; prints wall and md5."""
    import hashlib
    import shutil

    from twilight_tpu import cli
    from twilight_tpu.ops import device_kernel
    from twilight_tpu.tools import simulate
    work = os.path.join(REPO, ".bench_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    prefix = os.path.join(work, "sim10k")
    simulate.main(["-n", "10000", "-l", "1000", "--seed", str(seed),
                   "-o", prefix])
    os.environ.update(TWILIGHT_FORCE_DEVICE="1", TWILIGHT_NO_STEAL="1")
    real_route = device_kernel.route_for
    try:
        for route in routes:
            device_kernel.route_for = lambda platform, r=route: r
            out = os.path.join(work, f"{route}.aln")
            t0 = time.perf_counter()
            rc = cli.main(["-t", prefix + ".nwk", "-i", prefix + ".fa",
                           "--rooted", "-o", out, "--backend", "gpu"])
            wall = time.perf_counter() - t0
            with open(out, "rb") as f:
                digest = hashlib.md5(f.read()).hexdigest()
            st = device_kernel.LAST_STATS
            print(f"e2e sim10k route={route} rc={rc} wall={wall:.3f}s "
                  f"md5={digest} device={st.get('device')} "
                  f"stolen={st.get('stolen')} launches={st.get('launches')} "
                  f"cells={st.get('cells')}", flush=True)
    finally:
        device_kernel.route_for = real_route
        for k in ("TWILIGHT_FORCE_DEVICE", "TWILIGHT_NO_STEAL"):
            os.environ.pop(k, None)
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--routes", default="cuda,xla")
    ap.add_argument("--cases", default="nt,prot,long,wide")
    ap.add_argument("--parity-cases", default=",".join(CASES))
    ap.add_argument("--batches", default="128,1024")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parity-only", action="store_true")
    ap.add_argument("--e2e", action="store_true",
                    help="also time sim10k --rooted end to end per route")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rep = device_report()
    print(f"device: {rep}")
    if rep["platform"] != "gpu":
        print("ERROR: no GPU; device timings need one", file=sys.stderr)
        return 1
    routes = args.routes.split(",")
    bad = parity(routes, [c for c in args.parity_cases.split(",") if c],
                 args.seed)
    print(f"parity total mismatches: {bad}")
    if args.e2e:
        e2e(routes)
    if args.parity_only:
        return 1 if bad else 0
    rows = []
    for name in args.cases.split(","):
        case = make_case(name, 64 if name != "long" else 8, args.seed)
        for batch in [int(b) for b in args.batches.split(",")]:
            if name == "long":
                batch = max(8, batch * 2048 // 32768)
            for route in routes:
                r = time_route(route, case, batch, args.iters)
                rows.append(r)
                print(f"time {route:4s} {name:5s} batch={batch:5d} "
                      f"window={r['window']:5d} launch={r['launch_s']:.4f}s "
                      f"ms/pair={r['ms_per_pair']:.4f} "
                      f"cells/s={r['cells_per_s']:.4e} "
                      f"first_call={r['first_call_s']:.1f}s "
                      f"err6={r['err6']}")
                sys.stdout.flush()
    if args.json:
        print(json.dumps(dict(device=rep, parity_mismatches=bad,
                              rows=rows)))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
