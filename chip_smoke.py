"""Smoke test of the GPU path: the quickest proof that the system runs on
the card and gives the reference's bytes.

One process owns the card(s); everything is generated from seeds inside
the run; the CLI runs in-process through its normal entry point.

  python chip_smoke.py            one GPU:
    1. device report (JAX's view, then nvidia-smi's name and power limit)
    2. the CUDA kernel against the NumPy oracle on every kernel route
       (0 mismatches), and launch times of the CUDA kernel and of
       XLA's compile of talco_jax on the same pairs
    3. end to end through cli.main --backend gpu, with every pair on the
       device (TWILIGHT_FORCE_DEVICE=1, TWILIGHT_NO_STEAL=1):
       sim10k --rooted and simprot (md5 = the recorded reference output),
       sim10k divide-and-conquer (-m 2000) and 20 x 30 kb (md5 = the
       --backend native run of the same command); each needs device-
       resolved pairs > 0 and host-stolen pairs = 0
  python chip_smoke.py --chips 4  four GPUs: sim10k --rooted over the
    4-card "pairs" mesh; md5 = the reference output, every card takes pairs

The last line of stdout is one JSON object, printed only when every phase
passed: {"ok": true, "device": {"platform", "kind", "count"}}. Any failure
exits non-zero without it.
"""
import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_work")
SIM10K_MD5 = "d551d5b3f45d8bbbf45c0ecafd133d6f"     # BASELINE.md: sim10k
SIMPROT_MD5 = "246cb13911b9b21d39ee051c4c4bd684"    # BASELINE.md: simprot


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def simulate(name, *args):
    from twilight_tpu.tools import simulate as sim
    prefix = os.path.join(WORK, name)
    if not os.path.exists(prefix + ".fa"):
        check(sim.main([*args, "-o", prefix]) == 0, f"simulate {name}")
    return prefix


def run_cli(tag, argv, backend):
    """One in-process CLI run; returns (wall seconds, md5, stats)."""
    from twilight_tpu import cli
    from twilight_tpu.ops import device_kernel
    out = os.path.join(WORK, f"{tag}.{backend}.aln")
    argv = [a.replace("{tmp}", os.path.join(WORK, f"{tag}.{backend}.tmp"))
            for a in argv]
    device_kernel.LAST_STATS.clear()
    env = {"TWILIGHT_FORCE_DEVICE": "1", "TWILIGHT_NO_STEAL": "1"} \
        if backend in ("gpu", "cpu") else {}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        rc = cli.main([*argv, "-o", out, "--backend", backend])
        wall = time.perf_counter() - t0
    finally:
        for k in env:
            os.environ.pop(k, None)
    check(rc == 0, f"{tag} --backend {backend}: exit {rc}")
    return wall, md5(out), dict(device_kernel.LAST_STATS)


def e2e_case(tag, argv, expect_md5=None):
    """--backend gpu run of one case, held to expect_md5 or, when None,
    to the --backend native run of the same command."""
    wall, got, st = run_cli(tag, argv, "gpu")
    if expect_md5 is None:
        nwall, expect_md5, _ = run_cli(tag, argv, "native")
        ref = f"native run ({nwall:.3f} s)"
    else:
        ref = "recorded reference md5"
    print(f"e2e {tag}: wall={wall:.3f}s md5={got} "
          f"{'==' if got == expect_md5 else '!='} {ref} "
          f"device_resolved={st.get('device', 0)} "
          f"host_stolen={st.get('stolen', 0)} "
          f"window_host={st.get('window_host', 0)} "
          f"rechecked={st.get('rechecked', 0)} "
          f"launches={st.get('launches', 0)} cells={st.get('cells', 0)} "
          f"pairs_per_device={st.get('pairs_per_device')}", flush=True)
    check(got == expect_md5, f"{tag}: md5 {got} != {expect_md5}")
    check(st.get("device", 0) > 0, f"{tag}: no pair resolved on the device")
    check(st.get("stolen", 0) == 0, f"{tag}: the host stole pairs")
    return st


def phase_kernels():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import bench_kernel as bk
    bad = bk.parity(["cuda"], bk.CASES,
                    log=lambda m: print(m, flush=True))
    print(f"kernel parity: cuda vs talco_np mismatches={bad}", flush=True)
    check(bad == 0, f"CUDA kernel: {bad} mismatches against talco_np")
    bk.PARITY_PAIRS["nt"] = 8
    bad = bk.parity(["xla"], ["nt"], log=lambda m: print(m, flush=True))
    check(bad == 0, f"talco_jax on the GPU: {bad} mismatches")
    case = bk.make_case("nt", 64)
    for route in ("cuda", "xla"):
        r = bk.time_route(route, case, 128, 3)
        print(f"kernel time {route} nt padlen=2048 batch=128 "
              f"launch={r['launch_s']:.6f}s ms/pair={r['ms_per_pair']:.6f} "
              f"cells/s={r['cells_per_s']:.6e}", flush=True)


def phase_e2e():
    s10 = simulate("sim10k", "-n", "10000", "-l", "1000", "--seed", "1")
    e2e_case("sim10k", ["-t", s10 + ".nwk", "-i", s10 + ".fa", "--rooted"],
             SIM10K_MD5)
    sp = simulate("simprot", "--type", "p", "-n", "300", "-l", "400",
                  "--seed", "2")
    e2e_case("simprot", ["-t", sp + ".nwk", "-i", sp + ".fa", "--rooted",
                         "--type", "p"], SIMPROT_MD5)
    e2e_case("sim10k_m2000", ["-t", s10 + ".nwk", "-i", s10 + ".fa",
                              "--rooted", "-m", "2000", "-d", "{tmp}"])
    lg = simulate("long20", "-n", "20", "-l", "30000", "--seed", "3")
    e2e_case("long20x30kb", ["-t", lg + ".nwk", "-i", lg + ".fa"])


def phase_mesh(n):
    s10 = simulate("sim10k", "-n", "10000", "-l", "1000", "--seed", "1")
    st = e2e_case("sim10k_mesh", ["-t", s10 + ".nwk", "-i", s10 + ".fa",
                                  "--rooted"], SIM10K_MD5)
    share = st.get("pairs_per_device") or []
    print(f"mesh: {st.get('describe')}: pairs per card {share}", flush=True)
    check(len(share) == n and all(c > 0 for c in share),
          f"not every card took pairs: {share}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="GPU smoke test")
    ap.add_argument("--chips", type=int, default=1, choices=[1, 4])
    args = ap.parse_args(argv)
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"ERROR: no GPU (JAX platform {devs[0].platform})",
              file=sys.stderr)
        return 1
    if len(devs) < args.chips:
        print(f"ERROR: {args.chips} GPUs requested, {len(devs)} present",
              file=sys.stderr)
        return 1
    import twilight_tpu  # noqa: F401  (fails outside a checkout)
    device = dict(platform=devs[0].platform, kind=devs[0].device_kind,
                  count=len(devs))
    print(f"jax devices: {device}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        if args.chips == 4:
            phase_mesh(4)
        else:
            phase_kernels()
            phase_e2e()
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
