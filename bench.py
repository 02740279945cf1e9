"""End-to-end benchmark on a 2000-sequence simulated dataset.

Workload: 2000 nucleotide sequences x ~1 kb evolved along a random binary
tree (twilight_tpu.tools.simulate, seed 0), aligned in default mode with the
true tree (--rooted). Baseline: the reference CPU binary
(tools/refbuild/build_reference.sh) on this machine aligns it in 76.5 s and
produces md5 624c589fc0fab056e15b3b88047eddf6 — our output must match
byte-for-byte. `vs_baseline` = reference wall / ours (>1 is faster).

Prints exactly one JSON line.
"""
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_MD5 = "624c589fc0fab056e15b3b88047eddf6"
BASELINE_S = 76.5


def main():
    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "sim2k")
        r = subprocess.run(
            [sys.executable, "-m", "twilight_tpu.tools.simulate",
             "-n", "2000", "-l", "1000", "--seed", "0", "-o", prefix],
            cwd=REPO, capture_output=True)
        if r.returncode != 0:
            print(json.dumps({"metric": "sim2k_e2e_wall", "value": -1,
                              "unit": "s", "vs_baseline": 0,
                              "error": r.stderr.decode()[-300:]}))
            return 1
        out = os.path.join(td, "sim2k.aln")
        cmd = [sys.executable, "-m", "twilight_tpu", "-t", prefix + ".nwk",
               "-i", prefix + ".fa", "-o", out, "--rooted", "--overwrite"]
        # warm-up run: builds the native/CUDA libraries and fills the
        # compile cache so the measured runs reflect steady state
        subprocess.run(cmd, cwd=REPO, capture_output=True)
        # best-of-3: min is the steady-state figure
        wall = float("inf")
        md5 = ""
        for _ in range(3):
            t0 = time.time()
            r = subprocess.run(cmd, cwd=REPO, capture_output=True)
            dt = time.time() - t0
            if r.returncode != 0:
                print(json.dumps({"metric": "sim2k_e2e_wall", "value": -1,
                                  "unit": "s", "vs_baseline": 0,
                                  "error": r.stderr.decode()[-300:]}))
                return 1
            with open(out, "rb") as f:
                md5 = hashlib.md5(f.read()).hexdigest()
            if md5 != GOLDEN_MD5:
                break
            wall = min(wall, dt)
    correct = (md5 == GOLDEN_MD5)
    # kernel-level throughput on the same device (a fixed batch of ~1.5 kb
    # nucleotide profile pairs through the CUDA kernel; catches kernel
    # regressions that e2e host-side noise would hide)
    kernel = {}
    try:
        r = subprocess.run(
            [sys.executable, "tools/bench_kernel.py", "--json",
             "--routes", "cuda", "--cases", "nt", "--batches", "128",
             "--parity-cases", "", "--iters", "10"],
            cwd=REPO, capture_output=True, timeout=1200)
        for line in r.stdout.decode().splitlines():
            if line.startswith("{"):
                row = json.loads(line)["rows"][0]
                kernel = {"kernel_ms_per_pair": row["ms_per_pair"],
                          "kernel_cells_per_s": row["cells_per_s"]}
    except Exception:
        pass
    print(json.dumps({
        "metric": "sim2k_e2e_wall",
        "value": round(wall, 2) if correct else -1,
        "unit": "s",
        "vs_baseline": round(BASELINE_S / wall, 3) if correct else 0,
        "byte_identical": correct,
        **kernel,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
