"""Deferred-realign (fallback) path at scale.

With --length-deviation 0.02 on the 2000-sequence simulated dataset, 706
sequences are low-quality and deferred to the task-1 realign pass — this
exercises fallback_to_deferred, the reference's unstable std::sort order
(helpers.sort_fallback via native std::sort) and the one-pair-per-level
realign schedule. The md5 is pinned to the canonical reference build's
output (verified byte-identical on the native and device backends)."""
import hashlib
import os
import sys

import pytest

from conftest import REPO
from twilight_tpu import cli
from twilight_tpu.tools.simulate import simulate

REF_MD5 = "224c800d696d24cac399a1630747c39a"


@pytest.mark.slow
def test_deferred_realign_2k(tmp_path):
    names, seqs, nwk = simulate(2000, 1000, seed=0)
    fa = str(tmp_path / "s.fa")
    tre = str(tmp_path / "s.nwk")
    with open(fa, "w") as f:
        for n, s in zip(names, seqs):
            f.write(f">{n}\n{s}\n")
    with open(tre, "w") as f:
        f.write(nwk + "\n")
    out = str(tmp_path / "out.aln")
    rc = cli.main(["-t", tre, "-i", fa, "-o", out, "--rooted",
                   "--length-deviation", "0.02", "--backend", "native"])
    assert rc == 0
    with open(out, "rb") as f:
        assert hashlib.md5(f.read()).hexdigest() == REF_MD5


@pytest.mark.slow
def test_deferred_realign_2k_pooled(tmp_path, monkeypatch):
    """Same config under -C 4: the pooled DP must not perturb the
    fallback-detection order that feeds the pinned unstable-sort."""
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    names, seqs, nwk = simulate(2000, 1000, seed=0)
    fa = str(tmp_path / "s.fa")
    tre = str(tmp_path / "s.nwk")
    with open(fa, "w") as f:
        for n, s in zip(names, seqs):
            f.write(f">{n}\n{s}\n")
    with open(tre, "w") as f:
        f.write(nwk + "\n")
    out = str(tmp_path / "out.aln")
    rc = cli.main(["-t", tre, "-i", fa, "-o", out, "--rooted",
                   "--length-deviation", "0.02", "--backend", "native",
                   "-C", "4"])
    assert rc == 0
    with open(out, "rb") as f:
        assert hashlib.md5(f.read()).hexdigest() == REF_MD5


@pytest.mark.slow
def test_escalation_ladder_hbm_tb_e2e(tmp_path):
    """Window-escalation ladder through the REAL batcher up to the wide
    windows: divergent pairs + TWILIGHT_INIT_WINDOW=128 force err-6
    relaunches past FLEN 1024 (verified reaching window=2048); output
    must be byte-identical to the NumPy oracle run."""
    import subprocess
    sim = tmp_path / "div8"
    env = dict(os.environ)
    subprocess.run(
        [sys.executable, "-m", "twilight_tpu.tools.simulate", "-n", "8",
         "-l", "2000", "-m", "0.25", "--seed", "13", "-o", str(sim)],
        cwd=REPO, check=True, capture_output=True, env=env)
    out_np = tmp_path / "np.aln"
    subprocess.run(
        [sys.executable, "-m", "twilight_tpu", "-t", f"{sim}.nwk",
         "-i", f"{sim}.fa", "-o", str(out_np), "--backend", "numpy"],
        cwd=REPO, check=True, capture_output=True, env=env, timeout=900)
    out_dev = tmp_path / "dev.aln"
    env.update(JAX_PLATFORMS="cpu", TWILIGHT_FORCE_DEVICE="1",
               TWILIGHT_INIT_WINDOW="128", TWILIGHT_NO_STEAL="1",
               TWILIGHT_PROFILE="1")
    r = subprocess.run(
        [sys.executable, "-m", "twilight_tpu", "-t", f"{sim}.nwk",
         "-i", f"{sim}.fa", "-o", str(out_dev), "--backend", "cpu",
         "--pair-batch", "8"],
        cwd=REPO, capture_output=True, env=env, timeout=3000)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    prof = r.stderr.decode()
    assert "window=2048" in prof, \
        "escalation never reached window 2048:\n" + prof[-1500:]
    assert out_dev.read_bytes() == out_np.read_bytes()
