"""End-to-end multi-chip execution through the production batcher.

Runs cli.main with --backend cpu under the conftest's 8 virtual CPU
devices: DeviceTalco builds an 8-device "pairs" mesh and launches the
XLA-compiled batch kernel (ops/talco_jax.py) under shard_map — the same
batcher and mesh code that shards the CUDA kernel over GPUs. The output
must be byte-identical to the NumPy-oracle run — certifying the sharded
production path end-to-end, not a demo kernel (reference analogue:
multi-GPU batch stealing, cuda/alignment-gpu.cu:231-252).
"""
import os
import subprocess
import sys

import pytest

from twilight_tpu import cli

from conftest import REPO


def _simulate(tmp_path, n=24, length=120, seed=7):
    prefix = str(tmp_path / "mini")
    r = subprocess.run(
        [sys.executable, "-m", "twilight_tpu.tools.simulate",
         "-n", str(n), "-l", str(length), "--seed", str(seed),
         "-o", prefix], cwd=REPO, capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    return prefix


def test_mesh_e2e_byte_identical(tmp_path, monkeypatch):
    import jax
    assert len(jax.devices()) == 8  # conftest virtual mesh

    prefix = _simulate(tmp_path)
    ref_out = str(tmp_path / "ref.aln")
    mesh_out = str(tmp_path / "mesh.aln")

    rc = cli.main(["-t", prefix + ".nwk", "-i", prefix + ".fa",
                   "-o", ref_out, "--rooted", "--backend", "numpy"])
    assert rc == 0

    monkeypatch.setenv("TWILIGHT_FORCE_DEVICE", "1")
    monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")
    rc = cli.main(["-t", prefix + ".nwk", "-i", prefix + ".fa",
                   "-o", mesh_out, "--rooted", "--backend", "cpu",
                   "--pair-batch", "8"])
    assert rc == 0

    with open(ref_out, "rb") as f1, open(mesh_out, "rb") as f2:
        assert f1.read() == f2.read(), "mesh output != oracle output"


def test_device_selection(tmp_path, monkeypatch, capfd):
    """--devices/--device-index (reference GPU build --gpu/--gpu-index,
    cuda/gpu-info.cu:14-61): a 4-of-8 selection builds a 4-device mesh
    and stays byte-identical; invalid selections exit(1)."""
    import jax
    assert len(jax.devices()) == 8

    prefix = _simulate(tmp_path, n=16)
    ref_out = str(tmp_path / "ref.aln")
    sel_out = str(tmp_path / "sel.aln")
    rc = cli.main(["-t", prefix + ".nwk", "-i", prefix + ".fa",
                   "-o", ref_out, "--rooted", "--backend", "numpy"])
    assert rc == 0

    monkeypatch.setenv("TWILIGHT_FORCE_DEVICE", "1")
    monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")
    rc = cli.main(["-t", prefix + ".nwk", "-i", prefix + ".fa",
                   "-o", sel_out, "--rooted", "--backend", "cpu",
                   "--pair-batch", "8",
                   "--devices", "4", "--device-index", "0,2,4,6"])
    assert rc == 0
    err = capfd.readouterr().err
    assert "Maximum available devices: 8. Using 4 devices." in err
    with open(ref_out, "rb") as f1, open(sel_out, "rb") as f2:
        assert f1.read() == f2.read()

    import pytest as _pytest
    with _pytest.raises(SystemExit):
        cli.main(["-t", prefix + ".nwk", "-i", prefix + ".fa",
                  "-o", sel_out, "--overwrite", "--rooted",
                  "--backend", "cpu", "--device-index", "9"])
    assert "does not match" in capfd.readouterr().err
    with _pytest.raises(SystemExit):
        cli.main(["-t", prefix + ".nwk", "-i", prefix + ".fa",
                  "-o", sel_out, "--overwrite", "--rooted",
                  "--backend", "cpu", "--devices", "99"])
    assert "Invalid number of devices" in capfd.readouterr().err
