"""Lazy device-kernel handle for --backend auto (ops/device_kernel.py
LazyDeviceKernel): construction must not block the caller, align_pairs
must skip the device while it is building, and delegation must work once
ready. The blocking build path (explicit backends, device selection,
workflow persist cache) is pinned too."""
import time

import pytest

from twilight_tpu.config import Options, Params
from twilight_tpu.ops import device_kernel as dk


def _opts(**kw):
    base = dict(device_backend="auto", pair_batch=8)
    base.update(kw)
    return Options(**base)


def test_auto_returns_lazy_and_becomes_ready(monkeypatch):
    monkeypatch.delenv("TWILIGHT_FORCE_DEVICE", raising=False)
    opt = _opts()
    param = Params.make("n")
    t0 = time.time()
    kern = dk.make_device_kernel(opt, param)
    assert isinstance(kern, dk.LazyDeviceKernel)
    # construction returns immediately even though DeviceTalco setup
    # (discovery + warm-up scheduling) may take a while
    assert time.time() - t0 < 5.0
    deadline = time.time() + 120
    while not kern.poll_ready() and time.time() < deadline:
        time.sleep(0.2)
    assert kern.poll_ready(), "builder thread never finished on CPU"
    # delegation reaches the inner batcher (8-device conftest mesh)
    assert kern.mesh_size == 8
    assert kern.supports_on_final
    assert kern.close() is True


def test_explicit_backend_builds_blocking():
    opt = _opts(device_backend="cpu")
    kern = dk.make_device_kernel(opt, Params.make("n"))
    assert isinstance(kern, dk.DeviceTalco)
    kern.close()


def test_device_selection_builds_blocking():
    opt = _opts(device_num=2, device_index=[0, 4])
    kern = dk.make_device_kernel(opt, Params.make("n"))
    assert isinstance(kern, dk.DeviceTalco)
    assert kern.mesh_size == 2
    kern.close()


def test_lazy_cutover_e2e(tmp_path, monkeypatch):
    """--backend auto end-to-end with the lazy kernel: levels aligned
    before the batcher finishes building run on the host, later levels
    on the (CPU-backend) device — bytes must equal the oracle run."""
    import subprocess
    import sys

    from twilight_tpu import cli

    prefix = str(tmp_path / "mini")
    r = subprocess.run(
        [sys.executable, "-m", "twilight_tpu.tools.simulate",
         "-n", "24", "-l", "120", "--seed", "9", "-o", prefix],
        capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-300:]

    ref_out = str(tmp_path / "ref.aln")
    assert cli.main(["-t", prefix + ".nwk", "-i", prefix + ".fa",
                     "-o", ref_out, "--rooted", "--backend", "numpy"]) == 0

    # force the auto path past the small-workload AND single-core host
    # gates so the post-cutover levels actually use the mesh
    monkeypatch.setattr(cli, "_small_workload", lambda *a, **k: False)
    monkeypatch.setattr(cli, "_single_core_host", lambda: False)
    monkeypatch.setenv("TWILIGHT_FORCE_DEVICE", "0")  # keep lazy enabled
    monkeypatch.delenv("TWILIGHT_FORCE_DEVICE", raising=False)
    lazy_out = str(tmp_path / "lazy.aln")
    rc = cli.main(["-t", prefix + ".nwk", "-i", prefix + ".fa",
                   "-o", lazy_out, "--rooted", "--backend", "auto",
                   "--pair-batch", "8"])
    assert rc == 0
    with open(ref_out, "rb") as f1, open(lazy_out, "rb") as f2:
        assert f1.read() == f2.read()


def test_unready_kernel_skips_device(monkeypatch):
    """align_pairs must treat a still-building kernel as absent."""
    from twilight_tpu.pipeline import aligner

    class Stub:
        calls = 0

        def poll_ready(self):
            return False

        def __call__(self, *a, **k):  # pragma: no cover - must not run
            Stub.calls += 1
            raise AssertionError("unready kernel was invoked")

    # empty pair list: the function returns after the dispatch gate
    aligner.align_pairs([], __import__(
        "twilight_tpu.core.seqdb", fromlist=["SequenceDB"]).SequenceDB(),
        _opts(), Params.make("n"), kernel=Stub())
    assert Stub.calls == 0
