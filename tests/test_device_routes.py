"""Device kernel routes around the DP: the static-window error, the
batcher's kernel choice, packing and launch sizes, the compile-cache
placement, launch-failure propagation, --backend gpu without a GPU, the
f32 gram's precision and the keyed native builds. The CUDA kernel itself
has no CPU mode; its parity test is marked `gpu`."""
import os
import sys

import numpy as np
import pytest

from twilight_tpu import cli, native
from twilight_tpu.config import Options, Params
from twilight_tpu.ops import device_kernel as dk
from twilight_tpu.ops import talco_gpu, talco_jax, talco_np

from conftest import REPO, random_profile_pair
from test_talco_kernel import GE, GO, pack_jax_batch

sys.path.insert(0, os.path.join(REPO, "tools"))


def _prot_pair(rng, ln, qn):
    a = rng.integers(0, 20, ln)
    b = a[:qn].copy() if qn <= ln else np.concatenate(
        [a, rng.integers(0, 20, qn - ln)])
    hit = rng.random(qn) < 0.15
    b[hit] = rng.integers(0, 20, int(hit.sum()))
    fr = np.zeros((ln, 22), np.float32)
    fq = np.zeros((qn, 22), np.float32)
    fr[np.arange(ln), a] = 1.0
    fq[np.arange(qn), b] = 1.0
    return fr, fq


@pytest.mark.parametrize("p", [6, 22], ids=["nt", "protein"])
def test_talco_jax_reports_static_window_overflow(rng, p):
    """A band wider than the static FLEN window is error 6 (the batcher
    escalates it), never a silently cut band."""
    if p == 6:
        fr, fq = random_profile_pair(rng, 200, 190)
        matrix = np.asarray(Params.make("n").scoring_matrix, np.float32)
    else:
        fr, fq = _prot_pair(rng, 150, 140)
        matrix = np.asarray(Params.make("p").scoring_matrix, np.float32)
    kern = talco_jax.get_batch_kernel(256, 16, p, 1024, matrix.tobytes(),
                                      matrix.shape[0])
    _, tail = kern(*pack_jax_batch([(fr, fq)], 256, 16))
    assert int(np.asarray(tail)[0, 1]) == 6
    # a window that holds the band gives the oracle's path
    kern = talco_jax.get_batch_kernel(256, 256, p, 1024, matrix.tobytes(),
                                      matrix.shape[0])
    out, tail = kern(*pack_jax_batch([(fr, fq)], 256, 256))
    tp = talco_np.TalcoRunParams(matrix, GO, GE, GE, 5000)
    lens = (len(fr), len(fq))
    gold, gerr = talco_np.align_freq(
        tp, fr, fq, (np.full(lens[0], GO, np.float32),
                     np.full(lens[1], GO, np.float32)),
        (np.full(lens[0], GE, np.float32), np.full(lens[1], GE, np.float32)),
        (1.0, 1.0))
    tail = np.asarray(tail)
    assert gerr == 0 and int(tail[0, 1]) == 0 and int(tail[0, 2]) > 0
    np.testing.assert_array_equal(np.asarray(out)[0, :tail[0, 0]], gold)


def test_pack_pair_into_layout():
    fr = np.arange(12, dtype=np.float32).reshape(3, 4)
    fr = np.pad(fr, ((0, 0), (0, 2)))
    fq = np.ones((2, 6), np.float32)
    go = (np.array([-1, -2, -3], np.float32), np.array([-4, -5], np.float32))
    ge = (np.array([-6, -7, -8], np.float32), np.array([-9, -10], np.float32))
    ref = np.zeros((10, 8), np.float32)
    qry = np.zeros((10, 8), np.float32)
    talco_jax.pack_pair_into(ref, qry, fr, fq, go, ge, padlen=6, off=2)
    # reversed reference ends at off + padlen; gaps in the last columns
    np.testing.assert_array_equal(ref[5:8, :6], fr[::-1])
    np.testing.assert_array_equal(ref[5:8, 6], go[0][::-1])
    np.testing.assert_array_equal(ref[5:8, 7], ge[0][::-1])
    assert not ref[:5].any() and not ref[8:].any()
    np.testing.assert_array_equal(qry[2:4, :6], fq)
    np.testing.assert_array_equal(qry[2:4, 6], go[1])
    np.testing.assert_array_equal(qry[2:4, 7], ge[1])
    assert talco_jax.p8_of(6) == 8 and talco_jax.p8_of(22) == 24


def test_cuda_shared_memory_plan():
    """The shared-memory plan of talco_cuda.cu fixes the widest window the
    GPU route can hold: 4096 for both alphabets within Hopper's 227 KB."""
    assert talco_gpu.max_window(5) == 4096
    assert talco_gpu.max_window(21) == 4096
    assert talco_gpu.shared_bytes(4096, 21) <= talco_gpu.SMEM_LIMIT
    assert talco_gpu.shared_bytes(8192, 5) > talco_gpu.SMEM_LIMIT
    assert talco_gpu.maxaln(2048) == talco_jax.maxaln(2048)
    with pytest.raises(ValueError, match="shared-memory plan"):
        talco_gpu.get_batch_kernel(2048, 8192, 1024, b"\0" * 100, 5)


class _Dev:
    def __init__(self, platform):
        self.platform = platform
        self.device_kind = platform


def _batcher(platform, monkeypatch, pair_batch=1024, mesh_size=1):
    """A DeviceTalco as __init__ would build it on `platform`, without
    touching a device (route choice and shapes only)."""
    monkeypatch.setattr(dk, "local_devices",
                        lambda jax_mod, backend: [_Dev(platform)])
    monkeypatch.setattr(talco_gpu, "register", lambda: None)
    monkeypatch.setattr(dk, "compile_cache_dir", lambda platform: None)
    dt = dk.DeviceTalco(Options(device_backend="gpu", pair_batch=pair_batch),
                        Params.make("n"))
    dt.mesh_size = mesh_size
    return dt


def test_kernel_choice_by_platform(monkeypatch):
    gpu = _batcher("gpu", monkeypatch)
    assert gpu.route == "cuda" and gpu.max_window == 4096
    calls = []
    monkeypatch.setattr(talco_gpu, "get_batch_kernel",
                        lambda *a: calls.append(a) or "cuda-fn")
    fn, off, tot = gpu._kernel(2048, 512)
    assert (fn, off, tot) == ("cuda-fn", 0, 2048)
    assert calls[0][:3] == (2048, 512, 1024)
    cpu = _batcher("cpu", monkeypatch)
    assert cpu.route == "xla" and cpu.max_window == 1 << 15
    fn, off, tot = cpu._kernel(2048, 512)
    assert (off, tot) == (512, 512 + 2048 + 512)
    assert fn is talco_jax.get_batch_kernel(2048, 512, 6, 1024,
                                            cpu.matrix_bytes, cpu.msize)
    assert [r[2] for r in gpu.kernel_requests + cpu.kernel_requests] \
        == ["cuda", "xla"]


def test_launch_sizes(monkeypatch):
    dt = _batcher("gpu", monkeypatch, pair_batch=1024)
    assert dt._launch_batch(3, 2048, 512) == 4
    assert dt._launch_batch(5000, 2048, 512) == 1024
    assert dt._launch_batch(5000, 32768, 512) == 64      # long bucket
    assert dt._launch_batch(5000, 2048, 4096) == 128     # wide window
    dt.mesh_size = 4
    assert dt._launch_batch(3, 2048, 512) == 4           # one per device
    assert dt._launch_batch(9, 2048, 512) == 16
    # a partial launch still deals its pairs over every shard
    placed = dt._place(list(range(9)), 16)
    per_device = [sum(1 for slot, _ in placed if slot // 4 == d)
                  for d in range(4)]
    assert per_device == [3, 2, 2, 2]
    assert sorted(i for _, i in placed) == list(range(9))
    assert len({slot for slot, _ in placed}) == 9
    # XLA: one program per (padlen, window), always the full cap
    cpu = _batcher("cpu", monkeypatch, pair_batch=8)
    assert cpu._launch_batch(3, 2048, 512) == 8
    assert cpu._launch_batch(3, 2048, 2048) == 2


def test_pack_batch_pads_with_dummies(monkeypatch, rng):
    dt = _batcher("gpu", monkeypatch)
    fr, fq = random_profile_pair(rng, 40, 30)
    gop = (np.full(40, GO, np.float32), np.full(30, GO, np.float32))
    gex = (np.full(40, GE, np.float32), np.full(30, GE, np.float32))
    prep = (fr, fq, None, None, (40, 30), gop, gex)
    ref, qry, mi, mf = dt._pack_batch([(0, 0)], [prep],
                                      [(40, 30, 1, 20000)], 0, 64, 0, 64, 4,
                                      [4096], [5000])
    assert ref.shape == (4, 64, 8) and qry.shape == (4, 64, 8)
    np.testing.assert_array_equal(ref[0, 24:64, :6], fr[::-1])
    np.testing.assert_array_equal(qry[0, 0:30, :6], fq)
    assert tuple(mi[0]) == (40, 30, 4096, 5000)
    # qry_num > 10000 zeroes the gap-char score (reference rule)
    assert tuple(mf[0]) == (1.0, 20000.0, 0.0, GO, GE)
    assert (mi[1:, :2] == 1).all() and not ref[1:].any()


@pytest.mark.parametrize("env", [None, "/some/cache"], ids=["default", "env"])
def test_compile_cache_placement(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert dk.compile_cache_dir("gpu") == os.path.join(REPO,
                                                           ".jax_cache")
        assert dk.compile_cache_dir("cpu") is None
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert dk.compile_cache_dir("gpu") == env
        assert dk.compile_cache_dir("cpu") == env


def _level(rng, n, p=6, ln=60):
    pairs = []
    for _ in range(n):
        if p == 6:
            fr, fq = random_profile_pair(rng, ln, ln - 3)
        else:
            fr, fq = _prot_pair(rng, ln, ln - 3)
        r, q = fr.shape[0], fq.shape[0]
        pairs.append((fr, fq, None, ([], []), (r, q),
                      (np.full(r, GO, np.float32), np.full(q, GO, np.float32)),
                      (np.full(r, GE, np.float32), np.full(q, GE, np.float32))))
    return pairs, [(p_[4][0], p_[4][1], 1, 1) for p_ in pairs]


class _DB:
    current_task = 0


def _oracle(param, prep):
    fr, fq, _, _, lens, go, ge = prep
    tp = talco_np.TalcoRunParams(param.scoring_matrix, param.gap_open,
                                 param.gap_extend, param.gap_extend,
                                 int(1000 * -param.gap_extend))
    return talco_np.align_freq(tp, fr, fq, go, ge, (1.0, 1.0))


@pytest.mark.parametrize("kind", ["protein", "escalated"])
def test_cpu_batcher_matches_oracle(monkeypatch, rng, kind):
    """--backend cpu (XLA route) through the real batcher: protein pairs,
    and nucleotide pairs whose band outgrows a 16-column starting window
    (error 6 -> relaunch at 64, then 256)."""
    monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")
    monkeypatch.setenv("TWILIGHT_NO_MESH", "1")
    if kind == "escalated":
        monkeypatch.setenv("TWILIGHT_INIT_WINDOW", "16")
    typ = "p" if kind == "protein" else "n"
    opt = Options(device_backend="cpu", pair_batch=4, type=typ)
    param = Params.make(typ)
    dt = dk.DeviceTalco(opt, param)
    prepared, metas = _level(rng, 3, p=22 if typ == "p" else 6)
    res = dt(prepared, metas, _DB(), opt, param)
    for prep, got in zip(prepared, res):
        gold, gerr = _oracle(param, prep)
        assert gerr == 0
        np.testing.assert_array_equal(got, gold)
    windows = {w for (_, w, _, _) in dt.kernel_requests}
    if kind == "escalated":
        assert {16, 64} <= windows
    assert dt.stats["device"] == 3 and dt.stats["stolen"] == 0
    dt.close()
    assert dk.LAST_STATS["device"] == 3


def test_launch_failure_propagates(monkeypatch, rng):
    """A launch that raises is an error of the run, not a host fallback."""
    monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")
    opt = Options(device_backend="cpu", pair_batch=4)
    param = Params.make("n")
    dt = dk.DeviceTalco(opt, param)

    def broken(*args):
        raise RuntimeError("device fault")

    monkeypatch.setattr(dt, "_kernel", lambda padlen, flen: (broken, 0, 2048))
    prepared, metas = _level(rng, 2)
    with pytest.raises(RuntimeError, match="device fault"):
        dt(prepared, metas, _DB(), opt, param)
    assert dt.stats["stolen"] == 0


def test_backend_gpu_without_gpu_exits_nonzero(tmp_path, capfd):
    rc = cli.main(["-t", os.path.join(REPO, "tests/data/prot_16.nwk"),
                   "-i", os.path.join(REPO, "tests/data/prot_16.fa"),
                   "-o", str(tmp_path / "o.aln"), "--backend", "gpu"])
    assert rc != 0
    assert "--backend gpu: no usable device" in capfd.readouterr().err
    assert not (tmp_path / "o.aln").exists()


def test_gram_is_pinned_to_highest_precision():
    import jax
    from twilight_tpu.trees import estimate
    x = np.ones((4, 3), np.float32)
    jaxpr = str(jax.make_jaxpr(estimate.gram_device_fn())(x))
    assert "Precision.HIGHEST" in jaxpr
    np.testing.assert_array_equal(
        np.asarray(estimate.gram_device_fn()(x)), x @ x.T)


def test_native_library_rebuilt_for_other_flags(monkeypatch, tmp_path):
    """A build keys on source, flags and host: other flags (or a library
    left from another host) never load — this host builds its own."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    default = native.lib_path("stdorder")
    monkeypatch.setattr(native, "CXXFLAGS", native.CXXFLAGS + ["-O1"])
    other = native.lib_path("stdorder")
    assert other != default
    monkeypatch.setattr(native, "host_id", lambda: "another host")
    assert native.lib_path("stdorder") not in (default, other)
    monkeypatch.undo()
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXXFLAGS", native.CXXFLAGS + ["-O1"])
    monkeypatch.setattr(native, "_LIBS", {})
    # a stale file under the default name is not what the -O1 build loads
    open(default, "wb").close()
    lib = native.load("stdorder")
    assert lib is not None and os.path.exists(other)


@pytest.mark.gpu
def test_cuda_kernel_matches_oracle(gpu):
    """The CUDA kernel on the card against talco_np on every route: 2048
    nt, protein, 32768 long pairs, an escalated window, multi-tile, error
    1 and error 2 pairs — zero mismatches."""
    import bench_kernel
    assert bench_kernel.parity(["cuda"], bench_kernel.CASES) == 0
