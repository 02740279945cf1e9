"""TALCO-XDrop kernel parity: JAX (lax) batch kernel vs NumPy oracle.

The oracle (twilight_tpu/ops/talco_np.py) is validated byte-for-byte against
the reference binary through the end-to-end goldens; here the device kernel
is held to bit-identical alignment paths on random profile pairs, including
multi-tile convergence and error codes (reference TALCO-XDrop.cpp:62-108).
"""
import numpy as np
import pytest

from twilight_tpu.ops import talco_jax, talco_np

from conftest import random_profile_pair

MATCH, MISMATCH, TRANSITION = 18.0, -8.0, -4.0
GO, GE = -50.0, -5.0


def nuc_matrix():
    m = np.zeros((6, 6), dtype=np.float32)
    for i in range(5):
        for j in range(5):
            if i == j:
                m[i, j] = MATCH
            elif abs(i - j) == 2:
                m[i, j] = TRANSITION
            else:
                m[i, j] = MISMATCH
    for i in range(5):
        m[i, 4] = m[4, i] = 0.0
    m[4, 4] = 0.0
    return m


def run_oracle(fr, fq, marker=1024, flen=4096, xdrop=5000, gap_char=GE):
    lens = (fr.shape[0], fq.shape[0])
    gap_op = (np.full(lens[0], GO, np.float32), np.full(lens[1], GO, np.float32))
    gap_ex = (np.full(lens[0], GE, np.float32), np.full(lens[1], GE, np.float32))
    tp = talco_np.TalcoRunParams(nuc_matrix(), GO, GE, gap_char, xdrop,
                                 flen=flen, marker=marker)
    return talco_np.align_freq(tp, fr, fq, gap_op, gap_ex, (1.0, 1.0))


def pack_jax_batch(pairs, padlen, flen, nums=None, xdrop=5000,
                   gap_char=GE, flen_param=4096):
    """(ref, qry, meta_i, meta_f) in talco_jax's packed layout."""
    b = len(pairs)
    p = pairs[0][0].shape[1]
    p8 = talco_jax.p8_of(p)
    tot = flen + padlen + flen
    ref = np.zeros((b, tot, p8), np.float32)
    qry = np.zeros((b, tot, p8), np.float32)
    meta_i = np.zeros((b, 4), np.int32)
    meta_f = np.zeros((b, 5), np.float32)
    for i, (fr, fq) in enumerate(pairs):
        go = (np.full(fr.shape[0], GO, np.float32),
              np.full(fq.shape[0], GO, np.float32))
        ge = (np.full(fr.shape[0], GE, np.float32),
              np.full(fq.shape[0], GE, np.float32))
        talco_jax.pack_pair_into(ref[i], qry[i], fr, fq, go, ge, padlen,
                                 flen)
        rn, qn = nums[i] if nums is not None else (1.0, 1.0)
        meta_i[i] = (fr.shape[0], fq.shape[0], flen_param, xdrop)
        meta_f[i] = (rn, qn, gap_char, GO, GE)
    return ref, qry, meta_i, meta_f


def run_jax(pairs, padlen, flen, marker=1024, xdrop=5000, gap_char=GE,
            flen_param=4096):
    m = nuc_matrix()
    kern = talco_jax.get_batch_kernel(padlen, flen, 6, marker,
                                      m.tobytes(), 6)
    out_buf, tail = kern(*pack_jax_batch(pairs, padlen, flen, xdrop=xdrop,
                                         gap_char=gap_char,
                                         flen_param=flen_param))
    tail = np.asarray(tail)
    return np.asarray(out_buf), tail[:, 0], tail[:, 1]


def path_consumes(path, rl, ql):
    r = int(np.sum(path != 1))
    q = int(np.sum(path != 2))
    return r == rl and q == ql


def test_oracle_path_wellformed(rng):
    fr, fq = random_profile_pair(rng, 200, 190)
    path, err = run_oracle(fr, fq)
    assert err == 0
    assert path_consumes(path, 200, 190)


def test_jax_matches_oracle_batch(rng):
    cases = [(120, 120), (200, 190), (64, 80), (250, 230)]
    pairs = [random_profile_pair(rng, r, q) for r, q in cases]
    out, lens, errs = run_jax(pairs, padlen=256, flen=256)
    for i, (fr, fq) in enumerate(pairs):
        gold, gerr = run_oracle(fr, fq)
        assert errs[i] == gerr == 0
        assert lens[i] == len(gold)
        np.testing.assert_array_equal(out[i, :lens[i]], gold)


def test_jax_matches_oracle_multitile(rng):
    """marker=64 forces several convergence tiles on a 300-col pair.
    (The oracle's flen is the reference ladder parameter == the kernel's
    flen_param; the kernel's static FLEN window is independent.)"""
    fr, fq = random_profile_pair(rng, 300, 310)
    gold, gerr = run_oracle(fr, fq, marker=64, flen=4096)
    assert gerr == 0
    out, lens, errs = run_jax([(fr, fq)], padlen=512, flen=512, marker=64)
    assert errs[0] == 0
    assert lens[0] == len(gold)
    np.testing.assert_array_equal(out[0, :lens[0]], gold)


def test_jax_profile_pairs_match(rng):
    """Non-one-hot profiles (weighted frequency columns, num>1)."""
    fr1, fq1 = random_profile_pair(rng, 150, 150, num=1.0)
    fr2, _ = random_profile_pair(rng, 150, 150, num=1.0)
    fr = (fr1 + fr2)  # 2-sequence profile
    lens = (150, 150)
    gap_op = (np.full(150, GO, np.float32), np.full(150, GO, np.float32))
    gap_ex = (np.full(150, GE, np.float32), np.full(150, GE, np.float32))
    tp = talco_np.TalcoRunParams(nuc_matrix(), GO, GE, GE, 5000)
    gold, gerr = talco_np.align_freq(tp, fr, fq1, gap_op, gap_ex, (2.0, 1.0))
    assert gerr == 0

    kern = talco_jax.get_batch_kernel(256, 256, 6, 1024,
                                      nuc_matrix().tobytes(), 6)
    out, tail = kern(*pack_jax_batch([(fr, fq1)], 256, 256,
                                     nums=[(2.0, 1.0)]))
    tail = np.asarray(tail)
    assert int(tail[0, 1]) == 0
    assert int(tail[0, 0]) == len(gold)
    np.testing.assert_array_equal(np.asarray(out)[0, :len(gold)], gold)


def test_unrelated_sequences_error_parity(rng):
    """Totally unrelated sequences kill the X-drop band; the device kernel
    must report the same error class so the host ladder stays in sync."""
    fr = np.zeros((180, 6), np.float32)
    fq = np.zeros((180, 6), np.float32)
    fr[np.arange(180), rng.integers(0, 4, 180)] = 1.0
    fq[np.arange(180), rng.integers(0, 4, 180)] = 1.0
    _, gerr = run_oracle(fr, fq, xdrop=40)
    out, lens, errs = run_jax([(fr, fq)], padlen=256, flen=256, xdrop=40)
    if gerr == 0:
        assert errs[0] == 0
    else:
        assert errs[0] == gerr


def test_native_matches_oracle_fuzz(rng):
    """The native C++ kernel (AVX2 across-cells path) must be bit-exact
    with the oracle — the executable form of the CLAUDE.md invariant for
    native/talco.cpp. Mixed lengths, multi-tile (small marker), weighted
    profiles; vector groups, scalar tails and border cells all covered."""
    from twilight_tpu.ops import talco_host
    if not talco_host.available():
        pytest.skip("no toolchain for the native kernel")
    for t in range(14):
        r = int(rng.integers(30, 900))
        q = max(25, r + int(rng.integers(-60, 60)))
        num = 1.0 if t % 3 else 2.0
        fr, fq = random_profile_pair(rng, r, q, num=num)
        nn = num
        if t % 5 == 0:
            fr2, fq2 = random_profile_pair(rng, r, q, num=num)
            fr, fq = fr + fr2, fq + fq2
            nn = num * 2
        gap_op = (np.full(r, GO, np.float32), np.full(q, GO, np.float32))
        gap_ex = (np.full(r, GE, np.float32), np.full(q, GE, np.float32))
        marker = 64 if t % 4 == 0 else 1024
        tp = talco_np.TalcoRunParams(nuc_matrix(), GO, GE, GE, 5000,
                                     marker=marker)
        gold, gerr = talco_np.align_freq(tp, fr, fq, gap_op, gap_ex,
                                         (nn, nn))
        got, err = talco_host.align_freq(tp, fr, fq, gap_op, gap_ex,
                                         (nn, nn))
        assert err == gerr, f"case {t}: err {err} vs {gerr}"
        if gerr == 0:
            np.testing.assert_array_equal(got, gold, err_msg=f"case {t}")


def test_native_pure_column_table_fuzz(rng):
    """The native kernel's pure-column sim-table path (talco.cpp: one
    gather per cell when both columns bitwise-equal their profile num)
    must be bit-exact with the oracle across its gating edge cases:
    fractional num, mixed pure/impure columns (per-block fallback),
    protein (P=22, BLOSUM62 with wildcard row), and num values whose
    bit pattern must match exactly."""
    from twilight_tpu.ops import talco_host
    from twilight_tpu.config import Params

    if not talco_host.available():
        pytest.skip("no toolchain for the native kernel")
    prot = Params.make("p").scoring_matrix
    for t in range(10):
        p = 22 if t % 2 else 6
        mat = prot if p == 22 else nuc_matrix()
        r = int(rng.integers(60, 400))
        q = max(40, r + int(rng.integers(-40, 40)))
        num = [1.0, 1.7, 3.0, np.float32(0.30000001)][t % 4]
        fr, fq = random_profile_pair(rng, r, q, p=p, num=num)
        if t % 3 == 0:
            # poison a random subset of columns so the vector path must
            # mix table blocks with full-similarity blocks
            for f in (fr, fq):
                idx = rng.integers(0, f.shape[0], size=max(2, f.shape[0] // 7))
                f[idx, rng.integers(0, p, size=len(idx))] += np.float32(0.25)
        gap_op = (np.full(r, GO, np.float32), np.full(q, GO, np.float32))
        gap_ex = (np.full(r, GE, np.float32), np.full(q, GE, np.float32))
        tp = talco_np.TalcoRunParams(mat, GO, GE, GE, 5000,
                                     marker=64 if t % 4 == 0 else 1024)
        nn = float(num)
        gold, gerr = talco_np.align_freq(tp, fr, fq, gap_op, gap_ex, (nn, nn))
        got, err = talco_host.align_freq(tp, fr, fq, gap_op, gap_ex, (nn, nn))
        assert err == gerr, f"case {t} (p={p}): err {err} vs {gerr}"
        if gerr == 0:
            np.testing.assert_array_equal(got, gold,
                                          err_msg=f"case {t} (p={p})")
