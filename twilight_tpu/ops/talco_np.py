"""TALCO-XDrop profile-profile alignment — NumPy reference oracle.

Exact reimplementation of the reference kernel semantics
(/root/reference/src/TALCO-XDrop.cpp): tiled anti-diagonal wavefront with
X-drop pruning, convergence-marker tiling, affine position-specific gaps,
4-bit traceback. Float32 operation ordering matches the reference's
TALCO_SIMD build (the binary our goldens come from), so alignment paths are
bit-identical. Each anti-diagonal is vectorized; this module is the oracle
the JAX and CUDA kernels are validated against, and the host fallback path.

Path codes: 0 = match (both advance), 1 = insertion (query advances),
2 = deletion (reference advances).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

I_BOUNDARY = -2
D_BOUNDARY = -3
I_BOUNDARY_LOW16 = I_BOUNDARY & 0xFFFF   # 65534
D_BOUNDARY_LOW16 = D_BOUNDARY & 0xFFFF   # 65533

F32 = np.float32


class TalcoRunParams:
    """Mutable per-pair kernel parameters (retry ladder updates fLen/xdrop)."""
    __slots__ = ("matrix", "matrix_size", "gap_open", "gap_extend",
                 "gap_char_score", "xdrop", "flen", "marker")

    def __init__(self, matrix: np.ndarray, gap_open: float, gap_extend: float,
                 gap_char_score: float, xdrop: int, flen: int = 1 << 12,
                 marker: int = 1 << 10):
        self.matrix = matrix.astype(np.float32)
        self.matrix_size = matrix.shape[0]
        self.gap_open = F32(gap_open)
        self.gap_extend = F32(gap_extend)
        self.gap_char_score = F32(gap_char_score)
        self.xdrop = int(xdrop)
        self.flen = int(flen)
        self.marker = int(marker)


def similarity_scores(ref_rows: np.ndarray, qry_rows: np.ndarray,
                      matrix: np.ndarray, gap_char: np.float32,
                      denominator: np.float32) -> np.ndarray:
    """Expected profile-pair substitution score per cell, reproducing the
    reference's SIMD summation order (TALCO-XDrop.cpp:377-433).

    ref_rows/qry_rows: [n, P] f32 profile columns for the cells of one
    anti-diagonal. P = 6 (nucleotide) or 22 (protein).
    """
    n, p = ref_rows.shape
    num = np.zeros(n, dtype=np.float32)
    if p == 6:
        # for each l: hsum_m((qry[m]*M[l,m])*ref[l]) over m=0..4, summed
        # left-associatively, then the gap row/col terms
        for l in range(5):
            tmp = (qry_rows[:, :5] * matrix[l, :5]) * ref_rows[:, l:l + 1]
            s = tmp[:, 0]
            for m in range(1, 5):
                s = s + tmp[:, m]
            num = num + s
        for l in range(5):
            num = num + (ref_rows[:, l] * qry_rows[:, 5]) * gap_char
        for m in range(5):
            num = num + (ref_rows[:, 5] * qry_rows[:, m]) * gap_char
    else:
        # protein: per l, two 8-lane chunks accumulated per lane, the m=16..20
        # tail added scalar-first, then the 8-lane horizontal sum
        for l in range(21):
            sumvec = (qry_rows[:, 0:8] * matrix[l, 0:8]) * ref_rows[:, l:l + 1]
            sumvec = sumvec + (qry_rows[:, 8:16] * matrix[l, 8:16]) * ref_rows[:, l:l + 1]
            for m in range(16, 21):
                num = num + (ref_rows[:, l] * qry_rows[:, m]) * matrix[l, m]
            s = sumvec[:, 0]
            for j in range(1, 8):
                s = s + sumvec[:, j]
            num = num + s
        for l in range(21):
            num = num + (ref_rows[:, l] * qry_rows[:, 21]) * gap_char
        for m in range(21):
            num = num + (ref_rows[:, 21] * qry_rows[:, m]) * gap_char
    return num / denominator


def _reduction(c: np.ndarray, start: int, length: int) -> int:
    """Reference Reduction_tree (TALCO-XDrop.cpp:110-119): inclusive scan
    [start, start+length]; -1 when not all equal."""
    start = min(start, len(c) - 1)
    if length < 0:
        return int(c[start])
    end = min(start + length, len(c) - 1)
    seg = c[start:end + 1]
    conv = int(seg[0])
    if np.all(seg == conv):
        return conv
    return -1


def _traceback(ftr_length: List[int], ftr_lower_limit: List[int],
               tb_start_addr: int, tb_start_ftr: int, tb_state: int,
               tb_start_idx: int, ref_start_idx: int, tb: np.ndarray,
               aln: List[int], first_tile: bool) -> None:
    """Reference Traceback (TALCO-XDrop.cpp:134-231)."""
    addr = tb_start_addr
    ftr = tb_start_ftr
    idx = tb_start_idx
    query_idx = tb_start_idx
    ref_idx = ref_start_idx
    state = tb_state
    while ftr >= 0:
        if addr < 0:
            raise RuntimeError("traceback address < 0")
        tb_value = int(tb[addr])
        if state == 0:
            state = tb_value & 0x03
            if state == 0:
                dir_ = 0
            elif state == 1:
                dir_ = 1
                state = 1 if (tb_value & 0x04) else 0
            else:
                dir_ = 2
                state = 2 if (tb_value & 0x08) else 0
        elif state == 1:
            dir_ = 1
            state = 1 if (tb_value & 0x04) else 0
        else:
            dir_ = 2
            state = 2 if (tb_value & 0x08) else 0
        if ftr > 0:
            addr = addr - (idx - ftr_lower_limit[ftr] + 1) - ftr_length[ftr - 1]
        if dir_ == 0:
            if ftr > 1:
                addr = addr - ftr_length[ftr - 2] + (idx - ftr_lower_limit[ftr - 2])
            ftr -= 2
            idx -= 1
            query_idx -= 1
            ref_idx -= 1
        elif dir_ == 1:
            if ftr > 0:
                addr = addr + (idx - ftr_lower_limit[ftr - 1])
            ftr -= 1
            idx -= 1
            query_idx -= 1
        else:
            if ftr > 0:
                addr = addr + (idx - ftr_lower_limit[ftr - 1] + 1)
            ftr -= 1
            ref_idx -= 1
        aln.append(dir_)
        if first_tile and (ref_idx < 0 or query_idx < 0):
            break
    if first_tile:
        while ref_idx > -1:
            aln.append(2)
            ref_idx -= 1
        while query_idx > -1:
            aln.append(1)
            query_idx -= 1


def tile(reference: np.ndarray, query: np.ndarray,
         gap_open_rq: Tuple[np.ndarray, np.ndarray],
         gap_ext_rq: Tuple[np.ndarray, np.ndarray],
         num: Tuple[float, float], param: TalcoRunParams,
         reference_idx: int, query_idx: int, tile_no: int
         ) -> Tuple[List[int], int, int, bool, int]:
    """One TALCO tile (reference Tile, TALCO-XDrop.cpp:233-688).

    Returns (tile_aln_reversed, new_reference_idx, new_query_idx, last_tile,
    error_type). tile_aln is in traceback order (end→start), matching the
    reference's in-out `aln` vector for one tile.
    """
    inf = F32(2.0 * param.xdrop + 1.0)
    neg_inf = F32(-inf)
    marker = param.marker
    ref_total = reference.shape[0]
    qry_total = query.shape[0]
    ref_len = ref_total - reference_idx
    qry_len = qry_total - query_idx
    if ref_len < 0 or qry_len < 0:
        return [], reference_idx, query_idx, True, 3
    flen = min(param.flen, min(ref_len, qry_len))

    ref_num = F32(num[0])
    qry_num = F32(num[1])
    denominator = ref_num * qry_num
    gap_open = param.gap_open
    gap_extend = param.gap_extend
    # alnType == 0 (global): end gaps penalized with the regular gap scores
    gap_open_ends = gap_open
    gap_extend_ends = gap_extend

    # rolling buffers — stale values persist across diagonals like the
    # reference's heap arrays
    S = np.full((3, flen), F32(-1.0), dtype=np.float32)
    I = np.full((2, flen), F32(-1.0), dtype=np.float32)
    D = np.full((2, flen), F32(-1.0), dtype=np.float32)
    CS = np.full((3, flen), -1, dtype=np.int32)
    CI = np.full((2, flen), I_BOUNDARY, dtype=np.int32)
    CD = np.full((2, flen), D_BOUNDARY, dtype=np.int32)
    L = [0, 1, 2]
    U = [0, -1, -2]

    tb_rows: List[np.ndarray] = []
    ftr_length: List[int] = []
    ftr_lower_limit: List[int] = []
    ftr_addr = 0
    last_k = 0
    prev_conv_s = -1
    converged = False
    conv_logic = False
    conv_value = 0
    conv_score = F32(0.0)
    max_score = F32(0.0)
    max_score_prime = neg_inf

    gap_op_ref, gap_op_qry = gap_open_rq
    gap_ex_ref, gap_ex_qry = gap_ext_rq

    cell_count = ref_len + qry_len - 1
    for k in range(cell_count):
        k3 = k % 3
        k3p1 = (k + 1) % 3
        k3p2 = (k + 2) % 3
        k2 = k % 2
        k2p1 = (k + 1) % 2
        Lk, Uk = L[k3], U[k3]
        if Lk >= Uk + 1:
            return [], reference_idx, query_idx, True, 1
        count = Uk - Lk + 1
        if count > flen:
            return [], reference_idx, query_idx, True, 2

        if k <= marker:
            ftr_length.append(count)
            ftr_lower_limit.append(Lk)
            ftr_addr += count

        i_arr = np.arange(Lk, Uk + 1, dtype=np.int64)
        lprime = max(0, k - ref_len + 1)
        jmax = min(k, ref_len - 1)
        j_arr = jmax - (i_arr - lprime)
        offset = i_arr - Lk  # 0..count-1

        offset_diag = Lk - L[k3p1] + offset - 1
        offset_up = Lk - L[k3p2] + offset
        offset_left = Lk - L[k3p2] + offset - 1

        # --- match (substitution) channel ---
        diag_valid = (offset_diag >= 0) & (offset_diag <= U[k3p1] - L[k3p1])
        border = (tile_no == 0) & ((i_arr == 0) | (j_arr == 0))
        compute_sim = (k == 0) | diag_valid | border

        match = np.full(count, neg_inf, dtype=np.float32)
        if np.any(compute_sim):
            ref_rows = reference[reference_idx + j_arr]
            qry_rows = query[query_idx + i_arr]
            sim = similarity_scores(ref_rows, qry_rows, param.matrix,
                                    param.gap_char_score, denominator)
            # border formula: sim + go_ends + ge_ends * max(0, max(abs_r, abs_q) - 1)
            steps = np.maximum(
                0, np.maximum(reference_idx + j_arr, query_idx + i_arr) - 1
            ).astype(np.float32)
            border_val = sim + gap_open_ends + gap_extend_ends * steps
            origin = (i_arr == 0) & (j_arr == 0)
            border_val = np.where(origin, sim, border_val)
            diag_take = np.clip(offset_diag, 0, flen - 1)
            with_diag = S[k3p1][diag_take] + sim
            no_diag = sim
            m = np.where(border, border_val,
                         np.where(offset_diag < 0, no_diag, with_diag))
            match = np.where(compute_sim, m, match).astype(np.float32)

        # --- gap channels ---
        pos_go_ref = gap_op_ref[reference_idx + j_arr]
        pos_go_qry = gap_op_qry[query_idx + i_arr]
        pos_ge_ref = gap_ex_ref[reference_idx + j_arr]
        pos_ge_qry = gap_ex_qry[query_idx + i_arr]

        up_valid = (offset_up >= 0) & (offset_up <= U[k3p2] - L[k3p2])
        left_valid = (offset_left >= 0) & (offset_left <= U[k3p2] - L[k3p2])
        up_take = np.clip(offset_up, 0, flen - 1)
        left_take = np.clip(offset_left, 0, flen - 1)

        del_op = np.where(up_valid, S[k3p2][up_take] + pos_go_ref, neg_inf).astype(np.float32)
        del_ext = np.where(up_valid, D[k2p1][up_take] + pos_ge_ref, neg_inf).astype(np.float32)
        ins_op = np.where(left_valid, S[k3p2][left_take] + pos_go_qry, neg_inf).astype(np.float32)
        ins_ext = np.where(left_valid, I[k2p1][left_take] + pos_ge_qry, neg_inf).astype(np.float32)

        iptr = ins_ext >= ins_op
        dptr = del_ext >= del_op
        i_val = np.where(iptr, ins_ext, ins_op)
        d_val = np.where(dptr, del_ext, del_op)

        # tie-break order: match >= I ? (match >= D ? M : D) : (I > D ? I : D)
        m_ge_i = match >= i_val
        m_ge_d = match >= d_val
        i_gt_d = i_val > d_val
        s_val = np.where(m_ge_i, np.where(m_ge_d, match, d_val),
                         np.where(i_gt_d, i_val, d_val))
        ptr = np.where(m_ge_i, np.where(m_ge_d, 0, 2),
                       np.where(i_gt_d, 1, 2)).astype(np.int8)

        # X-drop kill
        killed = s_val < (max_score - F32(param.xdrop))
        s_val = np.where(killed, neg_inf, s_val).astype(np.float32)

        mx = np.max(s_val)
        if max_score_prime < mx:
            max_score_prime = F32(mx)

        # --- write back ---
        I[k2][:count] = i_val
        D[k2][:count] = d_val
        S[k3][:count] = s_val

        # --- convergence bookkeeping ---
        if k == marker - 1:
            CS[k3][:count] = (3 << 16) | (i_arr & 0xFFFF)
        elif k == marker:
            CS[k3][:count] = (0 << 16) | (i_arr & 0xFFFF)
            CI[k2][:count] = (1 << 16) | (i_arr & 0xFFFF)
            CD[k2][:count] = (2 << 16) | (i_arr & 0xFFFF)
        elif k >= marker + 1:
            ci_prop = np.where(offset_left >= 0, CI[k2p1][left_take], I_BOUNDARY)
            cs_left = CS[k3p2][left_take]
            ci_open = np.where((offset_left >= 0) & (cs_left != -1),
                               cs_left, I_BOUNDARY)
            new_ci = np.where(iptr, ci_prop, ci_open).astype(np.int32)

            cd_prop = np.where(offset_up >= 0, CD[k2p1][up_take], D_BOUNDARY)
            cs_up = CS[k3p2][up_take]
            cd_open = np.where((offset_up >= 0) & (cs_up != -1),
                               cs_up, D_BOUNDARY)
            new_cd = np.where(dptr, cd_prop, cd_open).astype(np.int32)

            cs_diag = CS[k3p1][diag_take]
            new_cs = np.where(ptr == 0, cs_diag,
                              np.where(ptr == 1, new_ci, new_cd)).astype(np.int32)
            CI[k2][:count] = new_ci
            CD[k2][:count] = new_cd
            CS[k3][:count] = new_cs

        ptr = ptr | (iptr.astype(np.int8) << 2) | (dptr.astype(np.int8) << 3)
        if k <= marker:
            tb_rows.append(ptr)

        # --- band shrink ---
        alive = s_val > neg_inf
        if not np.any(alive):
            new_l = Uk + 1
            new_u = Lk - 1
        else:
            nz = np.nonzero(alive)[0]
            new_l = Lk + int(nz[0])
            new_u = Lk + int(nz[-1])

        if (not converged) and (k < ref_len + qry_len - 2):
            conv_i = _reduction(CI[k2], new_l - Lk, new_u - new_l)
            conv_d = _reduction(CD[k2], new_l - Lk, new_u - new_l)
            conv_s = _reduction(CS[k3], new_l - Lk, new_u - new_l)
            if conv_i == conv_d and conv_i == conv_s and prev_conv_s == conv_s \
                    and conv_i != -1:
                converged = True
                conv_value = prev_conv_s
                conv_score = max_score_prime
            prev_conv_s = conv_s

        v1 = qry_len - 1
        v2 = k + 2 - ref_len
        v3 = new_u + 1
        L[k3p1] = max(new_l, max(0, v2))
        U[k3p1] = min(v1, v3)

        max_score = F32(0.0) if max_score_prime < 0 else max_score_prime
        last_k = k
        if converged and max_score > conv_score:
            conv_logic = True
            break

    # --- locate traceback start (TALCO-XDrop.cpp:615-652) ---
    last_tile = False
    if conv_logic:
        conv_query_idx = conv_value & 0xFFFF
        tb_state = (conv_value >> 16) & 0xFFFF
        conv_ref_idx = marker - conv_query_idx
        conv_ref_idx -= 1 if tb_state == 3 else 0
        tb_start_addr = ftr_addr - ftr_length[-1]
        if tb_state == 3:
            tb_start_addr = tb_start_addr - ftr_length[-2] + \
                (conv_query_idx - ftr_lower_limit[-2])
            tb_start_ftr = len(ftr_length) - 2
        else:
            tb_start_addr = tb_start_addr + (conv_query_idx - ftr_lower_limit[-1])
            tb_start_ftr = len(ftr_length) - 1
    else:
        if last_k < marker:
            conv_query_idx = qry_len - 1
            conv_ref_idx = ref_len - 1
            tb_start_addr = ftr_addr - 1
            tb_start_ftr = last_k
            tb_state = 0
            last_tile = True
        else:
            cs0 = int(CS[last_k % 3][0])
            conv_query_idx = cs0 & 0xFFFF
            tb_state = (cs0 >> 16) & 0xFFFF
            conv_ref_idx = marker - conv_query_idx
            conv_ref_idx -= 1 if tb_state == 3 else 0
            tb_start_addr = ftr_addr - ftr_length[-1]
            if tb_state == 3:
                tb_start_addr = tb_start_addr - ftr_length[-2] + \
                    (conv_query_idx - ftr_lower_limit[-2])
                tb_start_ftr = len(ftr_length) - 2
            else:
                tb_start_addr = tb_start_addr + \
                    (conv_query_idx - ftr_lower_limit[-1])
                tb_start_ftr = len(ftr_length) - 1

    if conv_query_idx == D_BOUNDARY_LOW16:
        conv_query_idx = 0
        conv_ref_idx = param.marker
    elif conv_query_idx == I_BOUNDARY_LOW16:
        conv_query_idx = param.marker
        conv_ref_idx = 0

    reference_idx += conv_ref_idx
    query_idx += conv_query_idx
    ref_len = ref_total - reference_idx
    qry_len = qry_total - query_idx
    if ref_len < 0 or qry_len < 0:
        return [], reference_idx, query_idx, True, 3

    aln: List[int] = []
    if reference_idx == ref_total - 1 and query_idx < qry_total - 1:
        aln.extend([1] * (qry_total - query_idx - 1))
        last_tile = True
    if query_idx == qry_total - 1 and reference_idx < ref_total - 1:
        aln.extend([2] * (ref_total - reference_idx - 1))
        last_tile = True
    if reference_idx == ref_total - 1 and query_idx == qry_total - 1:
        last_tile = True

    tb = np.concatenate(tb_rows) if tb_rows else np.zeros(0, dtype=np.int8)
    _traceback(ftr_length, ftr_lower_limit, tb_start_addr, tb_start_ftr,
               tb_state % 3, conv_query_idx, conv_ref_idx, tb, aln,
               tile_no == 0)
    return aln, reference_idx, query_idx, last_tile, 0


def align_freq(param: TalcoRunParams, freq_ref: np.ndarray, freq_qry: np.ndarray,
               gap_op: Tuple[np.ndarray, np.ndarray],
               gap_ex: Tuple[np.ndarray, np.ndarray],
               num: Tuple[float, float]) -> Tuple[np.ndarray, int]:
    """Multi-tile driver (reference Align_freq, TALCO-XDrop.cpp:62-108).

    Returns (aln path int8 array, error_type). error_type: 0 ok, 1 x-drop
    band collapse, 2 band exceeded fLen, 3 index error. On error the path is
    empty and the caller applies the retry ladder.
    """
    reference_idx = 0
    query_idx = 0
    last_tile = False
    tile_no = 0
    out: List[int] = []
    while not last_tile:
        tile_aln, reference_idx, query_idx, last_tile, err = tile(
            freq_ref, freq_qry, gap_op, gap_ex, num, param,
            reference_idx, query_idx, tile_no)
        if not tile_aln:
            return np.zeros(0, dtype=np.int8), err
        # reversed, dropping the first step of each non-first tile
        start = len(tile_aln) - 1
        for i in range(start, -1, -1):
            if i == len(tile_aln) - 1 and tile_no > 0:
                continue
            out.append(tile_aln[i])
        tile_no += 1
    return np.asarray(out, dtype=np.int8), 0
