"""Runtime configuration and scoring parameters.

Mirrors the reference's Option (/root/reference/src/option.cpp:12-251) and
Params (/root/reference/src/scoring-matrix.cpp:81-236) semantics, restructured
as plain dataclasses.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .blosum import BLOSUM
from .constants import check_only, letter_idx, matrix_size

INT32_MAX = 2**31 - 1

# Alignment modes (reference msa.hpp:30-35)
DEFAULT_ALN = 0
MERGE_MSA = 1
PLACE_WO_TREE = 2
PLACE_W_TREE = 3


@dataclass
class Options:
    aln_mode: int = DEFAULT_ALN
    # file names
    tree_file: str = ""
    seq_file: str = ""
    out_file: str = ""
    backbone_aln_file: str = ""
    msa_dir: str = ""
    temp_dir: str = ""
    # alignment options
    max_subtree: int = INT32_MAX
    gappy_vertical: float = 0.95     # --remove-gappy
    len_dev: float = 0.0
    max_ambig: float = 0.1
    max_len: int = INT32_MAX
    min_len: int = 0
    write_filtered: bool = False
    debug: bool = False
    no_filter: bool = True           # default: defer (don't exclude) low-quality
    reroot: bool = True
    compressed: bool = False
    type: str = "n"                  # 'n' nucleotide | 'p' protein
    # runtime
    print_detail: bool = False
    delete_temp: bool = True
    resume: bool = False             # reuse per-subtree checkpoints in temp_dir
    n_hosts: int = 1                 # multi-host subtree dispatch
    host_id: int = 0
    keep_temp: bool = False
    # device execution knobs (no reference analogue)
    device_backend: str = "auto"     # auto | gpu | cpu | native | numpy
    pair_batch: int = 1024           # most pairs per launch (per device)
    cpu_num: int = 0                 # host DP worker threads (0 = all cores)
    # device selection (reference GPU build: --gpu/--gpu-index,
    # cuda/gpu-info.cu:14-61); None = all local devices
    device_num: "int | None" = None
    device_index: "list | None" = None


def detect_mode(has_tree: bool, has_seq: bool, has_files: bool, has_aln: bool) -> int:
    """Input-flag bitmask → mode (reference option.cpp:15-32)."""
    mask = (has_files << 3) | (has_tree << 2) | (has_seq << 1) | (has_aln << 0)
    modes = {0b0110: DEFAULT_ALN, 0b1000: MERGE_MSA,
             0b0011: PLACE_WO_TREE, 0b0111: PLACE_W_TREE}
    if mask not in modes:
        raise ValueError(
            "Unrecognized alignment mode: valid combinations are "
            "--tree+--sequences, --files, --sequences+--alignment, or "
            "--sequences+--alignment+--tree")
    return modes[mask]


def detect_type(seq_file: str) -> str:
    """Scan first 100 sequence lines for type-discriminating letters
    (reference option.cpp:100-171)."""
    opener = gzip.open if seq_file.endswith(".gz") else open
    type_ = "n"
    line_count = 0
    with opener(seq_file, "rt") as f:
        for line in f:
            if not line or line[0] == ">":
                continue
            for c in line:
                t = check_only(c.upper())
                if t != "x":
                    return t
            line_count += 1
            if line_count == 100:
                break
    return type_


@dataclass
class Params:
    gap_open: float = -50.0
    gap_extend: float = -5.0
    gap_boundary: float = -5.0
    xdrop: float = 3000.0            # derived: -round(xdrop_scale)*gap_extend
    scoring_matrix: np.ndarray = field(default_factory=lambda: np.zeros((5, 5), np.float32))
    matrix_size: int = 5

    @staticmethod
    def make(type_: str,
             match: float = 18.0,
             mismatch: float = -8.0,
             transition: float = -4.0,
             gap_open: float = -50.0,
             gap_extend: float = -5.0,
             gap_ends: Optional[float] = None,
             xdrop_scale: float = 600.0,
             blosum: int = 62,
             wildcard: bool = False,
             matrix_file: Optional[str] = None) -> "Params":
        """Build scoring parameters (reference scoring-matrix.cpp:81-194)."""
        if gap_open > 0 or gap_extend > 0 or (gap_ends is not None and gap_ends > 0):
            raise ValueError("Gap penalties must be <= 0")
        xdrop_r = float(np.round(xdrop_scale))
        if xdrop_r <= 0:
            raise ValueError("XDrop value should be larger than 0")
        xdrop = xdrop_r if gap_extend == 0 else -1.0 * xdrop_r * gap_extend

        msize = matrix_size(type_)
        mat = np.zeros((msize, msize), dtype=np.float32)
        if matrix_file is None:
            if type_ == "n":
                for i in range(5):
                    for j in range(5):
                        if i == 4 or j == 4:
                            mat[i, j] = match if wildcard else 0.0
                        elif i == j:
                            mat[i, j] = match
                        elif abs(i - j) == 2:
                            mat[i, j] = transition
                        else:
                            mat[i, j] = mismatch
            else:
                if blosum not in (45, 62, 80):
                    blosum = 62
                # wildcard row/col uses mean BLOSUM62 diagonal regardless of
                # selected matrix (reference scoring-matrix.cpp:120-126)
                nscore = np.float32(0.0)
                for i in range(20):
                    nscore = np.float32(nscore + BLOSUM[62][i, i])
                nscore = np.float32(nscore / np.float32(20.0))
                wild = np.float32(5.0) * nscore if wildcard else np.float32(0.0)
                mat[20, :] = wild
                mat[:, 20] = wild
                mat[:20, :20] = np.float32(5.0) * BLOSUM[blosum]
        else:
            _parse_matrix_file(matrix_file, type_, msize, mat, wildcard)

        return Params(gap_open=float(gap_open), gap_extend=float(gap_extend),
                      gap_boundary=float(gap_ends if gap_ends is not None else gap_extend),
                      xdrop=float(xdrop), scoring_matrix=mat, matrix_size=msize)


def _parse_matrix_file(path: str, type_: str, msize: int, mat: np.ndarray,
                       wildcard: bool) -> None:
    """User substitution matrix parser (reference scoring-matrix.cpp:139-194).

    Format: a header row of letters (msize-1 letters, or msize including the
    ambiguity letter), then a full score table in row-major order.
    """
    words = open(path).read().split()
    char_vec = []
    char_num = msize - 1
    read_count = 0
    for word in words:
        if read_count == char_num:
            try:
                float(word)
                is_number = True
            except ValueError:
                is_number = False
            if not is_number:
                char_num = msize
        if read_count < char_num:
            letter = word[0].upper()
            ambig = 4 if type_ == "n" else 20
            if letter_idx(type_, letter) == ambig and char_num == msize - 1:
                raise ValueError(f"Unrecognized letter '{letter}'")
            char_vec.append(letter_idx(type_, letter))
            read_count += 1
        else:
            x = (read_count - char_num) // char_num
            y = (read_count - char_num) % char_num
            mat[char_vec[x], char_vec[y]] = np.float32(float(word))
            read_count += 1
    if char_num == msize - 1:
        nscore = np.float32(0.0)
        for i in range(char_num):
            nscore = np.float32(nscore + mat[i, i])
        nscore = np.float32(nscore / np.float32(char_num)) if wildcard else np.float32(0.0)
        mat[:, msize - 1] = nscore
        mat[msize - 1, :] = nscore


def fmt_float(v: float) -> str:
    """C++ `std::ostream << float` default formatting (6 significant
    digits, %g style) — used by the stderr parity blocks."""
    return f"{float(v):.6g}"


# stderr dump order of scoring-matrix letters: the reference walks an
# ordered std::map<char,int> starting one past begin() ('-' sorts first),
# so row/col labels are the alphabet letters in ASCII order followed by
# the ambiguity letter (scoring-matrix.cpp:195-226).
_DUMP_LETTERS = {
    "n": ["A", "C", "G", "T"],
    "p": ["A", "C", "D", "E", "F", "G", "H", "I", "K", "L", "M", "N",
          "P", "Q", "R", "S", "T", "V", "W", "Y"],
}


def dump_params(param: "Params", type_: str, blosum: int,
                user_matrix: bool, file=None) -> None:
    """--verbose scoring-matrix dump
    (reference scoring-matrix.cpp:204-235)."""
    import sys
    out = file or sys.stderr
    print("======== Parameters ========", file=out)
    if type_ == "p" and not user_matrix and blosum in (45, 62, 80):
        print(f"BLOSUM{blosum}", file=out)
    # letter codes equal their alphabetical position, so matrix row i is
    # labelled letters[i] and cells print by index like the reference
    letters = _DUMP_LETTERS[type_] + ["N" if type_ == "n" else "X"]
    print("".join(f"{c:>5}" for c in [" "] + letters), file=out)
    m = param.scoring_matrix
    for i, row_letter in enumerate(letters):
        cells = "".join(f"{fmt_float(m[i, j]):>5}"
                        for j in range(param.matrix_size))
        print(f"{row_letter:>5}{cells}", file=out)
    print(f"Gap-Open:   {fmt_float(param.gap_open)}", file=out)
    print(f"Gap-Extend: {fmt_float(param.gap_extend)}", file=out)
    print(f"Gap-Ends:   {fmt_float(param.gap_boundary)}", file=out)
    print(f"Xdrop:      {fmt_float(param.xdrop)}", file=out)


@dataclass
class TalcoParams:
    """Kernel-side parameters (reference TALCO-XDrop.cpp:36-53).

    Note the reference kernel derives its own xdrop from gap_extend and
    ignores Params.xdrop; fLen/marker are fixed powers of two.
    """
    scoring_matrix: np.ndarray
    matrix_size: int
    gap_open: float
    gap_extend: float
    gap_char_score: float
    gap_boundary: float
    xdrop: int
    flen: int = 1 << 12
    marker: int = 1 << 10

    @staticmethod
    def from_params(p: Params) -> "TalcoParams":
        return TalcoParams(
            scoring_matrix=p.scoring_matrix.astype(np.float32),
            matrix_size=p.matrix_size,
            gap_open=p.gap_open,
            gap_extend=p.gap_extend,
            gap_char_score=p.gap_extend,
            gap_boundary=p.gap_boundary,
            xdrop=int(1000 * -1 * p.gap_extend),
        )
