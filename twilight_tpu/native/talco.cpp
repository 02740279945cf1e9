// TALCO-XDrop profile-profile alignment — native host kernel.
//
// Exact reimplementation of the reference kernel semantics
// (/root/reference/src/TALCO-XDrop.cpp: Align_freq :62-108, Tile :233-688,
// Traceback :134-231, Reduction_tree :110-119), matching the float32
// operation ordering of the reference's TALCO_SIMD build — the same
// semantics as the NumPy oracle in ../ops/talco_np.py, which this module is
// validated against bit-for-bit. Used for narrow levels where a device
// launch round-trip costs more than the DP itself.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 (no -ffast-math: float add order
// is semantically significant).
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>

#if defined(__AVX2__)
#include <immintrin.h>
#endif
#if defined(__x86_64__)
#include <x86intrin.h>
#endif

namespace {

// Perf triage (TWILIGHT_KERNEL_STATS=1): per-call diagonals / live-band
// cells / rdtsc cycles by phase, printed to stderr. Zero cost when off
// (one static env check; counters untouched).
struct KStats {
    bool on;
    uint64_t diags = 0, cells = 0, tiles = 0;
    uint64_t cyc_cells = 0;   // do_cell loops (vector + scalar)
    uint64_t cyc_tail = 0;    // max scan, row copies, conv reductions,
                              // band shrink
    uint64_t cyc_setup = 0;   // per-tile buffer alloc/fill
    uint64_t cyc_tb = 0;      // traceback walk
    uint64_t cyc_call = 0;    // whole talco_align_freq call
    KStats() : on(std::getenv("TWILIGHT_KERNEL_STATS") != nullptr) {}
    void reset() { diags = cells = tiles = 0;
                   cyc_cells = cyc_tail = cyc_setup = cyc_tb = 0;
                   cyc_call = 0; }
};
thread_local KStats kstats;
#if defined(__x86_64__)
#define KSTATS_NOW() (kstats.on ? __rdtsc() : 0)
#else
#define KSTATS_NOW() 0ULL
#endif

constexpr int32_t I_BOUNDARY = -2;
constexpr int32_t D_BOUNDARY = -3;
constexpr int32_t I_BOUNDARY_LOW16 = I_BOUNDARY & 0xFFFF;  // 65534
constexpr int32_t D_BOUNDARY_LOW16 = D_BOUNDARY & 0xFFFF;  // 65533

struct Params {
    const float* matrix;   // [msize, msize]
    int32_t msize;
    int32_t p;             // profile rows: 6 or 22
    float gap_open, gap_extend, gap_char;
    int32_t xdrop, flen, marker;
};

// Expected profile-pair substitution score, reproducing the SIMD summation
// order (TALCO-XDrop.cpp:377-433 / talco_np.similarity_scores).
inline float similarity(const float* ref, const float* qry, const Params& pr,
                        float denominator) {
    float num = 0.0f;
    const float* M = pr.matrix;
    const int ms = pr.msize;
    if (pr.p == 6) {
        for (int l = 0; l < 5; ++l) {
            float t0 = (qry[0] * M[l * ms + 0]) * ref[l];
            float t1 = (qry[1] * M[l * ms + 1]) * ref[l];
            float t2 = (qry[2] * M[l * ms + 2]) * ref[l];
            float t3 = (qry[3] * M[l * ms + 3]) * ref[l];
            float t4 = (qry[4] * M[l * ms + 4]) * ref[l];
            float s = t0;
            s = s + t1; s = s + t2; s = s + t3; s = s + t4;
            num = num + s;
        }
        for (int l = 0; l < 5; ++l)
            num = num + (ref[l] * qry[5]) * pr.gap_char;
        for (int m = 0; m < 5; ++m)
            num = num + (ref[5] * qry[m]) * pr.gap_char;
    } else {
#if defined(__AVX2__)
        // vector form of the same summation order (the per-lane adds and
        // the left-associative horizontal sum are identical to the scalar
        // loop below, so results are bit-equal)
        for (int l = 0; l < 21; ++l) {
            __m256 refv = _mm256_set1_ps(ref[l]);
            __m256 q0 = _mm256_loadu_ps(qry);
            __m256 m0 = _mm256_loadu_ps(M + l * ms);
            __m256 sv = _mm256_mul_ps(_mm256_mul_ps(q0, m0), refv);
            __m256 q1 = _mm256_loadu_ps(qry + 8);
            __m256 m1 = _mm256_loadu_ps(M + l * ms + 8);
            sv = _mm256_add_ps(sv, _mm256_mul_ps(_mm256_mul_ps(q1, m1),
                                                 refv));
            for (int m = 16; m < 21; ++m)
                num = num + (ref[l] * qry[m]) * M[l * ms + m];
            alignas(32) float tmp[8];
            _mm256_store_ps(tmp, sv);
            float s = tmp[0];
            for (int j = 1; j < 8; ++j) s = s + tmp[j];
            num = num + s;
        }
#else
        for (int l = 0; l < 21; ++l) {
            float sumvec[8];
            for (int j = 0; j < 8; ++j)
                sumvec[j] = (qry[j] * M[l * ms + j]) * ref[l];
            for (int j = 0; j < 8; ++j)
                sumvec[j] = sumvec[j] + (qry[8 + j] * M[l * ms + 8 + j]) * ref[l];
            for (int m = 16; m < 21; ++m)
                num = num + (ref[l] * qry[m]) * M[l * ms + m];
            float s = sumvec[0];
            for (int j = 1; j < 8; ++j) s = s + sumvec[j];
            num = num + s;
        }
#endif
        for (int l = 0; l < 21; ++l)
            num = num + (ref[l] * qry[21]) * pr.gap_char;
        for (int m = 0; m < 21; ++m)
            num = num + (ref[21] * qry[m]) * pr.gap_char;
    }
    return num / denominator;
}

// Reference Reduction_tree: inclusive scan [start, start+length] over c
// (full flen row, stale values included); -1 when not all equal.
inline int32_t reduction(const int32_t* c, int flen, int start, int length) {
    start = std::min(start, flen - 1);
    if (length < 0) return c[start];
    int end = std::min(start + length, flen - 1);
    int32_t conv = c[start];
    for (int i = start + 1; i <= end; ++i)
        if (c[i] != conv) return -1;
    return conv;
}

// Reference Traceback (TALCO-XDrop.cpp:134-231). Appends to aln.
inline bool traceback(const std::vector<int>& ftr_length,
                      const std::vector<int>& ftr_lower_limit,
                      long addr, int ftr, int state, int idx,
                      int ref_start_idx, const std::vector<int8_t>& tb,
                      std::vector<int8_t>& aln, bool first_tile) {
    int query_idx = idx;
    int ref_idx = ref_start_idx;
    while (ftr >= 0) {
        if (addr < 0) return false;  // errorType 3 analogue
        int tb_value = tb[(size_t)addr];
        int dir_;
        if (state == 0) {
            state = tb_value & 0x03;
            if (state == 0) dir_ = 0;
            else if (state == 1) { dir_ = 1; state = (tb_value & 0x04) ? 1 : 0; }
            else { dir_ = 2; state = (tb_value & 0x08) ? 2 : 0; }
        } else if (state == 1) {
            dir_ = 1; state = (tb_value & 0x04) ? 1 : 0;
        } else {
            dir_ = 2; state = (tb_value & 0x08) ? 2 : 0;
        }
        if (ftr > 0)
            addr = addr - (idx - ftr_lower_limit[ftr] + 1) - ftr_length[ftr - 1];
        if (dir_ == 0) {
            if (ftr > 1)
                addr = addr - ftr_length[ftr - 2] + (idx - ftr_lower_limit[ftr - 2]);
            ftr -= 2; idx -= 1; query_idx -= 1; ref_idx -= 1;
        } else if (dir_ == 1) {
            if (ftr > 0) addr = addr + (idx - ftr_lower_limit[ftr - 1]);
            ftr -= 1; idx -= 1; query_idx -= 1;
        } else {
            if (ftr > 0) addr = addr + (idx - ftr_lower_limit[ftr - 1] + 1);
            ftr -= 1; ref_idx -= 1;
        }
        aln.push_back((int8_t)dir_);
        if (first_tile && (ref_idx < 0 || query_idx < 0)) break;
    }
    if (first_tile) {
        while (ref_idx > -1) { aln.push_back(2); ref_idx -= 1; }
        while (query_idx > -1) { aln.push_back(1); query_idx -= 1; }
    }
    return true;
}

// One TALCO tile. Returns error code (0 ok). Appends the tile's path
// (traceback order, end->start) to tile_aln.
// refT/qryT: optional planar-transposed profiles ([P][total] row-major,
// built once per alignment) enabling the AVX2 across-cells path.
int tile(const float* freq_ref, long ref_total,
         const float* freq_qry, long qry_total, int P,
         const float* go_ref, const float* go_qry,
         const float* ge_ref, const float* ge_qry,
         float ref_num, float qry_num, const Params& pr,
         long& reference_idx, long& query_idx, int tile_no,
         bool& last_tile, std::vector<int8_t>& tile_aln,
         const float* refT = nullptr, const float* qryT = nullptr,
         const int32_t* refC = nullptr, const int32_t* qryC = nullptr,
         const float* simtab = nullptr) {
    const float xdrop_f = (float)pr.xdrop;
    const float inf = 2.0f * xdrop_f + 1.0f;
    const float neg_inf = -inf;
    const int marker = pr.marker;

    long ref_len = ref_total - reference_idx;
    long qry_len = qry_total - query_idx;
    if (ref_len < 0 || qry_len < 0) { last_tile = true; return 3; }
    const int flen = (int)std::min<long>(pr.flen, std::min(ref_len, qry_len));

    const float denominator = ref_num * qry_num;
    const float gap_open = pr.gap_open, gap_extend = pr.gap_extend;
    const float gap_open_ends = gap_open, gap_extend_ends = gap_extend;

    const uint64_t kst_setup0 = KSTATS_NOW();
    // +-16 guard lanes around the row block: the vector paths issue full
    // 8/16-lane loads whose masked-out edge lanes may read past/before a
    // row; values are discarded by the per-lane masks but the addresses
    // must stay inside the allocation
    std::vector<float> Sb(3 * flen + 32, -1.0f), Ib(2 * flen + 32, -1.0f),
        Db(2 * flen + 32, -1.0f);
    std::vector<int32_t> CSb(3 * flen + 32, -1),
        CIb(2 * flen + 32, I_BOUNDARY), CDb(2 * flen + 32, D_BOUNDARY);
    float* S[3] = {Sb.data() + 16, Sb.data() + 16 + flen,
                   Sb.data() + 16 + 2 * flen};
    float* Irows[2] = {Ib.data() + 16, Ib.data() + 16 + flen};
    float* Drows[2] = {Db.data() + 16, Db.data() + 16 + flen};
    int32_t* CS[3] = {CSb.data() + 16, CSb.data() + 16 + flen,
                      CSb.data() + 16 + 2 * flen};
    int32_t* CI[2] = {CIb.data() + 16, CIb.data() + 16 + flen};
    int32_t* CD[2] = {CDb.data() + 16, CDb.data() + 16 + flen};
    long L[3] = {0, 1, 2};
    long U[3] = {0, -1, -2};

    std::vector<int8_t> tb;
    // tb grows by one band width per diagonal up to the marker; reserve
    // for a ~256-wide band so typical tiles never realloc-copy mid-loop
    tb.reserve(std::min((size_t)(marker + 1) * 256,
                        (size_t)(marker + 1) * (size_t)flen));
    std::vector<int> ftr_length, ftr_lower_limit;
    ftr_length.reserve(marker + 2);
    ftr_lower_limit.reserve(marker + 2);
    long ftr_addr = 0;
    long last_k = 0;
    int32_t prev_conv_s = -1;
    bool converged = false, conv_logic = false;
    int32_t conv_value = 0;
    float conv_score = 0.0f;
    float max_score = 0.0f;
    float max_score_prime = neg_inf;

    std::vector<float> i_row(flen), d_row(flen), s_row(flen);
    std::vector<int8_t> ptr_row(flen);
    std::vector<int32_t> ci_row(flen), cd_row(flen), cs_row(flen);
    if (kstats.on) {
        kstats.tiles += 1;
        kstats.cyc_setup += KSTATS_NOW() - kst_setup0;
    }

    const long cell_count = ref_len + qry_len - 1;
    for (long k = 0; k < cell_count; ++k) {
        const int k3 = (int)(k % 3), k3p1 = (int)((k + 1) % 3),
            k3p2 = (int)((k + 2) % 3);
        const int k2 = (int)(k % 2), k2p1 = (int)((k + 1) % 2);
        const long Lk = L[k3], Uk = U[k3];
        if (Lk >= Uk + 1) { last_tile = true; return 1; }
        const long count = Uk - Lk + 1;
        if (count > flen) { last_tile = true; return 2; }

        if (k <= marker) {
            ftr_length.push_back((int)count);
            ftr_lower_limit.push_back((int)Lk);
            ftr_addr += count;
        }

        if (kstats.on) { kstats.diags += 1; kstats.cells += (uint64_t)count; }
        const uint64_t kst_cell0 = KSTATS_NOW();

        const long lprime = std::max(0L, k - ref_len + 1);
        const long jmax = std::min(k, ref_len - 1);
        const long UL1 = U[k3p1] - L[k3p1];
        const long UL2 = U[k3p2] - L[k3p2];

        auto do_cell = [&](long off) {
            const long i = Lk + off;
            const long j = jmax - (i - lprime);
            const long off_diag = Lk - L[k3p1] + off - 1;
            const long off_up = Lk - L[k3p2] + off;
            const long off_left = Lk - L[k3p2] + off - 1;

            const bool diag_valid = off_diag >= 0 && off_diag <= UL1;
            const bool border = (tile_no == 0) && (i == 0 || j == 0);
            const bool compute_sim = (k == 0) || diag_valid || border;

            float match = neg_inf;
            if (compute_sim) {
                float sim;
                const int rc = simtab ? refC[reference_idx + j] : -1;
                const int qc = simtab ? qryC[query_idx + i] : -1;
                if (rc >= 0 && qc >= 0) {
                    // both columns pure: one nonzero term plus exact
                    // zeros, precomputed through similarity() (bit-exact)
                    sim = simtab[rc * P + qc];
                } else {
                    const float* rrow = freq_ref + (reference_idx + j) * P;
                    const float* qrow = freq_qry + (query_idx + i) * P;
                    sim = similarity(rrow, qrow, pr, denominator);
                }
                if (border) {
                    if (i == 0 && j == 0) {
                        match = sim;
                    } else {
                        const float steps = (float)std::max(
                            0L, std::max(reference_idx + j, query_idx + i) - 1);
                        match = sim + gap_open_ends + gap_extend_ends * steps;
                    }
                } else if (off_diag < 0) {
                    match = sim;
                } else {
                    match = S[k3p1][off_diag] + sim;
                }
            }

            const float pgo_r = go_ref[reference_idx + j];
            const float pgo_q = go_qry[query_idx + i];
            const float pge_r = ge_ref[reference_idx + j];
            const float pge_q = ge_qry[query_idx + i];

            const bool up_valid = off_up >= 0 && off_up <= UL2;
            const bool left_valid = off_left >= 0 && off_left <= UL2;
            const float del_op = up_valid ? S[k3p2][off_up] + pgo_r : neg_inf;
            const float del_ext = up_valid ? Drows[k2p1][off_up] + pge_r
                                           : neg_inf;
            const float ins_op = left_valid ? S[k3p2][off_left] + pgo_q
                                            : neg_inf;
            const float ins_ext = left_valid ? Irows[k2p1][off_left] + pge_q
                                             : neg_inf;

            const bool iptr = ins_ext >= ins_op;
            const bool dptr = del_ext >= del_op;
            const float i_val = iptr ? ins_ext : ins_op;
            const float d_val = dptr ? del_ext : del_op;

            float s_val; int8_t ptr;
            if (match >= i_val) {
                if (match >= d_val) { s_val = match; ptr = 0; }
                else { s_val = d_val; ptr = 2; }
            } else {
                if (i_val > d_val) { s_val = i_val; ptr = 1; }
                else { s_val = d_val; ptr = 2; }
            }
            if (s_val < max_score - xdrop_f) s_val = neg_inf;

            i_row[off] = i_val; d_row[off] = d_val; s_row[off] = s_val;
            ptr_row[off] = (int8_t)(ptr | (iptr ? 4 : 0) | (dptr ? 8 : 0));

            if (k >= marker + 1) {
                // reads are index-clipped like the oracle's np.clip takes
                // (stale-buffer semantics when the offset exceeds the band)
                const long left_take =
                    std::min(std::max(off_left, 0L), (long)flen - 1);
                const long up_take =
                    std::min(std::max(off_up, 0L), (long)flen - 1);
                const int32_t ci_prop = off_left >= 0 ? CI[k2p1][left_take]
                                                      : I_BOUNDARY;
                const int32_t cs_left = CS[k3p2][left_take];
                const int32_t ci_open =
                    (off_left >= 0 && cs_left != -1) ? cs_left : I_BOUNDARY;
                const int32_t new_ci = iptr ? ci_prop : ci_open;

                const int32_t cd_prop = off_up >= 0 ? CD[k2p1][up_take]
                                                    : D_BOUNDARY;
                const int32_t cs_up = CS[k3p2][up_take];
                const int32_t cd_open =
                    (off_up >= 0 && cs_up != -1) ? cs_up : D_BOUNDARY;
                const int32_t new_cd = dptr ? cd_prop : cd_open;

                const long diag_take =
                    std::min(std::max(off_diag, 0L), (long)flen - 1);
                const int32_t cs_diag = CS[k3p1][diag_take];  // clipped like
                                                              // the oracle
                const int32_t new_cs = ptr == 0 ? cs_diag
                                     : (ptr == 1 ? new_ci : new_cd);
                ci_row[off] = new_ci; cd_row[off] = new_cd; cs_row[off] = new_cs;
            }
        };

#if defined(__AVX512F__) && defined(__AVX512BW__) && \
    defined(TWILIGHT_AVX512)
        // Across-cells vector path (nucleotide), 16 cells per iteration.
        // Bit-identical to the scalar sequence, but NOT the default: on
        // this machine AVX-512 license downclocking + gather latency eat
        // the lane doubling (measured 11.7 vs 11.3 ms per 1.7 kb pair).
        // Define TWILIGHT_AVX512 to enable where it wins.
        const bool vec_ok = (P == 6) && refT && qryT && k > 0 && count >= 16;
        if (vec_ok) {
            const __m512i REV = _mm512_setr_epi32(15, 14, 13, 12, 11, 10,
                                                  9, 8, 7, 6, 5, 4, 3, 2,
                                                  1, 0);
            const __m512i IOTA = _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7,
                                                   8, 9, 10, 11, 12, 13,
                                                   14, 15);
            const __m512 vneg = _mm512_set1_ps(neg_inf);
            const __m512 vden = _mm512_set1_ps(denominator);
            const __m512 vgc = _mm512_set1_ps(pr.gap_char);
            const __m512 vcut = _mm512_set1_ps(max_score - xdrop_f);
            const float* M = pr.matrix;
            const int ms = pr.msize;
            const long vcount = count & ~15L;
            auto clamp_base = [&](long b) {
                return std::min(std::max(b, -16L), (long)flen);
            };
            for (long off0 = 0; off0 < vcount; off0 += 16) {
                const long i0 = Lk + off0;
                const long j0 = jmax - (i0 - lprime);
                const long od0 = Lk - L[k3p1] + off0 - 1;
                const long ou0 = Lk - L[k3p2] + off0;
                const long ol0 = Lk - L[k3p2] + off0 - 1;
                const long odL = clamp_base(od0);
                const long ouL = clamp_base(ou0);
                const long olL = clamp_base(ol0);
                const long qb = query_idx + i0;        // qry pos, +lane
                const long rb = reference_idx + j0;    // ref pos, -lane

                auto rload = [&](const float* base) {
                    return _mm512_permutexvar_ps(
                        REV, _mm512_loadu_ps(base + rb - 15));
                };
                __m512 q[6], r[6];
                for (int l = 0; l < 6; ++l) {
                    q[l] = _mm512_loadu_ps(qryT + (size_t)l * qry_total
                                           + qb);
                    r[l] = rload(refT + (size_t)l * ref_total);
                }
                __m512 num = _mm512_setzero_ps();
                for (int l = 0; l < 5; ++l) {
                    __m512 s = _mm512_mul_ps(_mm512_mul_ps(
                        q[0], _mm512_set1_ps(M[l * ms])), r[l]);
                    for (int m = 1; m < 5; ++m)
                        s = _mm512_add_ps(s, _mm512_mul_ps(_mm512_mul_ps(
                            q[m], _mm512_set1_ps(M[l * ms + m])), r[l]));
                    num = _mm512_add_ps(num, s);
                }
                for (int l = 0; l < 5; ++l)
                    num = _mm512_add_ps(num, _mm512_mul_ps(
                        _mm512_mul_ps(r[l], q[5]), vgc));
                for (int m = 0; m < 5; ++m)
                    num = _mm512_add_ps(num, _mm512_mul_ps(
                        _mm512_mul_ps(r[5], q[m]), vgc));
                const __m512 sim = _mm512_div_ps(num, vden);

                const __m512i odv = _mm512_add_epi32(
                    _mm512_set1_epi32((int)od0), IOTA);
                const __mmask16 m_dv =
                    _mm512_cmpgt_epi32_mask(odv, _mm512_set1_epi32(-1)) &
                    _mm512_cmpgt_epi32_mask(_mm512_set1_epi32((int)UL1 + 1),
                                            odv);
                __m512 match = _mm512_mask_blend_ps(
                    m_dv, vneg, _mm512_add_ps(
                        _mm512_loadu_ps(S[k3p1] + odL), sim));

                auto rload_pen = [&](const float* base) {
                    return _mm512_permutexvar_ps(
                        REV, _mm512_loadu_ps(base + rb - 15));
                };
                const __m512 pgo_r = rload_pen(go_ref);
                const __m512 pge_r = rload_pen(ge_ref);
                const __m512 pgo_q = _mm512_loadu_ps(go_qry + qb);
                const __m512 pge_q = _mm512_loadu_ps(ge_qry + qb);
                const __m512i ouv = _mm512_add_epi32(
                    _mm512_set1_epi32((int)ou0), IOTA);
                const __m512i olv = _mm512_add_epi32(
                    _mm512_set1_epi32((int)ol0), IOTA);
                const __mmask16 m_up =
                    _mm512_cmpgt_epi32_mask(ouv, _mm512_set1_epi32(-1)) &
                    _mm512_cmpgt_epi32_mask(_mm512_set1_epi32((int)UL2 + 1),
                                            ouv);
                const __mmask16 m_lf =
                    _mm512_cmpgt_epi32_mask(olv, _mm512_set1_epi32(-1)) &
                    _mm512_cmpgt_epi32_mask(_mm512_set1_epi32((int)UL2 + 1),
                                            olv);
                const __m512 del_op = _mm512_mask_blend_ps(
                    m_up, vneg, _mm512_add_ps(
                        _mm512_loadu_ps(S[k3p2] + ouL), pgo_r));
                const __m512 del_ext = _mm512_mask_blend_ps(
                    m_up, vneg, _mm512_add_ps(
                        _mm512_loadu_ps(Drows[k2p1] + ouL), pge_r));
                const __m512 ins_op = _mm512_mask_blend_ps(
                    m_lf, vneg, _mm512_add_ps(
                        _mm512_loadu_ps(S[k3p2] + olL), pgo_q));
                const __m512 ins_ext = _mm512_mask_blend_ps(
                    m_lf, vneg, _mm512_add_ps(
                        _mm512_loadu_ps(Irows[k2p1] + olL), pge_q));

                const __mmask16 m_ie = _mm512_cmp_ps_mask(ins_ext, ins_op,
                                                          _CMP_GE_OQ);
                const __mmask16 m_de = _mm512_cmp_ps_mask(del_ext, del_op,
                                                          _CMP_GE_OQ);
                const __m512 i_val = _mm512_mask_blend_ps(m_ie, ins_op,
                                                          ins_ext);
                const __m512 d_val = _mm512_mask_blend_ps(m_de, del_op,
                                                          del_ext);

                const __mmask16 m_mi = _mm512_cmp_ps_mask(match, i_val,
                                                          _CMP_GE_OQ);
                const __mmask16 m_md = _mm512_cmp_ps_mask(match, d_val,
                                                          _CMP_GE_OQ);
                const __mmask16 m_id = _mm512_cmp_ps_mask(i_val, d_val,
                                                          _CMP_GT_OQ);
                const __m512 s_hi = _mm512_mask_blend_ps(m_md, d_val,
                                                         match);
                const __m512 s_lo = _mm512_mask_blend_ps(m_id, d_val,
                                                         i_val);
                __m512 s_val = _mm512_mask_blend_ps(m_mi, s_lo, s_hi);
                const __m512i one = _mm512_set1_epi32(1);
                const __m512i two = _mm512_set1_epi32(2);
                const __m512i p_hi = _mm512_mask_blend_epi32(
                    m_md, two, _mm512_setzero_si512());
                const __m512i p_lo = _mm512_mask_blend_epi32(m_id, two,
                                                             one);
                __m512i ptrv = _mm512_mask_blend_epi32(m_mi, p_lo, p_hi);
                ptrv = _mm512_mask_or_epi32(ptrv, m_ie, ptrv,
                                            _mm512_set1_epi32(4));
                ptrv = _mm512_mask_or_epi32(ptrv, m_de, ptrv,
                                            _mm512_set1_epi32(8));

                const __mmask16 m_kill = _mm512_cmp_ps_mask(s_val, vcut,
                                                            _CMP_LT_OQ);
                s_val = _mm512_mask_blend_ps(m_kill, s_val, vneg);

                _mm512_storeu_ps(i_row.data() + off0, i_val);
                _mm512_storeu_ps(d_row.data() + off0, d_val);
                _mm512_storeu_ps(s_row.data() + off0, s_val);
                // 16 int32 ptrs -> 16 int8
                _mm_storeu_si128((__m128i*)(ptr_row.data() + off0),
                                 _mm512_cvtepi32_epi8(ptrv));

                if (k >= marker + 1) {
                    const __m512i fmax = _mm512_set1_epi32(flen - 1);
                    const __m512i zero = _mm512_setzero_si512();
                    const __m512i lt = _mm512_min_epi32(
                        _mm512_max_epi32(olv, zero), fmax);
                    const __m512i ut = _mm512_min_epi32(
                        _mm512_max_epi32(ouv, zero), fmax);
                    const __m512i dt = _mm512_min_epi32(
                        _mm512_max_epi32(odv, zero), fmax);
                    const __mmask16 lf_ok = _mm512_cmpgt_epi32_mask(
                        olv, _mm512_set1_epi32(-1));
                    const __mmask16 up_ok = _mm512_cmpgt_epi32_mask(
                        ouv, _mm512_set1_epi32(-1));
                    const __m512i IB = _mm512_set1_epi32(I_BOUNDARY);
                    const __m512i DB = _mm512_set1_epi32(D_BOUNDARY);
                    const __m512i mo = _mm512_set1_epi32(-1);

                    const __m512i ci_raw = _mm512_i32gather_epi32(
                        lt, (const int*)CI[k2p1], 4);
                    const __m512i cs_left = _mm512_i32gather_epi32(
                        lt, (const int*)CS[k3p2], 4);
                    const __m512i ci_prop = _mm512_mask_blend_epi32(
                        lf_ok, IB, ci_raw);
                    const __mmask16 lf_open = lf_ok &
                        ~_mm512_cmpeq_epi32_mask(cs_left, mo);
                    const __m512i ci_open = _mm512_mask_blend_epi32(
                        lf_open, IB, cs_left);
                    const __m512i new_ci = _mm512_mask_blend_epi32(
                        m_ie, ci_open, ci_prop);

                    const __m512i cd_raw = _mm512_i32gather_epi32(
                        ut, (const int*)CD[k2p1], 4);
                    const __m512i cs_up = _mm512_i32gather_epi32(
                        ut, (const int*)CS[k3p2], 4);
                    const __m512i cd_prop = _mm512_mask_blend_epi32(
                        up_ok, DB, cd_raw);
                    const __mmask16 up_open = up_ok &
                        ~_mm512_cmpeq_epi32_mask(cs_up, mo);
                    const __m512i cd_open = _mm512_mask_blend_epi32(
                        up_open, DB, cs_up);
                    const __m512i new_cd = _mm512_mask_blend_epi32(
                        m_de, cd_open, cd_prop);

                    const __m512i cs_diag = _mm512_i32gather_epi32(
                        dt, (const int*)CS[k3p1], 4);
                    const __m512i p2 = _mm512_and_si512(
                        ptrv, _mm512_set1_epi32(3));
                    const __mmask16 is0 = _mm512_cmpeq_epi32_mask(p2,
                                                                  zero);
                    const __mmask16 is1 = _mm512_cmpeq_epi32_mask(p2, one);
                    __m512i new_cs = _mm512_mask_blend_epi32(is1, new_cd,
                                                             new_ci);
                    new_cs = _mm512_mask_blend_epi32(is0, new_cs, cs_diag);

                    _mm512_storeu_si512((void*)(ci_row.data() + off0),
                                        new_ci);
                    _mm512_storeu_si512((void*)(cd_row.data() + off0),
                                        new_cd);
                    _mm512_storeu_si512((void*)(cs_row.data() + off0),
                                        new_cs);
                }
            }
            for (long off = vcount; off < count; ++off) do_cell(off);
            if (tile_no == 0) {
                if (Lk == 0) do_cell(0);
                const long off_j0 = jmax + lprime - Lk;  // lane with j == 0
                if (off_j0 >= 0 && off_j0 < count) do_cell(off_j0);
            }
        } else {
            for (long off = 0; off < count; ++off) do_cell(off);
        }
#elif defined(__AVX2__)
        // Across-cells vector path (nucleotide AND protein): lanes = 8
        // consecutive cells of the anti-diagonal. Every lane executes the
        // exact scalar op sequence (same mul/add order, same IEEE
        // division, same compare-based tie-breaks), so results are
        // bit-identical; border cells (tile 0 edges, at most two per
        // diagonal) are recomputed scalar afterwards.
        const bool vec_ok = (P == 6 || P == 22) && refT && qryT && k > 0
            && count >= 8;
        if (vec_ok) {
            const __m256i REV = _mm256_setr_epi32(7, 6, 5, 4, 3, 2, 1, 0);
            const __m256i IOTA = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
            const __m256 vneg = _mm256_set1_ps(neg_inf);
            const __m256 vden = _mm256_set1_ps(denominator);
            const __m256 vgc = _mm256_set1_ps(pr.gap_char);
            const __m256 vcut = _mm256_set1_ps(max_score - xdrop_f);
            const float* M = pr.matrix;
            const int ms = pr.msize;
            const long vcount = count & ~7L;
            // load-base clamp: when a whole 8-lane group is outside the
            // previous band, its masks discard every lane, but the load
            // address must stay inside the row's ±8 guard region
            auto clamp_base = [&](long b) {
                return std::min(std::max(b, -8L), (long)flen);
            };
            for (long off0 = 0; off0 < vcount; off0 += 8) {
                const long i0 = Lk + off0;
                const long j0 = jmax - (i0 - lprime);
                const long od0 = Lk - L[k3p1] + off0 - 1;
                const long ou0 = Lk - L[k3p2] + off0;
                const long ol0 = Lk - L[k3p2] + off0 - 1;
                const long odL = clamp_base(od0);
                const long ouL = clamp_base(ou0);
                const long olL = clamp_base(ol0);
                const long qb = query_idx + i0;        // qry pos, +lane
                const long rb = reference_idx + j0;    // ref pos, -lane

                // reversed ref-side loads: lane m holds position rb - m
                auto rload = [&](const float* base) {
                    return _mm256_permutevar8x32_ps(
                        _mm256_loadu_ps(base + rb - 7), REV);
                };
                __m256 sim;
                bool have_sim = false;
                if (simtab) {
                    // pure-column fast path: when all 16 codes of the
                    // block are pure, per-cell similarity is one gather
                    // from the P*P table built through similarity()
                    const __m256i qc = _mm256_loadu_si256(
                        (const __m256i*)(qryC + qb));
                    const __m256i rc = _mm256_permutevar8x32_epi32(
                        _mm256_loadu_si256((const __m256i*)(refC + rb - 7)),
                        REV);
                    if (_mm256_movemask_ps(_mm256_castsi256_ps(
                            _mm256_or_si256(qc, rc))) == 0) {
                        const __m256i sidx = _mm256_add_epi32(
                            _mm256_mullo_epi32(rc, _mm256_set1_epi32(P)),
                            qc);
                        sim = _mm256_i32gather_ps(simtab, sidx, 4);
                        have_sim = true;
                    }
                }
                if (have_sim) {
                } else if (P == 6) {
                    __m256 q[6], r[6];
                    for (int l = 0; l < 6; ++l) {
                        q[l] = _mm256_loadu_ps(
                            qryT + (size_t)l * qry_total + qb);
                        r[l] = rload(refT + (size_t)l * ref_total);
                    }
                    // similarity, scalar op order per lane
                    __m256 num = _mm256_setzero_ps();
                    for (int l = 0; l < 5; ++l) {
                        __m256 s = _mm256_mul_ps(_mm256_mul_ps(
                            q[0], _mm256_set1_ps(M[l * ms])), r[l]);
                        for (int m = 1; m < 5; ++m)
                            s = _mm256_add_ps(s, _mm256_mul_ps(_mm256_mul_ps(
                                q[m], _mm256_set1_ps(M[l * ms + m])), r[l]));
                        num = _mm256_add_ps(num, s);
                    }
                    for (int l = 0; l < 5; ++l)
                        num = _mm256_add_ps(num, _mm256_mul_ps(
                            _mm256_mul_ps(r[l], q[5]), vgc));
                    for (int m = 0; m < 5; ++m)
                        num = _mm256_add_ps(num, _mm256_mul_ps(
                            _mm256_mul_ps(r[5], q[m]), vgc));
                    sim = _mm256_div_ps(num, vden);
                } else {
                    // protein: the exact scalar summation order of
                    // similarity() (reference TALCO-XDrop.cpp:377-433 —
                    // 8-wide sumvec pairs, the m=16..20 tail added to num
                    // BEFORE the left-associative horizontal sum)
                    __m256 q[22], r[22];
                    for (int l = 0; l < 22; ++l) {
                        q[l] = _mm256_loadu_ps(
                            qryT + (size_t)l * qry_total + qb);
                        r[l] = rload(refT + (size_t)l * ref_total);
                    }
                    __m256 num = _mm256_setzero_ps();
                    for (int l = 0; l < 21; ++l) {
                        __m256 sv[8];
                        for (int j = 0; j < 8; ++j)
                            sv[j] = _mm256_mul_ps(_mm256_mul_ps(
                                q[j], _mm256_set1_ps(M[l * ms + j])), r[l]);
                        for (int j = 0; j < 8; ++j)
                            sv[j] = _mm256_add_ps(sv[j], _mm256_mul_ps(
                                _mm256_mul_ps(q[8 + j], _mm256_set1_ps(
                                    M[l * ms + 8 + j])), r[l]));
                        for (int m = 16; m < 21; ++m)
                            num = _mm256_add_ps(num, _mm256_mul_ps(
                                _mm256_mul_ps(r[l], q[m]),
                                _mm256_set1_ps(M[l * ms + m])));
                        __m256 s = sv[0];
                        for (int j = 1; j < 8; ++j)
                            s = _mm256_add_ps(s, sv[j]);
                        num = _mm256_add_ps(num, s);
                    }
                    for (int l = 0; l < 21; ++l)
                        num = _mm256_add_ps(num, _mm256_mul_ps(
                            _mm256_mul_ps(r[l], q[21]), vgc));
                    for (int m = 0; m < 21; ++m)
                        num = _mm256_add_ps(num, _mm256_mul_ps(
                            _mm256_mul_ps(r[21], q[m]), vgc));
                    sim = _mm256_div_ps(num, vden);
                }

                // match: S[k-1](i-1) + sim where the diagonal is valid
                const __m256i odv = _mm256_add_epi32(
                    _mm256_set1_epi32((int)od0), IOTA);
                const __m256i m_dv = _mm256_and_si256(
                    _mm256_cmpgt_epi32(odv, _mm256_set1_epi32(-1)),
                    _mm256_cmpgt_epi32(_mm256_set1_epi32((int)UL1 + 1), odv));
                __m256 match = _mm256_add_ps(
                    _mm256_loadu_ps(S[k3p1] + odL), sim);
                match = _mm256_blendv_ps(vneg, match,
                                         _mm256_castsi256_ps(m_dv));

                // gap recurrences
                const __m256 pgo_r = rload(go_ref);
                const __m256 pge_r = rload(ge_ref);
                const __m256 pgo_q = _mm256_loadu_ps(go_qry + qb);
                const __m256 pge_q = _mm256_loadu_ps(ge_qry + qb);
                const __m256i ouv = _mm256_add_epi32(
                    _mm256_set1_epi32((int)ou0), IOTA);
                const __m256i olv = _mm256_add_epi32(
                    _mm256_set1_epi32((int)ol0), IOTA);
                const __m256i m_up = _mm256_and_si256(
                    _mm256_cmpgt_epi32(ouv, _mm256_set1_epi32(-1)),
                    _mm256_cmpgt_epi32(_mm256_set1_epi32((int)UL2 + 1), ouv));
                const __m256i m_lf = _mm256_and_si256(
                    _mm256_cmpgt_epi32(olv, _mm256_set1_epi32(-1)),
                    _mm256_cmpgt_epi32(_mm256_set1_epi32((int)UL2 + 1), olv));
                const __m256 mu = _mm256_castsi256_ps(m_up);
                const __m256 ml = _mm256_castsi256_ps(m_lf);
                const __m256 del_op = _mm256_blendv_ps(vneg, _mm256_add_ps(
                    _mm256_loadu_ps(S[k3p2] + ouL), pgo_r), mu);
                const __m256 del_ext = _mm256_blendv_ps(vneg, _mm256_add_ps(
                    _mm256_loadu_ps(Drows[k2p1] + ouL), pge_r), mu);
                const __m256 ins_op = _mm256_blendv_ps(vneg, _mm256_add_ps(
                    _mm256_loadu_ps(S[k3p2] + olL), pgo_q), ml);
                const __m256 ins_ext = _mm256_blendv_ps(vneg, _mm256_add_ps(
                    _mm256_loadu_ps(Irows[k2p1] + olL), pge_q), ml);

                const __m256 m_ie = _mm256_cmp_ps(ins_ext, ins_op,
                                                  _CMP_GE_OQ);
                const __m256 m_de = _mm256_cmp_ps(del_ext, del_op,
                                                  _CMP_GE_OQ);
                const __m256 i_val = _mm256_blendv_ps(ins_op, ins_ext, m_ie);
                const __m256 d_val = _mm256_blendv_ps(del_op, del_ext, m_de);

                const __m256 m_mi = _mm256_cmp_ps(match, i_val, _CMP_GE_OQ);
                const __m256 m_md = _mm256_cmp_ps(match, d_val, _CMP_GE_OQ);
                const __m256 m_id = _mm256_cmp_ps(i_val, d_val, _CMP_GT_OQ);
                // s = m_mi ? (m_md ? match : d) : (m_id ? i : d)
                const __m256 s_hi = _mm256_blendv_ps(d_val, match, m_md);
                const __m256 s_lo = _mm256_blendv_ps(d_val, i_val, m_id);
                __m256 s_val = _mm256_blendv_ps(s_lo, s_hi, m_mi);
                // ptr = m_mi ? (m_md ? 0 : 2) : (m_id ? 1 : 2)
                const __m256i one = _mm256_set1_epi32(1);
                const __m256i two = _mm256_set1_epi32(2);
                const __m256i p_hi = _mm256_blendv_epi8(
                    two, _mm256_setzero_si256(), _mm256_castps_si256(m_md));
                const __m256i p_lo = _mm256_blendv_epi8(
                    two, one, _mm256_castps_si256(m_id));
                __m256i ptrv = _mm256_blendv_epi8(p_lo, p_hi,
                                                  _mm256_castps_si256(m_mi));
                ptrv = _mm256_or_si256(ptrv, _mm256_and_si256(
                    _mm256_castps_si256(m_ie), _mm256_set1_epi32(4)));
                ptrv = _mm256_or_si256(ptrv, _mm256_and_si256(
                    _mm256_castps_si256(m_de), _mm256_set1_epi32(8)));

                const __m256 m_kill = _mm256_cmp_ps(s_val, vcut, _CMP_LT_OQ);
                s_val = _mm256_blendv_ps(s_val, vneg, m_kill);

                _mm256_storeu_ps(i_row.data() + off0, i_val);
                _mm256_storeu_ps(d_row.data() + off0, d_val);
                _mm256_storeu_ps(s_row.data() + off0, s_val);
                // pack the 8 dword ptrs (0..15) to 8 bytes in-vector:
                // low byte of each dword per 128-bit half, then merge
                const __m128i PB = _mm_setr_epi8(
                    0, 4, 8, 12, -1, -1, -1, -1,
                    -1, -1, -1, -1, -1, -1, -1, -1);
                const __m128i plo = _mm_shuffle_epi8(
                    _mm256_castsi256_si128(ptrv), PB);
                const __m128i phi = _mm_shuffle_epi8(
                    _mm256_extracti128_si256(ptrv, 1), PB);
                _mm_storel_epi64((__m128i*)(ptr_row.data() + off0),
                                 _mm_unpacklo_epi32(plo, phi));

                if (k >= marker + 1) {
                    const __m256i fmax = _mm256_set1_epi32(flen - 1);
                    const __m256i zero = _mm256_setzero_si256();
                    const __m256i lt = _mm256_min_epi32(
                        _mm256_max_epi32(olv, zero), fmax);
                    const __m256i ut = _mm256_min_epi32(
                        _mm256_max_epi32(ouv, zero), fmax);
                    const __m256i dt = _mm256_min_epi32(
                        _mm256_max_epi32(odv, zero), fmax);
                    const __m256i lf_ok = _mm256_cmpgt_epi32(
                        olv, _mm256_set1_epi32(-1));
                    const __m256i up_ok = _mm256_cmpgt_epi32(
                        ouv, _mm256_set1_epi32(-1));
                    const __m256i IB = _mm256_set1_epi32(I_BOUNDARY);
                    const __m256i DB = _mm256_set1_epi32(D_BOUNDARY);
                    const __m256i mo = _mm256_set1_epi32(-1);

                    const __m256i ci_raw = _mm256_i32gather_epi32(
                        (const int*)CI[k2p1], lt, 4);
                    const __m256i cs_left = _mm256_i32gather_epi32(
                        (const int*)CS[k3p2], lt, 4);
                    const __m256i ci_prop = _mm256_blendv_epi8(IB, ci_raw,
                                                               lf_ok);
                    const __m256i ci_open = _mm256_blendv_epi8(
                        IB, cs_left, _mm256_andnot_si256(
                            _mm256_cmpeq_epi32(cs_left, mo), lf_ok));
                    const __m256i new_ci = _mm256_blendv_epi8(
                        ci_open, ci_prop, _mm256_castps_si256(m_ie));

                    const __m256i cd_raw = _mm256_i32gather_epi32(
                        (const int*)CD[k2p1], ut, 4);
                    const __m256i cs_up = _mm256_i32gather_epi32(
                        (const int*)CS[k3p2], ut, 4);
                    const __m256i cd_prop = _mm256_blendv_epi8(DB, cd_raw,
                                                               up_ok);
                    const __m256i cd_open = _mm256_blendv_epi8(
                        DB, cs_up, _mm256_andnot_si256(
                            _mm256_cmpeq_epi32(cs_up, mo), up_ok));
                    const __m256i new_cd = _mm256_blendv_epi8(
                        cd_open, cd_prop, _mm256_castps_si256(m_de));

                    const __m256i cs_diag = _mm256_i32gather_epi32(
                        (const int*)CS[k3p1], dt, 4);
                    // new_cs = ptr==0 ? cs_diag : (ptr==1 ? new_ci : new_cd)
                    const __m256i is0 = _mm256_cmpeq_epi32(
                        _mm256_and_si256(ptrv, _mm256_set1_epi32(3)), zero);
                    const __m256i is1 = _mm256_cmpeq_epi32(
                        _mm256_and_si256(ptrv, _mm256_set1_epi32(3)), one);
                    __m256i new_cs = _mm256_blendv_epi8(new_cd, new_ci, is1);
                    new_cs = _mm256_blendv_epi8(new_cs, cs_diag, is0);

                    _mm256_storeu_si256((__m256i*)(ci_row.data() + off0),
                                        new_ci);
                    _mm256_storeu_si256((__m256i*)(cd_row.data() + off0),
                                        new_cd);
                    _mm256_storeu_si256((__m256i*)(cs_row.data() + off0),
                                        new_cs);
                }
            }
            for (long off = vcount; off < count; ++off) do_cell(off);
            if (tile_no == 0) {
                // border lanes (i == 0 or j == 0): recompute scalar
                if (Lk == 0) do_cell(0);
                const long off_j0 = jmax + lprime - Lk;  // lane with j == 0
                if (off_j0 >= 0 && off_j0 < count) do_cell(off_j0);
            }
        } else {
            for (long off = 0; off < count; ++off) do_cell(off);
        }
#else
        for (long off = 0; off < count; ++off) do_cell(off);
#endif

        const uint64_t kst_tail0 = KSTATS_NOW();
        if (kstats.on) kstats.cyc_cells += kst_tail0 - kst_cell0;

        float mx = s_row[0];
#if defined(__AVX2__)
        // max is order-independent over finite floats / neg_inf (no NaNs
        // on this path), so the vector reduction is bit-exact
        if (count >= 8) {
            __m256 vmx = _mm256_loadu_ps(s_row.data());
            long off = 8;
            for (; off + 8 <= count; off += 8)
                vmx = _mm256_max_ps(vmx, _mm256_loadu_ps(s_row.data() + off));
            alignas(32) float mtmp[8];
            _mm256_store_ps(mtmp, vmx);
            for (int m = 0; m < 8; ++m) if (mtmp[m] > mx) mx = mtmp[m];
            for (; off < count; ++off)
                if (s_row[off] > mx) mx = s_row[off];
        } else
#endif
        {
            for (long off = 1; off < count; ++off)
                if (s_row[off] > mx) mx = s_row[off];
        }
        if (max_score_prime < mx) max_score_prime = mx;

        std::memcpy(Irows[k2], i_row.data(), count * sizeof(float));
        std::memcpy(Drows[k2], d_row.data(), count * sizeof(float));
        std::memcpy(S[k3], s_row.data(), count * sizeof(float));

        if (k == marker - 1) {
            for (long off = 0; off < count; ++off)
                CS[k3][off] = (3 << 16) | ((int32_t)(Lk + off) & 0xFFFF);
        } else if (k == marker) {
            for (long off = 0; off < count; ++off) {
                const int32_t low = (int32_t)(Lk + off) & 0xFFFF;
                CS[k3][off] = low;
                CI[k2][off] = (1 << 16) | low;
                CD[k2][off] = (2 << 16) | low;
            }
        } else if (k >= marker + 1) {
            std::memcpy(CI[k2], ci_row.data(), count * sizeof(int32_t));
            std::memcpy(CD[k2], cd_row.data(), count * sizeof(int32_t));
            std::memcpy(CS[k3], cs_row.data(), count * sizeof(int32_t));
        }

        if (k <= marker)
            tb.insert(tb.end(), ptr_row.begin(), ptr_row.begin() + count);

        // band shrink (first/last lane above neg_inf — order-independent,
        // so the 8-lane movemask scan is bit-exact vs the scalar walk)
        long new_l, new_u;
        {
            long first = -1, last = -1;
#if defined(__AVX2__)
            const __m256 vninf = _mm256_set1_ps(neg_inf);
            long off = 0;
            for (; off + 8 <= count; off += 8) {
                const int m = _mm256_movemask_ps(_mm256_cmp_ps(
                    _mm256_loadu_ps(s_row.data() + off), vninf,
                    _CMP_GT_OQ));
                if (m) { first = off + __builtin_ctz(m); break; }
            }
            if (first == -1)
                for (; off < count; ++off)
                    if (s_row[off] > neg_inf) { first = off; break; }
            if (first != -1) {
                long hi = count;
                while (hi - 8 >= first) {
                    const int m = _mm256_movemask_ps(_mm256_cmp_ps(
                        _mm256_loadu_ps(s_row.data() + hi - 8), vninf,
                        _CMP_GT_OQ));
                    if (m) { last = hi - 8 + 31 - __builtin_clz(m); break; }
                    hi -= 8;
                }
                if (last == -1)
                    for (long o2 = hi - 1; o2 >= first; --o2)
                        if (s_row[o2] > neg_inf) { last = o2; break; }
            }
#else
            for (long off = 0; off < count; ++off)
                if (s_row[off] > neg_inf) { first = off; break; }
            if (first != -1)
                for (long off = count - 1; off >= 0; --off)
                    if (s_row[off] > neg_inf) { last = off; break; }
#endif
            if (first == -1) { new_l = Uk + 1; new_u = Lk - 1; }
            else { new_l = Lk + first; new_u = Lk + last; }
        }

        if (!converged && k < ref_len + qry_len - 2) {
            if (k < marker - 1) {
                // Pre-marker the conv rows are untouched since init:
                // CS[k3] is all -1 (reduction -> -1) and CI/CD hold
                // I_BOUNDARY/D_BOUNDARY (conv_i == conv_d impossible),
                // so the three full-band scans — which CANNOT early-exit
                // here, all values being equal — are skipped wholesale.
                // Exactly equivalent: convergence cannot fire and
                // prev_conv_s would be set to -1. (The CUDA kernel skips
                // the same pre-marker reductions.)
                prev_conv_s = -1;
            } else {
                const int start = (int)(new_l - Lk);
                const int length = (int)(new_u - new_l);
                const int32_t conv_i = reduction(CI[k2], flen, start, length);
                const int32_t conv_d = reduction(CD[k2], flen, start, length);
                const int32_t conv_s = reduction(CS[k3], flen, start, length);
                if (conv_i == conv_d && conv_i == conv_s
                        && prev_conv_s == conv_s && conv_i != -1) {
                    converged = true;
                    conv_value = prev_conv_s;
                    conv_score = max_score_prime;
                }
                prev_conv_s = conv_s;
            }
        }

        const long v1 = qry_len - 1;
        const long v2 = k + 2 - ref_len;
        const long v3 = new_u + 1;
        L[k3p1] = std::max(new_l, std::max(0L, v2));
        U[k3p1] = std::min(v1, v3);

        max_score = max_score_prime < 0 ? 0.0f : max_score_prime;
        last_k = k;
        if (kstats.on) kstats.cyc_tail += KSTATS_NOW() - kst_tail0;
        if (converged && max_score > conv_score) { conv_logic = true; break; }
    }

    // locate traceback start (TALCO-XDrop.cpp:615-652)
    last_tile = false;
    long conv_query_idx, conv_ref_idx, tb_start_addr;
    int tb_start_ftr, tb_state;
    const int nftr = (int)ftr_length.size();
    if (conv_logic) {
        conv_query_idx = conv_value & 0xFFFF;
        tb_state = (conv_value >> 16) & 0xFFFF;
        conv_ref_idx = marker - conv_query_idx;
        conv_ref_idx -= (tb_state == 3) ? 1 : 0;
        tb_start_addr = ftr_addr - ftr_length[nftr - 1];
        if (tb_state == 3) {
            tb_start_addr = tb_start_addr - ftr_length[nftr - 2] +
                (conv_query_idx - ftr_lower_limit[nftr - 2]);
            tb_start_ftr = nftr - 2;
        } else {
            tb_start_addr = tb_start_addr +
                (conv_query_idx - ftr_lower_limit[nftr - 1]);
            tb_start_ftr = nftr - 1;
        }
    } else {
        if (last_k < marker) {
            conv_query_idx = qry_len - 1;
            conv_ref_idx = ref_len - 1;
            tb_start_addr = ftr_addr - 1;
            tb_start_ftr = (int)last_k;
            tb_state = 0;
            last_tile = true;
        } else {
            const int32_t cs0 = CS[last_k % 3][0];
            conv_query_idx = cs0 & 0xFFFF;
            tb_state = (cs0 >> 16) & 0xFFFF;
            conv_ref_idx = marker - conv_query_idx;
            conv_ref_idx -= (tb_state == 3) ? 1 : 0;
            tb_start_addr = ftr_addr - ftr_length[nftr - 1];
            if (tb_state == 3) {
                tb_start_addr = tb_start_addr - ftr_length[nftr - 2] +
                    (conv_query_idx - ftr_lower_limit[nftr - 2]);
                tb_start_ftr = nftr - 2;
            } else {
                tb_start_addr = tb_start_addr +
                    (conv_query_idx - ftr_lower_limit[nftr - 1]);
                tb_start_ftr = nftr - 1;
            }
        }
    }

    if (conv_query_idx == D_BOUNDARY_LOW16) {
        conv_query_idx = 0;
        conv_ref_idx = pr.marker;
    } else if (conv_query_idx == I_BOUNDARY_LOW16) {
        conv_query_idx = pr.marker;
        conv_ref_idx = 0;
    }

    reference_idx += conv_ref_idx;
    query_idx += conv_query_idx;
    ref_len = ref_total - reference_idx;
    qry_len = qry_total - query_idx;
    if (ref_len < 0 || qry_len < 0) { last_tile = true; return 3; }

    if (reference_idx == ref_total - 1 && query_idx < qry_total - 1) {
        for (long n = 0; n < qry_total - query_idx - 1; ++n)
            tile_aln.push_back(1);
        last_tile = true;
    }
    if (query_idx == qry_total - 1 && reference_idx < ref_total - 1) {
        for (long n = 0; n < ref_total - reference_idx - 1; ++n)
            tile_aln.push_back(2);
        last_tile = true;
    }
    if (reference_idx == ref_total - 1 && query_idx == qry_total - 1)
        last_tile = true;

    const uint64_t kst_tb0 = KSTATS_NOW();
    if (!traceback(ftr_length, ftr_lower_limit, tb_start_addr, tb_start_ftr,
                   tb_state % 3, (int)conv_query_idx, (int)conv_ref_idx, tb,
                   tile_aln, tile_no == 0)) {
        last_tile = true;
        return 3;
    }
    if (kstats.on) kstats.cyc_tb += KSTATS_NOW() - kst_tb0;
    return 0;
}

}  // namespace

extern "C" {

// Multi-tile driver (reference Align_freq). Returns path length (>=0) into
// out, or -errorType (1/2/3) on failure. out must hold ref_total+qry_total.
int64_t talco_align_freq(
        const float* freq_ref, int64_t ref_total,
        const float* freq_qry, int64_t qry_total, int32_t P,
        const float* go_ref, const float* go_qry,
        const float* ge_ref, const float* ge_qry,
        const float* matrix, int32_t msize,
        float gap_open, float gap_extend, float gap_char,
        float ref_num, float qry_num,
        int32_t xdrop, int32_t flen, int32_t marker,
        int8_t* out) {
    const uint64_t kst_call0 = KSTATS_NOW();
    Params pr;
    pr.matrix = matrix; pr.msize = msize; pr.p = P;
    pr.gap_open = gap_open; pr.gap_extend = gap_extend; pr.gap_char = gap_char;
    pr.xdrop = xdrop; pr.flen = flen; pr.marker = marker;

    long reference_idx = 0, query_idx = 0;
    bool last_tile = false;
    int tile_no = 0;
    std::vector<int8_t> outv;
    outv.reserve((size_t)(ref_total + qry_total));
    std::vector<int8_t> tile_aln;
    // planar-transposed profiles ([P][len]) for the AVX2 across-cells
    // path: per-letter rows become contiguous loads along a diagonal
    std::vector<float> refT, qryT;
    if (P == 6 || P == 22) {
        refT.resize((size_t)P * ref_total);
        qryT.resize((size_t)P * qry_total);
        for (long pos = 0; pos < ref_total; ++pos)
            for (int l = 0; l < P; ++l)
                refT[(size_t)l * ref_total + pos] = freq_ref[pos * P + l];
        for (long pos = 0; pos < qry_total; ++pos)
            for (int l = 0; l < P; ++l)
                qryT[(size_t)l * qry_total + pos] = freq_qry[pos * P + l];
    }

    // Pure-column fast path. A profile column is "pure" when its single
    // nonzero lane bitwise-equals the profile's weight sum (num) — every
    // member sequence agrees there (leaves: num == 1.0f, the one-hot
    // case). For a (pure, pure) cell the expected-score sum is one
    // nonzero term plus exact IEEE zeros, so similarity reduces to a
    // P*P lookup. The table is built THROUGH similarity() itself on
    // synthetic pure columns (same op order, same division by this
    // call's denominator), making the shortcut provably bit-exact;
    // impure columns get code -1 and fall back to the full sum; it
    // covers leaf pairs and internal profiles' conserved columns.
    std::vector<int32_t> refC, qryC;
    std::vector<float> simtab;
    if (P == 6 || P == 22) {
        auto codes_of = [P](const float* freq, long total, float numv,
                            std::vector<int32_t>& codes) -> bool {
            uint32_t nb;
            std::memcpy(&nb, &numv, 4);
            if (nb == 0u || (nb >> 31)) return false;  // num <= +0: skip
            codes.resize((size_t)total);
            long pure = 0;
            for (long pos = 0; pos < total; ++pos) {
                const float* col = freq + (size_t)pos * P;
                int hot = -1;
                for (int l = 0; l < P; ++l) {
                    uint32_t b;
                    std::memcpy(&b, &col[l], 4);
                    if (b == nb) {
                        if (hot >= 0) { hot = -1; break; }
                        hot = l;
                    } else if (b != 0u) {
                        hot = -1;
                        break;
                    }
                }
                codes[pos] = hot;
                pure += hot >= 0;
            }
            return pure > 0;
        };
        if (codes_of(freq_ref, ref_total, ref_num, refC)
                && codes_of(freq_qry, qry_total, qry_num, qryC)) {
            simtab.resize((size_t)P * P);
            std::vector<float> r1(P, 0.0f), q1(P, 0.0f);
            for (int l = 0; l < P; ++l) {
                r1[l] = ref_num;
                for (int m = 0; m < P; ++m) {
                    q1[m] = qry_num;
                    simtab[(size_t)l * P + m] = similarity(
                        r1.data(), q1.data(), pr, ref_num * qry_num);
                    q1[m] = 0.0f;
                }
                r1[l] = 0.0f;
            }
        }
    }
    while (!last_tile) {
        tile_aln.clear();
        const int err = tile(freq_ref, ref_total, freq_qry, qry_total, P,
                             go_ref, go_qry, ge_ref, ge_qry,
                             ref_num, qry_num, pr,
                             reference_idx, query_idx, tile_no, last_tile,
                             tile_aln,
                             refT.empty() ? nullptr : refT.data(),
                             qryT.empty() ? nullptr : qryT.data(),
                             simtab.empty() ? nullptr : refC.data(),
                             simtab.empty() ? nullptr : qryC.data(),
                             simtab.empty() ? nullptr : simtab.data());
        if (err != 0 || tile_aln.empty()) return -(int64_t)(err ? err : 3);
        // reversed, dropping the first step of each non-first tile
        const long start = (long)tile_aln.size() - 1;
        for (long i = start; i >= 0; --i) {
            if (i == start && tile_no > 0) continue;
            outv.push_back(tile_aln[(size_t)i]);
        }
        tile_no += 1;
    }
    if (kstats.on) {
        kstats.cyc_call = KSTATS_NOW() - kst_call0;
        std::fprintf(stderr,
            "[kstats] tiles=%llu diags=%llu cells=%llu avg_band=%.1f "
            "Mcyc: cells=%.2f tail=%.2f setup=%.2f tb=%.2f call=%.2f\n",
            (unsigned long long)kstats.tiles,
            (unsigned long long)kstats.diags,
            (unsigned long long)kstats.cells,
            kstats.diags ? (double)kstats.cells / kstats.diags : 0.0,
            kstats.cyc_cells / 1e6, kstats.cyc_tail / 1e6,
            kstats.cyc_setup / 1e6, kstats.cyc_tb / 1e6,
            kstats.cyc_call / 1e6);
        kstats.reset();
    }
    std::memcpy(out, outv.data(), outv.size());
    return (int64_t)outv.size();
}

}  // extern "C"
