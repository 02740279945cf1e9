// TALCO-XDrop profile-profile alignment: CUDA kernel for NVIDIA Hopper,
// called from JAX through the XLA foreign function interface
// (ops/talco_gpu.py builds, registers and calls it).
//
// One thread block aligns one pair. The block's threads stride the live
// anti-diagonal band; the band rows (S/I/D scores, CS/CI/CD convergence
// markers) live in shared memory; the whole multi-tile X-drop loop, the
// convergence test and the traceback walk stay on the device, so a launch
// is one H2D copy of the packed profiles and one D2H copy of the paths.
// This is the shape of the reference GPU build (one block per pair, 256
// threads per anti-diagonal), kept in float32 instead of its int16 so the
// output matches the CPU semantics byte for byte.
//
// Float semantics follow the NumPy oracle (ops/talco_np.py) exactly: every
// product and sum is a separately rounded IEEE op (__fmul_rn/__fadd_rn, and
// the library is built with --fmad=false), division is IEEE (__fdiv_rn),
// and the similarity sum keeps the oracle's order. Out-of-band reads of the
// convergence rows clamp to the oracle's dynamic row length, as numpy's
// clip does there.
//
// Inputs (layout shared with ops/talco_jax.py, packed by
// talco_jax.pack_pair_into):
//   ref    f32 [B, TOT, P8]  reversed reference profile at rows
//                            [off + padlen - ref_len, off + padlen); the
//                            gap-open / gap-extend penalties ride in the
//                            last two columns P8-2 / P8-1
//   qry    f32 [B, TOT, P8]  query profile at rows [off, off + qry_len)
//   meta_i s32 [B, 4]        ref_len, qry_len, flen (ladder), xdrop
//   meta_f f32 [B, 5]        ref_num, qry_num, gap_char, gap_open,
//                            gap_extend
//   matrix f32 [M, M]        substitution matrix
// Results:
//   paths  s8  [B, MAXALN]   path codes (0 match, 1 ins, 2 del)
//   tail   s32 [B, 3]        path length, error, live-band cells
//   tb     s8  [B, MARKER+1, FLEN]   traceback pointers (scratch, one
//                                    region per pair)
//   ftr    s32 [B, 2, MARKER+1]      per-diagonal band length / low
//   seg    s8  [B, MARKER+8]         one tile's traceback steps
// Errors: 0 ok, 1 band collapse, 2 band exceeded the ladder fLen, 3 index
// error, 4 boundary-sentinel convergence (host recomputes the pair), 6 band
// exceeded the static FLEN window (host relaunches with a wider window).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kIBoundary = -2;
constexpr int kDBoundary = -3;
constexpr int kIBoundaryLow16 = kIBoundary & 0xFFFF;
constexpr int kDBoundaryLow16 = kDBoundary & 0xFFFF;

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Expected substitution score of one cell, in the oracle's summation order
// (talco_np.similarity_scores).
template <int P>
__device__ __forceinline__ float similarity(const float* __restrict__ r,
                                            const float* __restrict__ q,
                                            const float* __restrict__ M,
                                            int msize, float gap_char,
                                            float den) {
  float num = 0.0f;
  if (P == 6) {
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      const float rl = r[l];
      float s = fmul(fmul(q[0], M[l * msize + 0]), rl);
#pragma unroll
      for (int m = 1; m < 5; ++m)
        s = fadd(s, fmul(fmul(q[m], M[l * msize + m]), rl));
      num = fadd(num, s);
    }
#pragma unroll
    for (int l = 0; l < 5; ++l) num = fadd(num, fmul(fmul(r[l], q[5]), gap_char));
#pragma unroll
    for (int m = 0; m < 5; ++m) num = fadd(num, fmul(fmul(r[5], q[m]), gap_char));
  } else {
    for (int l = 0; l < 21; ++l) {
      const float rl = r[l];
      const float* Ml = M + l * msize;
      float sv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) sv[j] = fmul(fmul(q[j], Ml[j]), rl);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sv[j] = fadd(sv[j], fmul(fmul(q[8 + j], Ml[8 + j]), rl));
#pragma unroll
      for (int m = 16; m < 21; ++m) num = fadd(num, fmul(fmul(rl, q[m]), Ml[m]));
      float s = sv[0];
#pragma unroll
      for (int j = 1; j < 8; ++j) s = fadd(s, sv[j]);
      num = fadd(num, s);
    }
#pragma unroll
    for (int l = 0; l < 21; ++l) num = fadd(num, fmul(fmul(r[l], q[21]), gap_char));
#pragma unroll
    for (int m = 0; m < 21; ++m) num = fadd(num, fmul(fmul(r[21], q[m]), gap_char));
  }
  return __fdiv_rn(num, den);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_min_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_max_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int P>
__global__ void talco_xdrop_kernel(
    const float* __restrict__ ref_g, const float* __restrict__ qry_g,
    const int32_t* __restrict__ meta_i, const float* __restrict__ meta_f,
    const float* __restrict__ mat_g, int msize, int tot, int padlen, int off,
    int FLEN, int marker, int maxaln, int8_t* __restrict__ paths,
    int32_t* __restrict__ tail, int8_t* __restrict__ tb_g,
    int32_t* __restrict__ ftr_g, int8_t* __restrict__ seg_g) {
  constexpr int P8 = (P + 2 + 7) / 8 * 8;
  const int pair = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int NW = T >> 5;
  const int warp = tid >> 5;
  const int W = FLEN + 2;  // band row width: FLEN lanes + 2 reads past it

  extern __shared__ __align__(16) unsigned char smem[];
  float* Sb = reinterpret_cast<float*>(smem);  // 3 rows
  float* Ib = Sb + 3 * W;                      // 2 rows
  float* Db = Ib + 2 * W;                      // 2 rows
  int* CSb = reinterpret_cast<int*>(Db + 2 * W);  // 3 rows
  int* CIb = CSb + 3 * W;                         // 2 rows
  int* CDb = CIb + 2 * W;                         // 2 rows
  float* M = reinterpret_cast<float*>(CDb + 2 * W);
  float* red_max = M + msize * msize;                       // [2][NW]
  int* red_lo = reinterpret_cast<int*>(red_max + 2 * NW);  // [2][NW]
  int* red_hi = red_lo + 2 * NW;                           // [2][NW]
  int* red_cv = red_hi + 2 * NW;                           // [2][NW]
  int* bcast = red_cv + 2 * NW;                            // [8]

  for (int x = tid; x < msize * msize; x += T) M[x] = mat_g[x];

  const float* R = ref_g + static_cast<size_t>(pair) * tot * P8;
  const float* Q = qry_g + static_cast<size_t>(pair) * tot * P8;
  const int ref_len = meta_i[pair * 4 + 0];
  const int qry_len = meta_i[pair * 4 + 1];
  const int flen_param = meta_i[pair * 4 + 2];
  const int xdrop = meta_i[pair * 4 + 3];
  const float ref_num = meta_f[pair * 5 + 0];
  const float qry_num = meta_f[pair * 5 + 1];
  const float gap_char = meta_f[pair * 5 + 2];
  const float gap_open = meta_f[pair * 5 + 3];
  const float gap_extend = meta_f[pair * 5 + 4];
  int8_t* tb = tb_g + static_cast<size_t>(pair) * (marker + 1) * FLEN;
  int32_t* ftr_len = ftr_g + static_cast<size_t>(pair) * 2 * (marker + 1);
  int32_t* ftr_low = ftr_len + (marker + 1);
  int8_t* seg = seg_g + static_cast<size_t>(pair) * (marker + 8);
  int8_t* out = paths + static_cast<size_t>(pair) * maxaln;

  const float den = fmul(ref_num, qry_num);
  const float xdrop_f = static_cast<float>(xdrop);
  const float neg_inf = -fadd(fmul(2.0f, xdrop_f), 1.0f);

  int ref_idx = 0, qry_idx = 0, tile_no = 0, out_len = 0, err = 0;
  bool last_tile = false;
  long long cells = 0;

  while (!last_tile && err == 0) {
    const int ref_rem = ref_len - ref_idx;
    const int qry_rem = qry_len - qry_idx;
    if (ref_rem < 0 || qry_rem < 0) {
      err = 3;
      break;
    }
    const int dflen = min(flen_param, min(ref_rem, qry_rem));
    // the oracle's rows are dflen long; its clipped reads stop there
    const int clip_hi = max(0, min(dflen, W) - 1);

    __syncthreads();  // previous tile's readers are done with the rows
    for (int x = tid; x < W; x += T) {
      Sb[x] = Sb[W + x] = Sb[2 * W + x] = -1.0f;
      Ib[x] = Ib[W + x] = -1.0f;
      Db[x] = Db[W + x] = -1.0f;
      CSb[x] = CSb[W + x] = CSb[2 * W + x] = -1;
      CIb[x] = CIb[W + x] = kIBoundary;
      CDb[x] = CDb[W + x] = kDBoundary;
    }
    __syncthreads();

    // bands of diagonals k, k-1 and k-2
    int Lc = 0, Uc = 0, L1 = 2, U1 = -2, L2 = 1, U2 = -1;
    int last_k = 0, prev_conv_s = -1, conv_value = 0;
    bool converged = false, conv_logic = false;
    float conv_score = 0.0f, max_score = 0.0f, msp = neg_inf;
    const int cell_count = ref_rem + qry_rem - 1;
    int terr = 0;

    for (int k = 0; k < cell_count; ++k) {
      if (Lc >= Uc + 1) { terr = 1; break; }
      const int count = Uc - Lc + 1;
      if (count > dflen) { terr = 2; break; }
      if (count > FLEN) { terr = 6; break; }
      if (k <= marker && tid == 0) {
        ftr_len[k] = count;
        ftr_low[k] = Lc;
      }
      cells += count;
      const int k3 = k % 3, k3p1 = (k + 1) % 3, k3p2 = (k + 2) % 3;
      const int k2 = k & 1, k2p1 = k2 ^ 1;
      float* Scur = Sb + k3 * W;
      const float* Sd = Sb + k3p1 * W;
      const float* Su = Sb + k3p2 * W;
      float* Icur = Ib + k2 * W;
      const float* Iu = Ib + k2p1 * W;
      float* Dcur = Db + k2 * W;
      const float* Du = Db + k2p1 * W;
      int* CScur = CSb + k3 * W;
      const int* CSd = CSb + k3p1 * W;
      const int* CSu = CSb + k3p2 * W;
      int* CIcur = CIb + k2 * W;
      const int* CIu = CIb + k2p1 * W;
      int* CDcur = CDb + k2 * W;
      const int* CDu = CDb + k2p1 * W;
      const int lprime = max(0, k - ref_rem + 1);
      const int jmax = min(k, ref_rem - 1);
      const float thr = __fsub_rn(max_score, xdrop_f);

      float lmax = neg_inf;  // post-kill scores are >= neg_inf
      int lfirst = INT_MAX, llast = -1;
      for (int lane = tid; lane < count; lane += T) {
        const int i = Lc + lane;
        const int j = jmax - (i - lprime);
        const int od = Lc - L2 + lane - 1;
        const int ou = Lc - L1 + lane;
        const int ol = ou - 1;
        const bool diag_valid = od >= 0 && od <= U2 - L2;
        const bool border = tile_no == 0 && (i == 0 || j == 0);
        const float* rrow =
            R + static_cast<size_t>(clampi(off + padlen - 1 - (ref_idx + j), 0, tot - 1)) * P8;
        const float* qrow =
            Q + static_cast<size_t>(clampi(off + qry_idx + i, 0, tot - 1)) * P8;
        float match = neg_inf;
        if (k == 0 || diag_valid || border) {
          const float sim = similarity<P>(rrow, qrow, M, msize, gap_char, den);
          if (border) {
            if (i == 0 && j == 0) {
              match = sim;
            } else {
              const int steps = max(0, max(ref_idx + j, qry_idx + i) - 1);
              match = fadd(fadd(sim, gap_open),
                           fmul(gap_extend, static_cast<float>(steps)));
            }
          } else if (od < 0) {
            match = sim;
          } else {
            match = fadd(Sd[od], sim);
          }
        }
        const float go_ref = rrow[P8 - 2], ge_ref = rrow[P8 - 1];
        const float go_qry = qrow[P8 - 2], ge_qry = qrow[P8 - 1];
        const bool up_valid = ou >= 0 && ou <= U1 - L1;
        const bool left_valid = ol >= 0 && ol <= U1 - L1;
        const float del_op = up_valid ? fadd(Su[ou], go_ref) : neg_inf;
        const float del_ext = up_valid ? fadd(Du[ou], ge_ref) : neg_inf;
        const float ins_op = left_valid ? fadd(Su[ol], go_qry) : neg_inf;
        const float ins_ext = left_valid ? fadd(Iu[ol], ge_qry) : neg_inf;
        const bool iptr = ins_ext >= ins_op;
        const bool dptr = del_ext >= del_op;
        const float iv = iptr ? ins_ext : ins_op;
        const float dv = dptr ? del_ext : del_op;
        float sv;
        int ptr;
        if (match >= iv) {
          if (match >= dv) { sv = match; ptr = 0; } else { sv = dv; ptr = 2; }
        } else {
          if (iv > dv) { sv = iv; ptr = 1; } else { sv = dv; ptr = 2; }
        }
        if (sv < thr) sv = neg_inf;
        lmax = fmaxf(lmax, sv);
        Icur[lane] = iv;
        Dcur[lane] = dv;
        Scur[lane] = sv;

        const int ilow = i & 0xFFFF;
        if (k == marker - 1) {
          CScur[lane] = (3 << 16) | ilow;
        } else if (k == marker) {
          CScur[lane] = ilow;
          CIcur[lane] = (1 << 16) | ilow;
          CDcur[lane] = (2 << 16) | ilow;
        } else if (k >= marker + 1) {
          const int lt = clampi(ol, 0, clip_hi);
          const int ut = clampi(ou, 0, clip_hi);
          const int dt = clampi(od, 0, clip_hi);
          const int ci_prop = ol >= 0 ? CIu[lt] : kIBoundary;
          const int cs_left = CSu[lt];
          const int ci_open = (ol >= 0 && cs_left != -1) ? cs_left : kIBoundary;
          const int nci = iptr ? ci_prop : ci_open;
          const int cd_prop = ou >= 0 ? CDu[ut] : kDBoundary;
          const int cs_up = CSu[ut];
          const int cd_open = (ou >= 0 && cs_up != -1) ? cs_up : kDBoundary;
          const int ncd = dptr ? cd_prop : cd_open;
          CScur[lane] = ptr == 0 ? CSd[dt] : (ptr == 1 ? nci : ncd);
          CIcur[lane] = nci;
          CDcur[lane] = ncd;
        }
        if (k <= marker)
          tb[static_cast<size_t>(k) * FLEN + lane] =
              static_cast<int8_t>(ptr | (iptr << 2) | (dptr << 3));
        if (sv > neg_inf) {
          lfirst = min(lfirst, lane);
          llast = max(llast, lane);
        }
      }

      // block reductions: band max and the first/last live lane
      const int buf = (k & 1) * NW;
      lmax = warp_max(lmax);
      lfirst = warp_min_i(lfirst);
      llast = warp_max_i(llast);
      if ((tid & 31) == 0) {
        red_max[buf + warp] = lmax;
        red_lo[buf + warp] = lfirst;
        red_hi[buf + warp] = llast;
      }
      __syncthreads();
      float mx = red_max[buf];
      int first = red_lo[buf], last = red_hi[buf];
      for (int w = 1; w < NW; ++w) {
        mx = fmaxf(mx, red_max[buf + w]);
        first = min(first, red_lo[buf + w]);
        last = max(last, red_hi[buf + w]);
      }
      if (msp < mx) msp = mx;
      const bool any_alive = last >= 0;
      const int new_l = any_alive ? Lc + first : Uc + 1;
      const int new_u = any_alive ? Lc + last : Lc - 1;

      if (!converged && k < ref_rem + qry_rem - 2) {
        // convergence rows hold only their init values before marker - 1,
        // where the reductions give I/D boundaries and CS -1: no hit
        int conv_s = -1;
        if (k >= marker - 1) {
          const int start = min(new_l - Lc, max(dflen - 1, 0));
          const int length = new_u - new_l;
          const int fi = CIcur[start], fd = CDcur[start], fs = CScur[start];
          int ci = fi, cd = fd;
          conv_s = fs;
          if (length >= 0) {
            const int end = min(start + length, max(dflen - 1, 0));
            unsigned ok = 7u;
            for (int x = start + tid; x <= end; x += T) {
              if (CIcur[x] != fi) ok &= ~1u;
              if (CDcur[x] != fd) ok &= ~2u;
              if (CScur[x] != fs) ok &= ~4u;
            }
            ok = __reduce_and_sync(0xffffffffu, ok);
            if ((tid & 31) == 0) red_cv[buf + warp] = static_cast<int>(ok);
            __syncthreads();
            unsigned all = 7u;
            for (int w = 0; w < NW; ++w) all &= static_cast<unsigned>(red_cv[buf + w]);
            ci = (all & 1u) ? fi : -1;
            cd = (all & 2u) ? fd : -1;
            conv_s = (all & 4u) ? fs : -1;
          }
          if (ci == cd && ci == conv_s && prev_conv_s == conv_s && ci != -1) {
            converged = true;
            conv_value = prev_conv_s;
            conv_score = msp;
          }
        }
        prev_conv_s = conv_s;
      }

      const int Ln = max(new_l, max(0, k + 2 - ref_rem));
      const int Un = min(qry_rem - 1, new_u + 1);
      L2 = L1; U2 = U1;
      L1 = Lc; U1 = Uc;
      Lc = Ln; Uc = Un;
      max_score = msp < 0.0f ? 0.0f : msp;
      last_k = k;
      if (converged && max_score > conv_score) {
        conv_logic = true;
        break;
      }
    }

    if (terr != 0) {
      err = terr;
      break;
    }

    // locate the traceback start and walk it (one thread; the walk is a
    // chain of dependent loads)
    if (tid == 0) {
      const int n_ftr = min(last_k, marker) + 1;
      int cqi, cri, start_ftr, tbs;
      bool lt = false;
      if (!conv_logic && last_k < marker) {
        cqi = qry_rem - 1;
        cri = ref_rem - 1;
        start_ftr = last_k;
        tbs = 0;
        lt = true;
      } else {
        const int cv = conv_logic ? conv_value : CSb[(last_k % 3) * W];
        cqi = cv & 0xFFFF;
        tbs = (cv >> 16) & 0xFFFF;
        cri = marker - cqi - (tbs == 3 ? 1 : 0);
        start_ftr = tbs == 3 ? n_ftr - 2 : n_ftr - 1;
      }
      int e = 0;
      if (cqi == kDBoundaryLow16 || cqi == kIBoundaryLow16) e = 4;
      const int reference_idx = ref_idx + cri;
      const int query_idx = qry_idx + cqi;
      if (e == 0 && (ref_len - reference_idx < 0 || qry_len - query_idx < 0)) e = 3;
      if (e == 0) {
        const bool at_r = reference_idx == ref_len - 1;
        const bool at_q = query_idx == qry_len - 1;
        const int fill1 = (at_r && query_idx < qry_len - 1) ? qry_len - query_idx - 1 : 0;
        const int fill2 = (at_q && reference_idx < ref_len - 1) ? ref_len - reference_idx - 1 : 0;
        if ((at_r && query_idx < qry_len - 1) || (at_q && reference_idx < ref_len - 1) ||
            (at_r && at_q))
          lt = true;
        const bool first_tile = tile_no == 0;
        int ftr = start_ftr, idx = cqi, q_i = cqi, r_i = cri, state = tbs % 3, n = 0;
        while (ftr >= 0 && n < marker + 8) {
          const int o = clampi(idx - ftr_low[ftr], 0, FLEN - 1);
          const int v = tb[static_cast<size_t>(ftr) * FLEN + o];
          int dir;
          if (state == 0) {
            const int s = v & 3;
            if (s == 0) { dir = 0; }
            else if (s == 1) { dir = 1; state = (v & 4) ? 1 : 0; }
            else { dir = 2; state = (v & 8) ? 2 : 0; }
          } else if (state == 1) {
            dir = 1; state = (v & 4) ? 1 : 0;
          } else {
            dir = 2; state = (v & 8) ? 2 : 0;
          }
          if (dir == 0) { ftr -= 2; --idx; --q_i; --r_i; }
          else if (dir == 1) { ftr -= 1; --idx; --q_i; }
          else { ftr -= 1; --r_i; }
          seg[n++] = static_cast<int8_t>(dir);
          if (first_tile && (r_i < 0 || q_i < 0)) break;
        }
        const int rfill = first_tile ? max(r_i + 1, 0) : 0;
        const int qfill = first_tile ? max(q_i + 1, 0) : 0;
        // the oracle's tile_aln is [fill1|fill2][steps][rfill][qfill];
        // it is emitted reversed, without its first code after tile 0
        const int total = qfill + rfill + n + fill2 + fill1;
        if (total == 0) {
          out_len = 0;  // the oracle returns an empty path here
          lt = true;
        } else {
          const int skip = tile_no > 0 ? 1 : 0;
          if (out_len + total - skip > maxaln) {
            e = 3;
          } else {
            int pos = out_len, t = 0;
            auto emit = [&](int8_t c) {
              if (t++ >= skip) out[pos++] = c;
            };
            for (int x = 0; x < qfill; ++x) emit(1);
            for (int x = 0; x < rfill; ++x) emit(2);
            for (int x = n - 1; x >= 0; --x) emit(seg[x]);
            for (int x = 0; x < fill2; ++x) emit(2);
            for (int x = 0; x < fill1; ++x) emit(1);
            out_len = pos;
          }
        }
      }
      bcast[0] = reference_idx;
      bcast[1] = query_idx;
      bcast[2] = out_len;
      bcast[3] = lt ? 1 : 0;
      bcast[4] = e;
    }
    __syncthreads();
    ref_idx = bcast[0];
    qry_idx = bcast[1];
    out_len = bcast[2];
    last_tile = bcast[3] != 0;
    err = bcast[4];
    ++tile_no;
  }

  if (tid == 0) {
    tail[pair * 3 + 0] = out_len;
    tail[pair * 3 + 1] = err;
    tail[pair * 3 + 2] = static_cast<int32_t>(cells > INT_MAX ? INT_MAX : cells);
  }
}

size_t SharedBytes(int flen, int msize, int threads) {
  const size_t w = static_cast<size_t>(flen) + 2;
  return 56 * w + 4 * static_cast<size_t>(msize) * msize +
         4 * 4 * 2 * static_cast<size_t>(threads / 32) + 4 * 8;
}

template <int P>
ffi::Error Launch(cudaStream_t stream, const float* ref, const float* qry,
                  const int32_t* mi, const float* mf, const float* mat,
                  int msize, int batch, int tot, int padlen, int off, int flen,
                  int marker, int maxaln, int threads, int8_t* paths,
                  int32_t* tail, int8_t* tb, int32_t* ftr, int8_t* seg) {
  const size_t smem = SharedBytes(flen, msize, threads);
  cudaError_t st = cudaFuncSetAttribute(
      talco_xdrop_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (st != cudaSuccess)
    return ffi::Error::Internal(std::string("talco: shared memory plan: ") +
                                cudaGetErrorString(st));
  if (batch > 0)
    talco_xdrop_kernel<P><<<batch, threads, smem, stream>>>(
        ref, qry, mi, mf, mat, msize, tot, padlen, off, flen, marker, maxaln,
        paths, tail, tb, ftr, seg);
  st = cudaGetLastError();
  if (st != cudaSuccess)
    return ffi::Error::Internal(std::string("talco: launch: ") +
                                cudaGetErrorString(st));
  return ffi::Error::Success();
}

ffi::Error TalcoXdropImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> ref,
                          ffi::Buffer<ffi::F32> qry,
                          ffi::Buffer<ffi::S32> meta_i,
                          ffi::Buffer<ffi::F32> meta_f,
                          ffi::Buffer<ffi::F32> matrix,
                          ffi::ResultBuffer<ffi::S8> paths,
                          ffi::ResultBuffer<ffi::S32> tail,
                          ffi::ResultBuffer<ffi::S8> tb,
                          ffi::ResultBuffer<ffi::S32> ftr,
                          ffi::ResultBuffer<ffi::S8> seg, int32_t padlen,
                          int32_t off, int32_t flen, int32_t marker,
                          int32_t threads) {
  auto rd = ref.dimensions();
  if (rd.size() != 3)
    return ffi::Error::InvalidArgument("talco: ref must be [B, TOT, P8]");
  const int batch = static_cast<int>(rd[0]);
  const int tot = static_cast<int>(rd[1]);
  const int p8 = static_cast<int>(rd[2]);
  const int msize = static_cast<int>(matrix.dimensions()[0]);
  const int maxaln = static_cast<int>(paths->dimensions()[1]);
  if (threads <= 0 || threads % 32 != 0 || threads > 1024)
    return ffi::Error::InvalidArgument("talco: threads must be a multiple of 32");
  if (off + padlen > tot)
    return ffi::Error::InvalidArgument("talco: off + padlen exceeds TOT");
  if (p8 == 8)
    return Launch<6>(stream, ref.typed_data(), qry.typed_data(),
                     meta_i.typed_data(), meta_f.typed_data(),
                     matrix.typed_data(), msize, batch, tot, padlen, off, flen,
                     marker, maxaln, threads, paths->typed_data(),
                     tail->typed_data(), tb->typed_data(), ftr->typed_data(),
                     seg->typed_data());
  if (p8 == 24)
    return Launch<22>(stream, ref.typed_data(), qry.typed_data(),
                      meta_i.typed_data(), meta_f.typed_data(),
                      matrix.typed_data(), msize, batch, tot, padlen, off,
                      flen, marker, maxaln, threads, paths->typed_data(),
                      tail->typed_data(), tb->typed_data(), ftr->typed_data(),
                      seg->typed_data());
  return ffi::Error::InvalidArgument("talco: P8 must be 8 or 24");
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(TalcoXdrop, TalcoXdropImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // ref
                                  .Arg<ffi::Buffer<ffi::F32>>()  // qry
                                  .Arg<ffi::Buffer<ffi::S32>>()  // meta_i
                                  .Arg<ffi::Buffer<ffi::F32>>()  // meta_f
                                  .Arg<ffi::Buffer<ffi::F32>>()  // matrix
                                  .Ret<ffi::Buffer<ffi::S8>>()   // paths
                                  .Ret<ffi::Buffer<ffi::S32>>()  // tail
                                  .Ret<ffi::Buffer<ffi::S8>>()   // tb
                                  .Ret<ffi::Buffer<ffi::S32>>()  // ftr
                                  .Ret<ffi::Buffer<ffi::S8>>()   // seg
                                  .Attr<int32_t>("padlen")
                                  .Attr<int32_t>("off")
                                  .Attr<int32_t>("flen")
                                  .Attr<int32_t>("marker")
                                  .Attr<int32_t>("threads"));

extern "C" size_t TalcoSharedBytes(int flen, int msize, int threads) {
  return SharedBytes(flen, msize, threads);
}
