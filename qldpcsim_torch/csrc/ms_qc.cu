// Message passing over a circulant-lifted H (kernel B of qldpcsim_torch):
// normalized min-sum (kind MS) and tanh-product sum-product (kind BP).
//
// Replaces the TPU kernel qldpcsim_tpu/ops/ms_qc_pallas.py::_make_kernel
// (kinds "MS" and "BP", built by make_qc_decoder): the whole iteration loop
// of one decode in one launch, schedules F (one snapshot pass over all
// block-rows) and block-row-grouped L, one syndrome check per iteration or
// (check_every "layer", more than one group) one after every layer group,
// converged shots frozen, posterior out. It computes what that kernel
// computes, in the same float32 order of operations (see ops/ms_qc_cuda.py);
// built with -fmad=false so that `mag - 2 * (neg * mag)` and `post + delta`
// are never contracted into FMAs. Kind BP calls the CUDA math library's
// tanhf and logf and divides with IEEE division (no fast math), as PyTorch's
// tanh, log and `/` do on the card, so it can equal its plain version.
//
// Design: a shot's whole state in shared memory, the check rows of a layer
// group side by side. Per shot the posterior (n), the messages c2v (S * L),
// the syndrome signs (m), for groups that need a snapshot the deltas of the
// largest such group, and for the per-layer check the mismatch bits (m bits
// in 32-bit words) are loaded once and the posterior is written back once;
// the shift, group and column tables sit in shared memory once per block.
// The rows of a block-row meet disjoint variables, and the block-rows of a
// group without a snapshot meet disjoint variable blocks, so every check
// row of such a group reads and writes its own variables, and one barrier
// separates a group from the next. A group with a snapshot (flooding, or
// block-rows that share a variable block) runs in two phases: every row
// computes its new messages from the posterior as it stands (nothing writes
// it before the barrier, so it is the snapshot) and keeps the deltas; then
// every variable gets a thread that adds its deltas one by one in ascending
// slot order, each `post + delta` rounded, which is this kernel's
// association (kernel F sums the deltas first). No float atomics.
//
// Two mappings of a group's rows onto threads, chosen by the wrapper from
// the tables when the decoder is built (EDGE, a template parameter):
//  - a thread per check row, slot by slot in registers: the left fold of
//    the reference as it stands. Best where a group has hundreds of rows
//    (flooding: 240 rows on lp118_0 fill 256 threads in one pass).
//  - a thread per edge, the 8 (or 32) lanes of a check row side by side.
//    MS's min/min2 is a selection (`a < m1`, `a == m1 ? m2 : m1` compare
//    values) and its parity a count of small integers, so a butterfly of
//    shuffles over the row's lanes gives the fold's bits; BP's running
//    `prod = sign_floor(prod * t, 1e-30)` rounds at every step, so each
//    lane takes its own tanhf, logf and divisions and repeats the left fold
//    in slot order from the row's t values (shuffles). Best where a group
//    is small (a layered schedule: 16 or 32 rows, 128 or 256 edges on
//    lp118_0), because it divides the chain of dependent instructions that
//    a lone shot's iteration consists of by the row's degree.
// Threads per shot: a block per shot, barriers by __syncthreads and votes
// by __syncthreads_or. The wrapper takes a thread per edge when the largest
// group's edges fit two passes of 256 threads and else a thread per row, and
// as many threads as that group has edges or rows, in whole warps, up to
// 256.
// Measured on an H100 SXM (700 W) by chip_smoke.py on lp118_0, ms, mapping
// / threads per shot (PERF.md has the table; "row/32" was a warp per shot
// with several shots in a block, a third mode that was timed and dropped):
// MS-L, the cascade's head (4,096 shots, 4 iterations) row/32 0.17,
// edge/128 0.18, edge/256 0.21; its last stage (128 shots, 50 iterations)
// row/32 0.79, row/256 0.68, edge/128 0.37, edge/256 0.31; a lone shot per
// iteration 15.8 us row/32, 6.0 us edge/256. MS-F (4,096 shots, 50
// iterations) row/256 0.47, edge/256 0.67. The last stage decides a chunk
// (the launch lasts as long as its slowest shot), hence edge/256 under L; a
// warp per shot filled the card best at 4,096 shots but left a lone shot's
// chain at its longest, and nothing but the head of a cascade gains by it.
//
// The per-layer check (TRACK, a template parameter: as a run-time branch it
// cost the flagship 12-17 %): the mismatch bits mis = H e XOR syn start as
// the syndrome (the all-positive prior gives e = 0); the thread that flips a
// variable's sign toggles the bits of that variable's check rows through
// the column view (atomicXor on a word: integer, so order does not matter);
// after each group the shot latches it + 1 and leaves when no bit is set.
// The per-iteration check takes every row's parity from the posterior signs.
//
// A code whose per-shot state does not fit a block's 232,448 bytes runs the
// same thread mapping with the state in device memory (GMEM, a template
// parameter chosen by the wrapper from the tables when the decoder is
// built; shot-major scratch, so a shot's threads touch neighbouring words).
//
// Two variants of the reference's kernel (semantics in ops/ms_qc_cuda.py):
//  - bf16 state (BF16, a template parameter; QLDPC_QC_DTYPE=bf16): the
//    posterior, the messages and the snapshot deltas are stored as
//    __nv_bfloat16, rounded to nearest even where stored and read back as
//    float32; all arithmetic stays float32 (a message's delta is the stored
//    message minus the old one; a posterior word is rounded once after its
//    update, under a snapshot after its deltas are summed in float32). The
//    syndrome signs and mismatch bits stay as they are. A shot's state
//    falls from 4 (n + E + D L + m) bytes to 2 (n + E + D L) + 4 m, so more
//    shots share an SM and a code whose float32 state needs device memory
//    may fit a block.
//  - the stacked-update writeback (VEC, a template parameter instantiated
//    for MS without TRACK only; QLDPC_QC_VEC=1): delta = fma(coef * sign,
//    mag, -R) rounded once, the stored message R + delta instead of the
//    extrinsic, the posterior += delta, in every lane of either mapping.
//    As a run-time branch at the writeback it cost the default kernel 4 %
//    under F (a thread per check row; chip_compare.py, PERF.md), hence the
//    template.
//
// What bounds it on an H100: operations, not bytes (a shot reads m floats
// and writes n: ~3 KB against 1,920 edges x 15 (MS) or 71 (BP) operations
// per iteration), and within a shot the chain of dependent layer groups (11
// barriers per iteration on the flagship's side X where one thread used to
// walk 1,920 edges), each about a microsecond for a lone warp whose
// dependent instructions nothing hides. No tensor cores (wgmma) and no TMA:
// compare, select and transcendental work on state that never leaves the
// SM. Left for later: both sides in one launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;  // +inf stand-in of the reference's min
constexpr int kMS = 0;         // kinds, in the order of ms_qc_cuda.KINDS
constexpr int kBP = 1;
constexpr int kMaxSmem = 232448;  // shared memory a block can use (227 KB)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sign_floor(float x, float floor_abs) {
  // (x < 0 ? -1 : 1) * max(|x|, floor_abs), as the reference writes it
  return (x < 0.0f ? -1.0f : 1.0f) * fmaxf(fabsf(x), floor_abs);
}

// The carried state's storage: float32, or bf16 rounded to nearest even
// (the same helper as kernel F's, csrc/flood_qc.cu).
template <bool BF16>
struct State {
  using T = float;
  static __device__ __forceinline__ float ld(const T* p) { return *p; }
  static __device__ __forceinline__ void st(T* p, float x) { *p = x; }
  static __device__ __forceinline__ float rnd(float x) { return x; }
};
template <>
struct State<true> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float ld(const T* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void st(T* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

struct Args {
  const float* syn;       // element (row, shot) at row * syn_rs + shot * syn_bs
  long long syn_rs, syn_bs;
  int B;
  float lch, beta, clamp;
  int max_iter, L, m_b, n_b, n_groups, n_slots;
  int delta_slots;        // slots of the largest group with a snapshot
  const int *row_ptr, *slot_j, *slot_s, *slot_row, *group_ptr, *group_snap;
  const int *col_ptr, *col_k;
  float* state;           // GMEM: (B, words per shot) scratch, else unused
  float* post;            // (B, n) out
  int* n_iter;            // (B,) out
  uint8_t* conv;          // (B,) out
};

__host__ __device__ inline int table_words(int m_b, int n_b, int n_groups,
                                           int n_slots) {
  return (m_b + 1) + 4 * n_slots + (2 * n_groups + 1) + (n_b + 1);
}

// the carried state (posterior, messages, snapshot deltas: 2 or 4 bytes a
// value) in 32-bit words, padded
__host__ __device__ inline int carried_words(int L, int n_b, int n_slots,
                                             int delta_slots, bool bf16) {
  return ((n_b + n_slots + delta_slots) * L * (bf16 ? 2 : 4) + 3) / 4;
}

__host__ __device__ inline int state_words(int L, int m_b, int n_b,
                                           int n_slots, int delta_slots,
                                           bool track, bool bf16) {
  return carried_words(L, n_b, n_slots, delta_slots, bf16) + m_b * L +
         (track ? (m_b * L + 31) / 32 : 0);
}

// TRACK: the check after every layer group; GMEM: the shots' state in
// device memory instead of shared memory; EDGE: a thread per edge (MAXD
// lanes side by side per check row) instead of a thread per check row;
// BF16: the carried state in bf16; VEC: the stacked-update writeback (MS,
// no TRACK).
template <int KIND, int MAXD, bool TRACK, bool GMEM, bool EDGE, bool BF16,
          bool VEC>
__global__ void ms_qc_kernel(const Args a) {
  static_assert(!VEC || (KIND == kMS && !TRACK), "VEC: MS, no TRACK");
  using Q = State<BF16>;
  using ST = typename Q::T;
  extern __shared__ int smem[];
  const int L = a.L, m_b = a.m_b, n_b = a.n_b, S = a.n_slots;
  const int G = a.n_groups;
  int* row_ptr = smem;                    // m_b + 1
  int* slot_j = row_ptr + (m_b + 1);      // S
  int* slot_s = slot_j + S;               // S
  int* slot_row = slot_s + S;             // S: block-row of a slot
  int* group_ptr = slot_row + S;          // G + 1
  int* group_snap = group_ptr + (G + 1);  // G
  int* col_ptr = group_snap + G;          // n_b + 1
  int* col_k = col_ptr + (n_b + 1);       // S: slots of a block, ascending
  const int nt = blockDim.x;
  for (int q = threadIdx.x; q <= m_b; q += nt) row_ptr[q] = a.row_ptr[q];
  for (int q = threadIdx.x; q < S; q += nt) {
    slot_j[q] = a.slot_j[q];
    slot_s[q] = a.slot_s[q];
    slot_row[q] = a.slot_row[q];
    col_k[q] = a.col_k[q];
  }
  for (int q = threadIdx.x; q <= G; q += nt) group_ptr[q] = a.group_ptr[q];
  for (int q = threadIdx.x; q < G; q += nt) group_snap[q] = a.group_snap[q];
  for (int q = threadIdx.x; q <= n_b; q += nt) col_ptr[q] = a.col_ptr[q];
  __syncthreads();

  const int T = blockDim.x;        // threads of this shot
  const int t = threadIdx.x;
  const long long shot = blockIdx.x;

  const int n = n_b * L, m = m_b * L, E = S * L;
  const int nw = (m + 31) / 32;
  const int words =
      state_words(L, m_b, n_b, S, a.delta_slots, TRACK, BF16);
  float* st = GMEM ? a.state + shot * words
                   : (float*)(smem + table_words(m_b, n_b, G, S));
  ST* post = (ST*)st;                       // n
  ST* c2v = post + n;                       // E: slot k, check row r at k*L+r
  ST* dbuf = c2v + E;                       // delta_slots * L
  float* ssign =                            // m: 1 - 2 syndrome
      st + carried_words(L, n_b, S, a.delta_slots, BF16);
  uint32_t* mis = (uint32_t*)(ssign + m);   // nw, TRACK only

  for (int v = t; v < n; v += T) Q::st(post + v, a.lch);
  for (int e = t; e < E; e += T) Q::st(c2v + e, 0.0f);
  for (int row = t; row < m; row += T)
    ssign[row] = 1.0f - 2.0f * a.syn[row * a.syn_rs + shot * a.syn_bs];
  if constexpr (TRACK) {
    for (int w = t; w < nw; w += T) mis[w] = 0u;
    __syncthreads();
    for (int row = t; row < m; row += T)
      if (ssign[row] < 0.0f) atomicOr(&mis[row >> 5], 1u << (row & 31));
  }
  __syncthreads();

  // toggle the mismatch bits of the check rows that meet variable j*L + vr
  auto toggle = [&](int j, int vr) {
    for (int c = col_ptr[j]; c < col_ptr[j + 1]; ++c) {
      const int k = col_k[c];
      int rr = vr - slot_s[k];
      if (rr < 0) rr += L;
      const int row = slot_row[k] * L + rr;
      atomicXor(&mis[row >> 5], 1u << (row & 31));
    }
  };

  int it_lat = a.max_iter;
  bool done = false;
  for (int it = 0; it < a.max_iter && !done; ++it) {
    for (int g = 0; g < G; ++g) {
      const int i0 = group_ptr[g], i1 = group_ptr[g + 1];
      const int rows_g = (i1 - i0) * L;
      const int kg0 = row_ptr[i0];
      const bool snap = group_snap[g] != 0;
      if constexpr (EDGE) {
        // one edge per thread, the MAXD lanes of a check row side by side:
        // MS's min/min2 is a selection and its parity a count, so a
        // butterfly over the lanes gives the fold's bits; BP's clamped
        // running product rounds at every step, so every lane repeats the
        // left fold in slot order from the row's t values. The trip count
        // is the same for all threads of the shot: the shuffles need the
        // whole warp.
        const int lane = threadIdx.x & 31;
        const int d = lane & (MAXD - 1);
        const int seg = lane - d;  // first lane of this row's edges
        for (int q0 = 0; q0 < rows_g; q0 += T / MAXD) {
          const int q = q0 + t / MAXD;
          int r = 0, k0 = 0, deg = 0, row = 0;
          if (q < rows_g) {
            const int di = q / L;
            r = q - di * L;
            row = (i0 + di) * L + r;
            k0 = row_ptr[i0 + di];
            deg = row_ptr[i0 + di + 1] - k0;
          }
          const bool on = d < deg;
          int vi = 0;
          float rowv = 0.0f, v = 0.0f;
          if (on) {
            int rs = r + slot_s[k0 + d];
            if (rs >= L) rs -= L;
            vi = slot_j[k0 + d] * L + rs;
            rowv = Q::ld(c2v + (k0 + d) * L + r);
            v = Q::ld(post + vi) - rowv;
          }
          float nv = 0.0f, delta = 0.0f;
          if constexpr (KIND == kMS) {
            const float av = on ? fabsf(v) : kBig;
            const bool neg = on && v < 0.0f;
            float m1 = av, m2 = kBig;
#pragma unroll
            for (int off = MAXD / 2; off > 0; off >>= 1) {
              const float b1 = __shfl_xor_sync(kFull, m1, off);
              const float b2 = __shfl_xor_sync(kFull, m2, off);
              m2 = fminf(fmaxf(m1, b1), fminf(m2, b2));
              m1 = fminf(m1, b1);
            }
            unsigned negs = __ballot_sync(kFull, neg);
            if constexpr (MAXD < 32) negs = (negs >> seg) & ((1u << MAXD) - 1u);
            if (on) {
              const float neg_par = (float)__popc(negs);
              if (m1 >= kBig) m1 = 0.0f;
              if (m2 >= kBig) m2 = 0.0f;
              const float par = neg_par - 2.0f * floorf(neg_par * 0.5f);
              const float coef = (a.beta * ssign[row]) * (1.0f - 2.0f * par);
              const float mag = (av == m1) ? m2 : m1;
              const float negf = neg ? 1.0f : 0.0f;
              if constexpr (VEC) {
                delta = __fmaf_rn(coef * (1.0f - 2.0f * negf), mag, -rowv);
                nv = Q::rnd(rowv + delta);
              } else {
                nv = Q::rnd(coef * (mag - 2.0f * (negf * mag)));
                delta = nv - rowv;
              }
            }
          } else {
            const float tt = on ? sign_floor(tanhf(v * 0.5f), 1e-12f) : 1.0f;
            float prod = 1.0f;
#pragma unroll
            for (int dd = 0; dd < MAXD; ++dd) {
              const float td = __shfl_sync(kFull, tt, seg + dd);
              if (dd < deg) prod = sign_floor(prod * td, 1e-30f);
            }
            if (on) {
              const float th2 = fminf(fmaxf(prod / tt, -a.clamp), a.clamp);
              nv = Q::rnd(ssign[row] * logf((1.0f + th2) / (1.0f - th2)));
              delta = nv - rowv;
            }
          }
          if (on) {
            Q::st(c2v + (k0 + d) * L + r, nv);
            if (snap) {
              Q::st(dbuf + (k0 + d - kg0) * L + r, delta);
            } else {
              const float pold = Q::ld(post + vi);
              const float pnew = Q::rnd(pold + delta);
              Q::st(post + vi, pnew);
              if constexpr (TRACK) {
                if ((pold < 0.0f) != (pnew < 0.0f)) {
                  const int j = slot_j[k0 + d];
                  toggle(j, vi - j * L);
                }
              }
            }
          }
        }
      } else {
        // one check row per thread; a group's rows write disjoint variables
        // (no snapshot) or only their own messages and deltas (snapshot)
        for (int q = t; q < rows_g; q += T) {
          const int di = q / L;
          const int i = i0 + di, r = q - di * L;
          const int k0 = row_ptr[i];
          const int deg = row_ptr[i + 1] - k0;
          const float ss = ssign[i * L + r];
          // pass 1, slot by slot: MS keeps |v|, sign and the running
          // min/min2/parity; BP keeps the floored tanh and the running
          // clamped product
          float av[MAXD], rowv[MAXD];
          bool neg[MAXD];
          int vi[MAXD];
          float m1 = kBig, m2 = kBig, neg_par = 0.0f, prod = 1.0f;
#pragma unroll
          for (int d = 0; d < MAXD; ++d) {
            if (d < deg) {
              int rs = r + slot_s[k0 + d];
              if (rs >= L) rs -= L;
              vi[d] = slot_j[k0 + d] * L + rs;
              rowv[d] = Q::ld(c2v + (k0 + d) * L + r);
              const float v = Q::ld(post + vi[d]) - rowv[d];
              if constexpr (KIND == kMS) {
                av[d] = fabsf(v);
                neg[d] = v < 0.0f;
                neg_par = neg_par + (neg[d] ? 1.0f : 0.0f);
                const bool is_new = av[d] < m1;
                m2 = is_new ? m1 : fminf(m2, av[d]);
                m1 = is_new ? av[d] : m1;
              } else {
                av[d] = sign_floor(tanhf(v * 0.5f), 1e-12f);  // t per slot
                prod = sign_floor(prod * av[d], 1e-30f);
              }
            }
          }
          float coef = 0.0f;
          if constexpr (KIND == kMS) {
            if (m1 >= kBig) m1 = 0.0f;
            if (m2 >= kBig) m2 = 0.0f;
            const float par = neg_par - 2.0f * floorf(neg_par * 0.5f);
            coef = (a.beta * ss) * (1.0f - 2.0f * par);
          }
          // pass 2: extrinsic messages and write-back
#pragma unroll
          for (int d = 0; d < MAXD; ++d) {
            if (d < deg) {
              float nv, delta;
              if constexpr (KIND == kMS) {
                const float mag = (av[d] == m1) ? m2 : m1;
                const float negf = neg[d] ? 1.0f : 0.0f;
                if constexpr (VEC) {
                  delta =
                      __fmaf_rn(coef * (1.0f - 2.0f * negf), mag, -rowv[d]);
                  nv = Q::rnd(rowv[d] + delta);
                } else {
                  nv = Q::rnd(coef * (mag - 2.0f * (negf * mag)));
                  delta = nv - rowv[d];
                }
              } else {
                const float th2 = fminf(fmaxf(prod / av[d], -a.clamp), a.clamp);
                nv = Q::rnd(ss * logf((1.0f + th2) / (1.0f - th2)));
                delta = nv - rowv[d];
              }
              Q::st(c2v + (k0 + d) * L + r, nv);
              if (snap) {
                Q::st(dbuf + (k0 + d - kg0) * L + r, delta);
              } else {
                const float pold = Q::ld(post + vi[d]);
                const float pnew = Q::rnd(pold + delta);
                Q::st(post + vi[d], pnew);
                if constexpr (TRACK) {
                  if ((pold < 0.0f) != (pnew < 0.0f)) {
                    const int j = slot_j[k0 + d];
                    toggle(j, vi[d] - j * L);
                  }
                }
              }
            }
          }
        }
      }
      __syncthreads();
      if (snap) {
        // one variable per thread: the group's deltas added one by one in
        // ascending slot order, each float32 sum rounded, the posterior word
        // stored once
        for (int v = t; v < n; v += T) {
          const int j = v / L, vr = v - j * L;
          const float pold = Q::ld(post + v);
          float pv = pold;
          for (int c = col_ptr[j]; c < col_ptr[j + 1]; ++c) {
            const int k = col_k[c];
            const int i = slot_row[k];
            if (i >= i0 && i < i1) {
              int rr = vr - slot_s[k];
              if (rr < 0) rr += L;
              pv = pv + Q::ld(dbuf + (k - kg0) * L + rr);
            }
          }
          pv = Q::rnd(pv);
          Q::st(post + v, pv);
          if constexpr (TRACK) {
            // flips of the single adds cancel in pairs: the net flip counts
            if ((pold < 0.0f) != (pv < 0.0f)) toggle(j, vr);
          }
        }
        __syncthreads();
      }
      if constexpr (TRACK) {
        uint32_t nz = 0u;
        for (int w = t; w < nw; w += T) nz |= mis[w];
        if (!__syncthreads_or(nz != 0u)) {  // the check after the layer group
          it_lat = it + 1;
          done = true;
          break;
        }
      }
    }
    if constexpr (!TRACK) {
      // one syndrome check per iteration: H (posterior < 0) == syn (mod 2)
      bool bad = false;
      for (int row = t; row < m; row += T) {
        const int i = row / L, r = row - i * L;
        int parity = 0;
        for (int k = row_ptr[i]; k < row_ptr[i + 1]; ++k) {
          int rs = r + slot_s[k];
          if (rs >= L) rs -= L;
          parity ^= Q::ld(post + slot_j[k] * L + rs) < 0.0f;
        }
        bad |= parity != (ssign[row] < 0.0f);
      }
      if (!__syncthreads_or(bad)) {
        it_lat = it + 1;
        done = true;
      }
    }
  }
  for (int v = t; v < n; v += T) a.post[shot * n + v] = Q::ld(post + v);
  if (t == 0) {
    a.n_iter[shot] = it_lat;
    a.conv[shot] = done ? 1 : 0;
  }
}

// Launches the kernel; or, with `occ`, writes the blocks of this launch that
// one SM can hold (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
// launches nothing.
template <int KIND, int MAXD, bool TRACK, bool GMEM, bool EDGE, bool BF16,
          bool VEC>
cudaError_t launch(const Args& a, int threads, cudaStream_t stream,
                   int* occ) {
  const size_t shmem =
      sizeof(int) *
      ((size_t)table_words(a.m_b, a.n_b, a.n_groups, a.n_slots) +
       (GMEM ? 0
             : (size_t)state_words(a.L, a.m_b, a.n_b, a.n_slots,
                                   a.delta_slots, TRACK, BF16)));
  if (shmem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = ms_qc_kernel<KIND, MAXD, TRACK, GMEM, EDGE, BF16, VEC>;
  if (shmem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (rc != cudaSuccess) return rc;
  }
  if (occ)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kernel, threads,
                                                         shmem);
  kernel<<<a.B, threads, shmem, stream>>>(a);
  return cudaGetLastError();
}

// The run-time choices (mapping, dtype, writeback) -> a template instance;
// VEC exists for MS without TRACK only.
struct Choice {
  bool edge, bf16, vec;
  int threads;
  cudaStream_t stream;
  int* occ;
};

template <int KIND, int MAXD, bool TRACK, bool GMEM, bool BF16, bool VEC>
cudaError_t dispatch3(const Args& a, const Choice& c) {
  return c.edge ? launch<KIND, MAXD, TRACK, GMEM, true, BF16, VEC>(
                      a, c.threads, c.stream, c.occ)
                : launch<KIND, MAXD, TRACK, GMEM, false, BF16, VEC>(
                      a, c.threads, c.stream, c.occ);
}

template <int KIND, int MAXD, bool TRACK, bool GMEM, bool BF16>
cudaError_t dispatch2v(const Args& a, const Choice& c) {
  if constexpr (KIND == kMS && !TRACK)
    if (c.vec) return dispatch3<KIND, MAXD, TRACK, GMEM, BF16, true>(a, c);
  return dispatch3<KIND, MAXD, TRACK, GMEM, BF16, false>(a, c);
}

template <int KIND, int MAXD, bool TRACK, bool GMEM>
cudaError_t dispatch2(const Args& a, const Choice& c) {
  return c.bf16 ? dispatch2v<KIND, MAXD, TRACK, GMEM, true>(a, c)
                : dispatch2v<KIND, MAXD, TRACK, GMEM, false>(a, c);
}

template <int KIND, int MAXD>
cudaError_t dispatch(const Args& a, bool track, bool gmem, const Choice& c) {
  if (track)
    return gmem ? dispatch2<KIND, MAXD, true, true>(a, c)
                : dispatch2<KIND, MAXD, true, false>(a, c);
  return gmem ? dispatch2<KIND, MAXD, false, true>(a, c)
              : dispatch2<KIND, MAXD, false, false>(a, c);
}

}  // namespace

extern "C" {

const char* ms_qc_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

// kind: 0 = MS, 1 = BP; beta: the MS normalization; clamp: BP's 1 - eps as
// float32. syn: float32 0/1, element (row, shot) at row * syn_rs + shot *
// syn_bs, m = m_b * L rows; tables as in convert.QCTables (int32, on the
// device), n_slots = row_ptr[m_b], max_deg the largest block-row degree (at
// most 32), slot_row (n_slots,) the block-row of each slot, col_ptr (n_b +
// 1,) and col_k (n_slots,) QCTables.col_slots(); delta_slots: the slots of
// the largest group with a snapshot (0 when there is none). track: 1 for
// the check after every layer group, 0 for one check per iteration.
// per_edge: 1 for a thread per edge, 0 for a thread per check row.
// threads: the threads of a shot's block, a multiple of 32 up to 1024.
// bf16: 1 for the carried state in bf16, 0 for float32. vec: 1 for the
// stacked-update writeback (kind MS, track 0; ignored otherwise).
// state: null for the shots' state in shared memory, or (B, words) float32
// scratch in device memory, words = ceil((n + (n_slots + delta_slots) * L)
// * (bf16 ? 2 : 4) / 4) + m + (track ? ceil(m / 32) : 0). post: (B, n)
// posterior out, shot-major; n_iter: (B,) int32 out; conv: (B,) uint8 out.
// Launches on `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a degree, a thread count or a state size it
// cannot run). With `blocks_per_sm` not
// null it launches nothing and writes there (int) how many blocks of this
// launch one SM can hold; the data pointers are then not read.
int ms_qc_decode(const void* syn, long long syn_rs, long long syn_bs, int B,
                 int kind, float lch, float beta, float clamp, int max_iter,
                 int L, int m_b, int n_b, int n_groups, int max_deg,
                 int n_slots, int delta_slots, int track, int per_edge,
                 int threads, int bf16, int vec, const void* row_ptr,
                 const void* slot_j, const void* slot_s, const void* slot_row,
                 const void* group_ptr, const void* group_snap,
                 const void* col_ptr, const void* col_k, void* state,
                 void* post, void* n_iter, void* conv, void* stream,
                 void* blocks_per_sm) {
  if (B <= 0) return 0;
  if (threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.syn = (const float*)syn;
  a.syn_rs = syn_rs;
  a.syn_bs = syn_bs;
  a.B = B;
  a.lch = lch;
  a.beta = beta;
  a.clamp = clamp;
  a.max_iter = max_iter;
  a.L = L;
  a.m_b = m_b;
  a.n_b = n_b;
  a.n_groups = n_groups;
  a.n_slots = n_slots;
  a.delta_slots = delta_slots;
  a.row_ptr = (const int*)row_ptr;
  a.slot_j = (const int*)slot_j;
  a.slot_s = (const int*)slot_s;
  a.slot_row = (const int*)slot_row;
  a.group_ptr = (const int*)group_ptr;
  a.group_snap = (const int*)group_snap;
  a.col_ptr = (const int*)col_ptr;
  a.col_k = (const int*)col_k;
  a.state = (float*)state;
  a.post = (float*)post;
  a.n_iter = (int*)n_iter;
  a.conv = (uint8_t*)conv;
  const bool gmem = state != nullptr;
  int* occ = (int*)blocks_per_sm;
  cudaStream_t s = (cudaStream_t)stream;
  const Choice c{per_edge != 0, bf16 != 0, vec != 0, threads, s, occ};
  if (kind == kMS) {
    if (max_deg <= 8) return (int)dispatch<kMS, 8>(a, track, gmem, c);
    if (max_deg <= 32) return (int)dispatch<kMS, 32>(a, track, gmem, c);
  } else if (kind == kBP) {
    if (max_deg <= 8) return (int)dispatch<kBP, 8>(a, track, gmem, c);
    if (max_deg <= 32) return (int)dispatch<kBP, 32>(a, track, gmem, c);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
