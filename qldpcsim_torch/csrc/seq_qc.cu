// Serial (row-sequential) message passing over a circulant-lifted H (kernel D
// of qldpcsim_torch): normalized min-sum (kind MS) and tanh-product
// sum-product (kind BP), one check row per layer in natural row order, with
// the syndrome estimate kept up to date after every row.
//
// Replaces the TPU kernel qldpcsim_tpu/ops/seq_qc_pallas.py::_make_kernel
// (kinds "MS" and "BP", built by make_seq_qc_decoder): the whole decode of
// the reference simulator's serial schedule in one launch. It computes what
// that kernel computes, in the same float32 order of operations (see
// ops/seq_qc_cuda.py): `new - old` is one explicit fmaf, as the reference's
// compiled form contracts it, and the build's -fmad=false keeps every other
// multiply and add apart. Kind BP calls the CUDA math
// library's tanhf and logf and divides with IEEE division (no fast math), as
// PyTorch's tanh, log and `/` do on the card, so it can equal its plain
// version.
//
// Design: a warp per shot, the shot's state in shared memory, the L rows of
// a block-row side by side. The schedule tests the mismatch weight W after
// every check row, but a lifted H has one shift per (block-row, variable
// block), so the L rows of a block-row meet disjoint variables and own
// their messages: their float updates do not depend on each other, and
// only the latch needs the row order. Per block-row (in chunks of 32 rows
// when L > 32) each lane takes one check row, reads its d posteriors and
// messages from shared memory and computes delta = fmaf(a, b, -old) and the
// sign flips of the new posteriors into registers. W moves only where a
// posterior changes sign, so the warp ballots the lanes whose row flips a
// sign: with none, W stays as it is (non-zero, or the shot would have
// latched before) and all rows are committed at once; with W above the
// number of toggles these rows can make, no row can bring it to zero, so
// all flipping lanes toggle at once (integer atomics, order-free) and all
// rows are committed; else (a shot close to convergence) the flipping
// rows are walked in ascending order, the walked lane toggles the mismatch
// bytes of the check rows that meet its flipped variables (the reference's
// |se - syn|, W moving by +-1 with each toggle), and if W == 0 after row r*
// the shot latches it + 1 there: rows 0..r* are committed, the rows above
// r*, still in registers, are dropped, which is the reference's "frozen
// from the next row on", and the warp writes the posterior out and leaves.
// A zero syndrome has W == 0 before any update and the test follows the
// update, so row 0 alone is walked and committed (n_iter == 1).
// Per shot the posterior (n), the messages c2v (S * L) and two bytes per
// check row (syndrome, mismatch) live in shared memory: 11 KB on lp118_0,
// 20 KB on the Tanner code, so an SM holds 20 or 10 shots; several warps
// share a block and its tables. 15 dependent steps per iteration on the
// Tanner code where one thread used to walk 465 rows.
//
// A code whose per-shot state does not fit a block's 232,448 bytes runs the
// same mapping with the state in device memory (GMEM, a template parameter
// chosen by the wrapper from the tables when the decoder is built).
//
// What bounds it on an H100: operations, not bytes (a shot reads m floats
// and writes n), and within a shot the chain of m_b dependent block-rows
// per iteration plus one walked row per sign flip. No tensor cores and no
// TMA: compare, select and transcendental work on state that never leaves
// the SM. Left for later: a thread per edge for BP's tanhf and logf, both
// sides in one launch.

#include <cstdint>
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

struct Args {
  const float* syn;  // (m, B) float32 0/1
  int B;
  float lch, beta, clamp;
  int max_iter, L, m_b, n_b, n_slots, shots_per_block;
  const int *row_ptr, *slot_j, *slot_s, *col_ptr, *col_i, *col_s, *row_par;
  float* state;   // GMEM: (B, words per shot) scratch, else unused
  float* post;    // (B, n) out
  int* n_iter;    // (B,) out
  uint8_t* conv;  // (B,) out
};

__host__ __device__ inline int table_words(int m_b, int n_b, int n_slots) {
  return (m_b + 1) + m_b + (n_b + 1) + 4 * n_slots;
}

__host__ __device__ inline int state_words(int L, int m_b, int n_b,
                                           int n_slots) {
  return n_b * L + n_slots * L + 2 * ((m_b * L + 3) / 4);
}

template <int KIND, int MAXD, bool GMEM>
__global__ void seq_qc_kernel(const Args a) {
  extern __shared__ int smem[];
  const int L = a.L, m_b = a.m_b, n_b = a.n_b, S = a.n_slots;
  int* row_ptr = smem;                // m_b + 1
  int* row_par = row_ptr + (m_b + 1);  // m_b
  int* col_ptr = row_par + m_b;       // n_b + 1
  int* slot_j = col_ptr + (n_b + 1);  // S
  int* slot_s = slot_j + S;           // S
  int* col_i = slot_s + S;            // S
  int* col_s = col_i + S;             // S
  const int nt = blockDim.x;
  for (int q = threadIdx.x; q <= m_b; q += nt) row_ptr[q] = a.row_ptr[q];
  for (int q = threadIdx.x; q < m_b; q += nt) row_par[q] = a.row_par[q];
  for (int q = threadIdx.x; q <= n_b; q += nt) col_ptr[q] = a.col_ptr[q];
  for (int q = threadIdx.x; q < S; q += nt) {
    slot_j[q] = a.slot_j[q];
    slot_s[q] = a.slot_s[q];
    col_i[q] = a.col_i[q];
    col_s[q] = a.col_s[q];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, local = threadIdx.x >> 5;
  const long long shot = (long long)blockIdx.x * a.shots_per_block + local;
  if (shot >= a.B) return;  // a whole warp: no block barrier follows

  const int n = n_b * L, m = m_b * L, E = S * L;
  const int words = state_words(L, m_b, n_b, S);
  float* st = GMEM ? a.state + shot * words
                   : (float*)(smem + table_words(m_b, n_b, S)) +
                         (size_t)local * words;
  float* post = st;                      // n
  float* c2v = post + n;                 // E: slot k, check row r at k*L+r
  uint8_t* synb = (uint8_t*)(c2v + E);   // m: the syndrome bit
  uint8_t* mis = synb + 4 * ((m + 3) / 4);  // m: |se - syn| of the check row
  uint32_t* misw = (uint32_t*)mis;          // the same bytes, four to a word

  for (int v = lane; v < n; v += 32) post[v] = a.lch;
  for (int e = lane; e < E; e += 32) c2v[e] = 0.0f;
  // syndrome estimate of the all-equal start: row parity where L_ch < 0
  const int e0 = a.lch < 0.0f ? 1 : 0;
  int W = 0;
  for (int row = lane; row < m; row += 32) {
    const int s = a.syn[(size_t)row * a.B + shot] > 0.5f ? 1 : 0;
    const int mm = (row_par[row / L] & e0) ^ s;
    synb[row] = (uint8_t)s;
    mis[row] = (uint8_t)mm;
    W += mm;
  }
  W = __reduce_add_sync(kFull, W);
  __syncwarp();

  int it_lat = a.max_iter;
  bool done = false;
  for (int it = 0; it < a.max_iter && !done; ++it) {
    for (int i = 0; i < m_b && !done; ++i) {
      const int k0 = row_ptr[i];
      const int deg = row_ptr[i + 1] - k0;
      for (int c0 = 0; c0 < L && !done; c0 += 32) {
        const int r = c0 + lane;
        const bool active = r < L;
        // this lane's check row into registers: x keeps v (MS) or the
        // floored tanh (BP), then delta = new - old
        float pos[MAXD], old[MAXD], x[MAXD];
        int vi[MAXD];
        unsigned flips = 0u;  // bit d: slot d's posterior changes sign
        if (active) {
          const float ss = synb[i * L + r] ? -1.0f : 1.0f;
          float m1 = kBig, m2 = kBig, neg_par = 0.0f, prod = 1.0f;
#pragma unroll
          for (int d = 0; d < MAXD; ++d) {
            if (d < deg) {
              int rs = r + slot_s[k0 + d];
              if (rs >= L) rs -= L;
              vi[d] = slot_j[k0 + d] * L + rs;
              pos[d] = post[vi[d]];
              old[d] = c2v[(k0 + d) * L + r];
              const float v = pos[d] - old[d];
              if constexpr (KIND == kMS) {
                x[d] = v;
                const float av = fabsf(v);
                neg_par = neg_par + (v < 0.0f ? 1.0f : 0.0f);
                const bool is_new = av < m1;
                m2 = is_new ? m1 : fminf(m2, av);
                m1 = is_new ? av : m1;
              } else {
                x[d] = sign_floor(tanhf(v * 0.5f), 1e-12f);
                prod = sign_floor(prod * x[d], 1e-30f);
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
#pragma unroll
          for (int d = 0; d < MAXD; ++d) {
            if (d < deg) {
              float delta;  // new - old, the product of `new` fused in
              if constexpr (KIND == kMS) {
                const float sign = 1.0f - 2.0f * (x[d] < 0.0f ? 1.0f : 0.0f);
                const float mag = (fabsf(x[d]) == m1) ? m2 : m1;
                delta = fmaf(coef * sign, mag, -old[d]);
              } else {
                const float th2 =
                    fminf(fmaxf(prod / x[d], -a.clamp), a.clamp);
                delta = fmaf(ss, logf((1.0f + th2) / (1.0f - th2)), -old[d]);
              }
              x[d] = delta;
              if ((pos[d] < 0.0f) != (pos[d] + delta < 0.0f)) flips |= 1u << d;
            }
          }
        }
        // the latch keeps row order: walk the rows that move W
        unsigned walk = __ballot_sync(kFull, active && flips != 0u);
        if (W == 0) walk |= 1u;  // only before the first row of a decode
        int last = 31;           // lanes 0..last are committed
        if (walk) {
          // Each toggle moves W by +-1, so W stays above zero through all
          // of these rows when it exceeds their toggles: then no row can
          // latch, the order does not matter, and every flipping lane
          // toggles at once (atomicXor on the word that holds the byte;
          // the old bit says which way W moves).
          int ntog = 0;
          for (int d = 0; d < deg; ++d) {
            if (flips >> d & 1u) {
              const int j = slot_j[k0 + d];
              ntog += col_ptr[j + 1] - col_ptr[j];
            }
          }
          ntog = __reduce_add_sync(kFull, ntog);
          if (W > ntog) {
            int dW = 0;
            for (int d = 0; d < deg; ++d) {
              if (flips >> d & 1u) {
                const int j = slot_j[k0 + d];
                int vloc = r + slot_s[k0 + d];
                if (vloc >= L) vloc -= L;
                for (int k = col_ptr[j]; k < col_ptr[j + 1]; ++k) {
                  int cr = vloc - col_s[k];
                  if (cr < 0) cr += L;
                  const int c = col_i[k] * L + cr;
                  const unsigned bit = 1u << (8 * (c & 3));
                  dW += (atomicXor(&misw[c >> 2], bit) & bit) ? -1 : 1;
                }
              }
            }
            W += __reduce_add_sync(kFull, dW);
            walk = 0u;
          }
        }
        while (walk) {
          const int src = __ffs(walk) - 1;
          walk &= walk - 1;
          int dW = 0;
          if (lane == src) {
            for (int d = 0; d < deg; ++d) {
              if (flips >> d & 1u) {
                const int j = slot_j[k0 + d];
                int vloc = r + slot_s[k0 + d];
                if (vloc >= L) vloc -= L;
                for (int k = col_ptr[j]; k < col_ptr[j + 1]; ++k) {
                  int cr = vloc - col_s[k];
                  if (cr < 0) cr += L;
                  const int c = col_i[k] * L + cr;
                  const int mm = mis[c] ^ 1;
                  mis[c] = (uint8_t)mm;
                  dW += mm ? 1 : -1;
                }
              }
            }
          }
          __syncwarp();
          W += __shfl_sync(kFull, dW, src);
          if (W == 0) {  // latched at this row; frozen from the next row on
            last = src;
            it_lat = it + 1;
            done = true;
            break;
          }
        }
        if (active && lane <= last) {
#pragma unroll
          for (int d = 0; d < MAXD; ++d) {
            if (d < deg) {
              c2v[(k0 + d) * L + r] = old[d] + x[d];
              post[vi[d]] = pos[d] + x[d];
            }
          }
        }
        __syncwarp();
      }
    }
  }
  for (int v = lane; v < n; v += 32) a.post[shot * n + v] = post[v];
  if (lane == 0) {
    a.n_iter[shot] = it_lat;
    a.conv[shot] = done ? 1 : 0;
  }
}

template <int KIND, int MAXD, bool GMEM>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int spb = a.shots_per_block;
  const size_t shmem =
      sizeof(int) * ((size_t)table_words(a.m_b, a.n_b, a.n_slots) +
                     (GMEM ? 0
                           : (size_t)spb * state_words(a.L, a.m_b, a.n_b,
                                                       a.n_slots)));
  if (shmem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = seq_qc_kernel<KIND, MAXD, GMEM>;
  if (shmem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<(a.B + spb - 1) / spb, 32 * spb, shmem, stream>>>(a);
  return cudaGetLastError();
}

template <int KIND, int MAXD>
cudaError_t dispatch(const Args& a, bool gmem, cudaStream_t stream) {
  return gmem ? launch<KIND, MAXD, true>(a, stream)
              : launch<KIND, MAXD, false>(a, stream);
}

}  // namespace

extern "C" {

const char* seq_qc_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

// kind: 0 = MS, 1 = BP; beta: the MS normalization; clamp: BP's 1 - eps as
// float32. syn: (m, B) float32 0/1, m = m_b * L; tables as in
// convert.SeqQCTables (int32, on the device), n_slots = row_ptr[m_b],
// max_deg the largest block-row degree (at most 32); shots_per_block: the
// warps, one per shot, that share a block (1 to 32). state: null for the
// shots' state in shared memory, or (B, words) float32 scratch in device
// memory, words = n + n_slots * L + 2 * ceil(m / 4). post: (B, n)
// posterior out, shot-major; n_iter: (B,) int32 out; conv: (B,) uint8 out.
// Launches on `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a degree or a state size it cannot run).
int seq_qc_decode(const void* syn, int B, int kind, float lch, float beta,
                  float clamp, int max_iter, int L, int m_b, int n_b,
                  int max_deg, int n_slots, int shots_per_block,
                  const void* row_ptr, const void* slot_j, const void* slot_s,
                  const void* col_ptr, const void* col_i, const void* col_s,
                  const void* row_par, void* state, void* post, void* n_iter,
                  void* conv, void* stream) {
  if (B <= 0) return 0;
  if (shots_per_block < 1 || shots_per_block > 32)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.syn = (const float*)syn;
  a.B = B;
  a.lch = lch;
  a.beta = beta;
  a.clamp = clamp;
  a.max_iter = max_iter;
  a.L = L;
  a.m_b = m_b;
  a.n_b = n_b;
  a.n_slots = n_slots;
  a.shots_per_block = shots_per_block;
  a.row_ptr = (const int*)row_ptr;
  a.slot_j = (const int*)slot_j;
  a.slot_s = (const int*)slot_s;
  a.col_ptr = (const int*)col_ptr;
  a.col_i = (const int*)col_i;
  a.col_s = (const int*)col_s;
  a.row_par = (const int*)row_par;
  a.state = (float*)state;
  a.post = (float*)post;
  a.n_iter = (int*)n_iter;
  a.conv = (uint8_t*)conv;
  const bool gmem = state != nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == kMS) {
    if (max_deg <= 8) return (int)dispatch<kMS, 8>(a, gmem, s);
    if (max_deg <= 32) return (int)dispatch<kMS, 32>(a, gmem, s);
  } else if (kind == kBP) {
    if (max_deg <= 8) return (int)dispatch<kBP, 8>(a, gmem, s);
    if (max_deg <= 32) return (int)dispatch<kBP, 32>(a, gmem, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
