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
// Design: one thread per shot. The TPU kernel puts 128 shots on the lanes
// and masks the converged ones, because its compiler allows no per-lane
// exit; shots never interact, so here a thread runs its own loops and leaves
// them at the row where its shot latches (after that row's update: the test
// follows the update, so a zero syndrome still runs row 0). State lies in
// device memory in the reference's shot-minor layout, so a warp's loads and
// stores are coalesced: the posterior (n, B) is the output buffer itself,
// the messages c2v (S * L, B) and the syndrome mismatch (m, B) are scratch
// the caller keeps. The mismatch byte of a check row is the reference's
// |se - syn| (its float syndrome estimate against the syndrome): a variable
// whose posterior changes sign toggles the byte of every check row that
// meets it, and the mismatch weight W, an integer <= m, moves by +-1 with
// each toggle, exactly as the reference's float W does. Sign changes are
// rare after the first iterations, so that work sits behind a branch. The
// shift tables (a few hundred ints) sit in shared memory; (r + s) mod L and
// (v - s2) mod L are one conditional add or subtract, no division.
//
// What bounds it on an H100: latency, not bytes or operations (its bound,
// from either, is microseconds). One decode is m rows per iteration, each
// row a read of its slots' posterior and message words, a few dozen float
// operations and their write-back, and row r + 1 may read what row r wrote:
// m * max_iter dependent steps (13,950 on the Tanner code at 30 iterations),
// on B threads only (4,096 on a chunk: one warp per SM). Measured on an
// H100 SXM (700 W), Tanner code, kind MS: a lone thread takes 0.53 ms per
// iteration (its 19 KB of state stays in cache); with 4,096 threads alive
// an iteration takes about 2.7 ms, since the 78 MB of state exceed the
// 50 MB L2 and one warp per SM hides little of the device memory's latency;
// a launch lasts as long as its slowest shot (60 ms at 30 iterations).
// Kind BP: 1.02 ms per lone-thread iteration. Later designs: several
// threads per shot (the slots of a row, or rows of a block-row that share
// no variable), the state in shared memory, both sides in one launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;  // +inf stand-in of the reference's min
constexpr int kMS = 0;         // kinds, in the order of ms_qc_cuda.KINDS
constexpr int kBP = 1;

__device__ __forceinline__ float sign_floor(float x, float floor_abs) {
  // (x < 0 ? -1 : 1) * max(|x|, floor_abs), as the reference writes it
  return (x < 0.0f ? -1.0f : 1.0f) * fmaxf(fabsf(x), floor_abs);
}

template <int KIND, int MAXD>
__global__ void seq_qc_kernel(const float* __restrict__ syn, int B, float lch,
                              float beta, float clamp, int max_iter, int L,
                              int m_b, int n_b, int n_slots,
                              const int* __restrict__ g_row_ptr,
                              const int* __restrict__ g_slot_j,
                              const int* __restrict__ g_slot_s,
                              const int* __restrict__ g_col_ptr,
                              const int* __restrict__ g_col_i,
                              const int* __restrict__ g_col_s,
                              const int* __restrict__ g_row_par,
                              float* __restrict__ c2v,
                              uint8_t* __restrict__ mis,
                              float* __restrict__ post,
                              int* __restrict__ n_iter,
                              uint8_t* __restrict__ conv) {
  extern __shared__ int tab[];
  int* row_ptr = tab;                     // m_b + 1
  int* slot_j = row_ptr + (m_b + 1);      // n_slots
  int* slot_s = slot_j + n_slots;         // n_slots
  int* col_ptr = slot_s + n_slots;        // n_b + 1
  int* col_i = col_ptr + (n_b + 1);       // n_slots
  int* col_s = col_i + n_slots;           // n_slots
  int* row_par = col_s + n_slots;         // m_b
  for (int t = threadIdx.x; t <= m_b; t += blockDim.x) row_ptr[t] = g_row_ptr[t];
  for (int t = threadIdx.x; t < m_b; t += blockDim.x) row_par[t] = g_row_par[t];
  for (int t = threadIdx.x; t <= n_b; t += blockDim.x) col_ptr[t] = g_col_ptr[t];
  for (int t = threadIdx.x; t < n_slots; t += blockDim.x) {
    slot_j[t] = g_slot_j[t];
    slot_s[t] = g_slot_s[t];
    col_i[t] = g_col_i[t];
    col_s[t] = g_col_s[t];
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  const int n = n_b * L;
  for (int v = 0; v < n; ++v) post[v * sB + b] = lch;
  for (int e = 0; e < n_slots * L; ++e) c2v[e * sB + b] = 0.0f;
  // syndrome estimate of the all-equal start: row parity where L_ch < 0
  const int e0 = lch < 0.0f ? 1 : 0;
  int W = 0;
  for (int i = 0; i < m_b; ++i) {
    for (int r = 0; r < L; ++r) {
      const size_t c = (size_t)(i * L + r) * sB + b;
      const int mm = (row_par[i] & e0) ^ (syn[c] > 0.5f ? 1 : 0);
      mis[c] = (uint8_t)mm;
      W += mm;
    }
  }

  int it_lat = max_iter;
  bool done = false;
  for (int it = 0; it < max_iter && !done; ++it) {
    for (int i = 0; i < m_b && !done; ++i) {
      const int k0 = row_ptr[i];
      const int deg = row_ptr[i + 1] - k0;
      for (int r = 0; r < L; ++r) {
        const float ss = 1.0f - 2.0f * syn[(size_t)(i * L + r) * sB + b];
        // pass 1, slot by slot: x keeps v (MS) or the floored tanh (BP)
        float pos[MAXD], old[MAXD], x[MAXD];
        int vi[MAXD];
        float m1 = kBig, m2 = kBig, neg_par = 0.0f, prod = 1.0f;
#pragma unroll
        for (int d = 0; d < MAXD; ++d) {
          if (d < deg) {
            int rs = r + slot_s[k0 + d];
            if (rs >= L) rs -= L;
            vi[d] = slot_j[k0 + d] * L + rs;
            pos[d] = post[vi[d] * sB + b];
            old[d] = c2v[(size_t)((k0 + d) * L + r) * sB + b];
            const float v = pos[d] - old[d];
            if constexpr (KIND == kMS) {
              x[d] = v;
              const float a = fabsf(v);
              neg_par = neg_par + (v < 0.0f ? 1.0f : 0.0f);
              const bool is_new = a < m1;
              m2 = is_new ? m1 : fminf(m2, a);
              m1 = is_new ? a : m1;
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
          coef = (beta * ss) * (1.0f - 2.0f * par);
        }
        // pass 2: extrinsic message, write-back, flips into the mismatch
#pragma unroll
        for (int d = 0; d < MAXD; ++d) {
          if (d < deg) {
            float delta;  // new - old, the product of `new` fused in
            if constexpr (KIND == kMS) {
              const float sign = 1.0f - 2.0f * (x[d] < 0.0f ? 1.0f : 0.0f);
              const float mag = (fabsf(x[d]) == m1) ? m2 : m1;
              delta = fmaf(coef * sign, mag, -old[d]);
            } else {
              const float th2 = fminf(fmaxf(prod / x[d], -clamp), clamp);
              delta = fmaf(ss, logf((1.0f + th2) / (1.0f - th2)), -old[d]);
            }
            c2v[(size_t)((k0 + d) * L + r) * sB + b] = old[d] + delta;
            const float new_pos = pos[d] + delta;
            post[vi[d] * sB + b] = new_pos;
            if ((pos[d] < 0.0f) != (new_pos < 0.0f)) {
              const int j = slot_j[k0 + d];
              const int vloc = vi[d] - j * L;
              for (int k = col_ptr[j]; k < col_ptr[j + 1]; ++k) {
                int cr = vloc - col_s[k];
                if (cr < 0) cr += L;
                const size_t c = (size_t)(col_i[k] * L + cr) * sB + b;
                const int mm = mis[c] ^ 1;
                mis[c] = (uint8_t)mm;
                W += mm ? 1 : -1;
              }
            }
          }
        }
        if (W == 0) {  // latched at this row; frozen from the next row on
          it_lat = it + 1;
          done = true;
          break;
        }
      }
    }
  }
  n_iter[b] = it_lat;
  conv[b] = done ? 1 : 0;
}

template <int KIND, int MAXD>
cudaError_t launch(const float* syn, int B, float lch, float beta,
                   float clamp, int max_iter, int L, int m_b, int n_b,
                   int n_slots, const int* row_ptr, const int* slot_j,
                   const int* slot_s, const int* col_ptr, const int* col_i,
                   const int* col_s, const int* row_par, float* c2v,
                   uint8_t* mis, float* post, int* n_iter, uint8_t* conv,
                   cudaStream_t stream) {
  const int threads = 32;  // one warp per block: spreads B shots over SMs
  const int blocks = (B + threads - 1) / threads;
  const size_t shmem =
      sizeof(int) * (size_t)(2 * m_b + 1 + n_b + 1 + 4 * n_slots);
  seq_qc_kernel<KIND, MAXD><<<blocks, threads, shmem, stream>>>(
      syn, B, lch, beta, clamp, max_iter, L, m_b, n_b, n_slots, row_ptr,
      slot_j, slot_s, col_ptr, col_i, col_s, row_par, c2v, mis, post, n_iter,
      conv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* seq_qc_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

// kind: 0 = MS, 1 = BP; beta: the MS normalization; clamp: BP's 1 - eps as
// float32. syn: (m, B) float32 0/1, m = m_b * L; tables as in
// convert.SeqQCTables (int32, on the device), n_slots = row_ptr[m_b],
// max_deg the largest block-row degree; c2v: (n_slots * L, B) float32
// scratch; mis: (m, B) uint8 scratch; post: (n, B) posterior out; n_iter:
// (B,) int32 out; conv: (B,) uint8 out. Launches on `stream` and returns
// cudaGetLastError() after the launch.
int seq_qc_decode(const void* syn, int B, int kind, float lch, float beta,
                  float clamp, int max_iter, int L, int m_b, int n_b,
                  int max_deg, int n_slots, const void* row_ptr,
                  const void* slot_j, const void* slot_s, const void* col_ptr,
                  const void* col_i, const void* col_s, const void* row_par,
                  void* c2v, void* mis, void* post, void* n_iter, void* conv,
                  void* stream) {
  if (B <= 0) return 0;
#define QLDPC_SEQQC_ARGS                                                     \
  (const float*)syn, B, lch, beta, clamp, max_iter, L, m_b, n_b, n_slots,    \
      (const int*)row_ptr, (const int*)slot_j, (const int*)slot_s,           \
      (const int*)col_ptr, (const int*)col_i, (const int*)col_s,             \
      (const int*)row_par, (float*)c2v, (uint8_t*)mis, (float*)post,         \
      (int*)n_iter, (uint8_t*)conv, (cudaStream_t)stream
  if (kind == kMS) {
    if (max_deg <= 8) return (int)launch<kMS, 8>(QLDPC_SEQQC_ARGS);
    if (max_deg <= 16) return (int)launch<kMS, 16>(QLDPC_SEQQC_ARGS);
    if (max_deg <= 32) return (int)launch<kMS, 32>(QLDPC_SEQQC_ARGS);
  } else if (kind == kBP) {
    if (max_deg <= 8) return (int)launch<kBP, 8>(QLDPC_SEQQC_ARGS);
    if (max_deg <= 16) return (int)launch<kBP, 16>(QLDPC_SEQQC_ARGS);
    if (max_deg <= 32) return (int)launch<kBP, 32>(QLDPC_SEQQC_ARGS);
  }
#undef QLDPC_SEQQC_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
