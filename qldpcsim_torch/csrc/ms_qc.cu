// Message passing over a circulant-lifted H (kernel B of qldpcsim_torch):
// normalized min-sum (kind MS) and tanh-product sum-product (kind BP).
//
// Replaces the TPU kernel qldpcsim_tpu/ops/ms_qc_pallas.py::_make_kernel
// (kinds "MS" and "BP", built by make_qc_decoder): the whole iteration loop
// of one decode in one launch, schedules F (one snapshot pass over all
// block-rows) and block-row-grouped L, one syndrome check per iteration,
// converged shots frozen, posterior out. It computes what that kernel
// computes, in the same float32 order of operations (see ops/ms_qc_cuda.py);
// built with -fmad=false so that `mag - 2 * (neg * mag)` and `post + delta`
// are never contracted into FMAs. Kind BP calls the CUDA math library's
// tanhf and logf and divides with IEEE division (no fast math), as PyTorch's
// tanh, log and `/` do on the card, so it can equal its plain version.
//
// Design: one thread per shot. The Pallas kernel is purely lane-wise (every
// reduction runs over the slots of a block-row, never across shots) and a
// converged lane's updates are masked to zero, so a thread that runs its own
// loop and leaves it at convergence reproduces it exactly. State stays in
// device memory in the reference's shot-minor layout, so the loads and
// stores of a warp are coalesced: c2v (S * L, B), posterior (n, B) and, for
// groups whose block-rows share a variable block (flooding), a snapshot
// (n, B) taken at the group's start. The shift and group tables (a few
// hundred ints) sit in shared memory. Check row r of block-row i meets
// variable j * L + (r + s) % L of each slot (j, s); the rows of one
// block-row meet disjoint variables, so a thread finishes check row r
// (read, min/min2, write back) before it starts row r + 1.
//
// What bounds it on an H100: the latency of its state traffic, not the
// volume. Per shot and iteration it reads
// and writes c2v and the posterior once per edge and reads the posterior
// once more for the check: ~10 KB of c2v+posterior per shot per side
// (1,920 edges and 544 variables on the flagship code), ~40 MB of state per
// side at B = 4096, which the 50 MB L2 nearly holds. One thread per shot
// puts only B threads on the card (4,096: one warp per SM, latency-bound),
// and a warp runs until its slowest shot converges. Measured on an H100 SXM
// (700 W): about 0.63 ms per iteration for a lone warp, flat in B up to
// 2,048, so the straggler cascade's 50-iteration tail stage (a few dozen
// shots) takes most of a chunk's decode time. Later designs named for
// this kernel: L threads per shot with the state in shared memory; the X
// and Z sides in one launch; no tensor cores (wgmma) either way, since this
// is compare-and-select work.
//
// Kind BP is bound by its arithmetic where MS is bound by latency: per edge
// and iteration it evaluates two transcendentals (tanhf, logf: each a few
// dozen instructions of the math library's polynomial) and two IEEE
// divisions (prod / t and the log's quotient: a reciprocal refinement of
// ~10 instructions each), against MS's few compares. At one thread per
// shot those run on B threads only (4,096 on the flagship chunk: 4 % of the
// card's 132 x 2,048 resident threads), so the card's FP32 throughput is
// mostly idle and the per-iteration time is the dependent chain of one
// thread; the remedies are those of MS (more threads per shot).

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
__global__ void ms_qc_kernel(const float* __restrict__ syn, int B, float lch,
                             float beta, float clamp, int max_iter, int L,
                             int m_b, int n_b, int n_groups, int n_slots,
                             const int* __restrict__ g_row_ptr,
                             const int* __restrict__ g_slot_j,
                             const int* __restrict__ g_slot_s,
                             const int* __restrict__ g_group_ptr,
                             const int* __restrict__ g_group_snap,
                             float* __restrict__ c2v, float* __restrict__ post,
                             float* __restrict__ snap, int* __restrict__ n_iter,
                             uint8_t* __restrict__ conv) {
  extern __shared__ int tab[];
  int* row_ptr = tab;                        // m_b + 1
  int* slot_j = row_ptr + (m_b + 1);         // n_slots
  int* slot_s = slot_j + n_slots;            // n_slots
  int* group_ptr = slot_s + n_slots;         // n_groups + 1
  int* group_snap = group_ptr + (n_groups + 1);  // n_groups
  for (int t = threadIdx.x; t <= m_b; t += blockDim.x) row_ptr[t] = g_row_ptr[t];
  for (int t = threadIdx.x; t < n_slots; t += blockDim.x) {
    slot_j[t] = g_slot_j[t];
    slot_s[t] = g_slot_s[t];
  }
  for (int t = threadIdx.x; t <= n_groups; t += blockDim.x)
    group_ptr[t] = g_group_ptr[t];
  for (int t = threadIdx.x; t < n_groups; t += blockDim.x)
    group_snap[t] = g_group_snap[t];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  const int n = n_b * L;
  for (int v = 0; v < n; ++v) post[v * sB + b] = lch;
  for (int e = 0; e < n_slots * L; ++e) c2v[e * sB + b] = 0.0f;

  int it_lat = max_iter;
  bool done = false;
  for (int it = 0; it < max_iter && !done; ++it) {
    for (int g = 0; g < n_groups; ++g) {
      const float* src = post;
      if (group_snap[g]) {
        for (int v = 0; v < n; ++v) snap[v * sB + b] = post[v * sB + b];
        src = snap;
      }
      for (int i = group_ptr[g]; i < group_ptr[g + 1]; ++i) {
        const int k0 = row_ptr[i];
        const int deg = row_ptr[i + 1] - k0;
        for (int r = 0; r < L; ++r) {
          const float ss = 1.0f - 2.0f * syn[(size_t)(i * L + r) * sB + b];
          // pass 1, slot by slot: MS keeps |v|, sign and the running
          // min/min2/parity; BP keeps the floored tanh and the running
          // clamped product
          float a[MAXD], rowv[MAXD];
          bool neg[MAXD];
          int vi[MAXD];
          float m1 = kBig, m2 = kBig, neg_par = 0.0f, prod = 1.0f;
#pragma unroll
          for (int d = 0; d < MAXD; ++d) {
            if (d < deg) {
              int rs = r + slot_s[k0 + d];
              if (rs >= L) rs -= L;
              vi[d] = slot_j[k0 + d] * L + rs;
              rowv[d] = c2v[(size_t)((k0 + d) * L + r) * sB + b];
              const float v = src[vi[d] * sB + b] - rowv[d];
              if constexpr (KIND == kMS) {
                a[d] = fabsf(v);
                neg[d] = v < 0.0f;
                neg_par = neg_par + (neg[d] ? 1.0f : 0.0f);
                const bool is_new = a[d] < m1;
                m2 = is_new ? m1 : fminf(m2, a[d]);
                m1 = is_new ? a[d] : m1;
              } else {
                a[d] = sign_floor(tanhf(v * 0.5f), 1e-12f);  // t per slot
                prod = sign_floor(prod * a[d], 1e-30f);
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
          // pass 2: extrinsic messages and write-back
#pragma unroll
          for (int d = 0; d < MAXD; ++d) {
            if (d < deg) {
              float nv;
              if constexpr (KIND == kMS) {
                const float mag = (a[d] == m1) ? m2 : m1;
                const float negf = neg[d] ? 1.0f : 0.0f;
                nv = coef * (mag - 2.0f * (negf * mag));
              } else {
                const float th2 = fminf(fmaxf(prod / a[d], -clamp), clamp);
                nv = ss * logf((1.0f + th2) / (1.0f - th2));
              }
              const float delta = nv - rowv[d];
              c2v[(size_t)((k0 + d) * L + r) * sB + b] = nv;
              post[vi[d] * sB + b] = post[vi[d] * sB + b] + delta;
            }
          }
        }
      }
    }
    // one syndrome check per iteration: H (posterior < 0) == syn (mod 2)
    bool ok = true;
    for (int i = 0; i < m_b && ok; ++i) {
      const int k0 = row_ptr[i], k1 = row_ptr[i + 1];
      for (int r = 0; r < L; ++r) {
        int parity = 0;
        for (int k = k0; k < k1; ++k) {
          int rs = r + slot_s[k];
          if (rs >= L) rs -= L;
          parity ^= post[(slot_j[k] * L + rs) * sB + b] < 0.0f;
        }
        if (parity != (syn[(size_t)(i * L + r) * sB + b] > 0.5f)) {
          ok = false;
          break;
        }
      }
    }
    if (ok) {
      it_lat = it + 1;
      done = true;
    }
  }
  n_iter[b] = it_lat;
  conv[b] = done ? 1 : 0;
}

template <int KIND, int MAXD>
cudaError_t launch(const float* syn, int B, float lch, float beta,
                   float clamp, int max_iter, int L, int m_b, int n_b,
                   int n_groups, int n_slots, const int* row_ptr,
                   const int* slot_j, const int* slot_s, const int* group_ptr,
                   const int* group_snap, float* c2v, float* post, float* snap,
                   int* n_iter, uint8_t* conv, cudaStream_t stream) {
  const int threads = 32;  // one warp per block: spreads B shots over SMs
  const int blocks = (B + threads - 1) / threads;
  const size_t shmem = sizeof(int) * (size_t)(m_b + 1 + 2 * n_slots +
                                              2 * n_groups + 1);
  ms_qc_kernel<KIND, MAXD><<<blocks, threads, shmem, stream>>>(
      syn, B, lch, beta, clamp, max_iter, L, m_b, n_b, n_groups, n_slots,
      row_ptr, slot_j, slot_s, group_ptr, group_snap, c2v, post, snap, n_iter,
      conv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ms_qc_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

// kind: 0 = MS, 1 = BP; beta: the MS normalization; clamp: BP's 1 - eps as
// float32. syn: (m, B) float32 0/1, m = m_b * L; tables as in
// convert.QCTables (int32, on the device), n_slots = row_ptr[m_b], max_deg
// the largest block-row degree; c2v: (n_slots * L, B) scratch; post: (n, B)
// posterior out; snap: (n, B) scratch, or null when no group needs a
// snapshot; n_iter: (B,) int32 out; conv: (B,) uint8 out. Launches on
// `stream` and returns cudaGetLastError() after the launch.
int ms_qc_decode(const void* syn, int B, int kind, float lch, float beta,
                 float clamp, int max_iter, int L, int m_b, int n_b,
                 int n_groups, int max_deg, int n_slots,
                 const void* row_ptr, const void* slot_j,
                 const void* slot_s, const void* group_ptr,
                 const void* group_snap, void* c2v, void* post, void* snap,
                 void* n_iter, void* conv, void* stream) {
  if (B <= 0) return 0;
#define QLDPC_MSQC_ARGS                                                      \
  (const float*)syn, B, lch, beta, clamp, max_iter, L, m_b, n_b, n_groups,   \
      n_slots, (const int*)row_ptr, (const int*)slot_j,                      \
      (const int*)slot_s, (const int*)group_ptr, (const int*)group_snap,     \
      (float*)c2v,                                                           \
      (float*)post, (float*)snap, (int*)n_iter, (uint8_t*)conv,              \
      (cudaStream_t)stream
  if (kind == kMS) {
    if (max_deg <= 8) return (int)launch<kMS, 8>(QLDPC_MSQC_ARGS);
    if (max_deg <= 16) return (int)launch<kMS, 16>(QLDPC_MSQC_ARGS);
    if (max_deg <= 32) return (int)launch<kMS, 32>(QLDPC_MSQC_ARGS);
  } else if (kind == kBP) {
    if (max_deg <= 8) return (int)launch<kBP, 8>(QLDPC_MSQC_ARGS);
    if (max_deg <= 16) return (int)launch<kBP, 16>(QLDPC_MSQC_ARGS);
    if (max_deg <= 32) return (int)launch<kBP, 32>(QLDPC_MSQC_ARGS);
  }
#undef QLDPC_MSQC_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
