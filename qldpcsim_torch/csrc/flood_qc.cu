// Slot-stacked flooding decode over a circulant-lifted H (kernel F of
// qldpcsim_torch): normalized min-sum (kind MS) and tanh-product sum-product
// (kind BP).
//
// Replaces the TPU kernel
// qldpcsim_tpu/ops/flood_qc_pallas.py::make_flood_stacked_kernel (chosen by
// ms_qc_pallas.py::make_qc_decoder for schedule F, one check per iteration
// and a uniform block-row degree d). Per shot and iteration it computes what
// that kernel computes, in the same float32 association (see
// ops/flood_qc_cuda.py): every slot's v = roll(post[j], s) - c2v from ONE
// posterior snapshot; per check row the min1/min2 (MS) or the clamped
// product (BP) by the pairwise tree over the row's d slots ([0:h) with
// [h:2h), an odd leftover appended); the new messages; per variable the SUM
// of its slots' deltas in ascending slot order, added to the posterior once;
// one syndrome check. Built with -fmad=false; kind BP calls the CUDA math
// library's tanhf and logf and divides with IEEE division (no fast math, no
// flush of denormals: the 1e-30 clamp stays as the reference has it).
//
// Design: one thread block per shot, the shot's whole state in shared memory
// (posterior n, c2v and delta S * L each, the syndrome signs m floats, and
// the slot and column tables: 17.5 KB on lp118_0, 34 KB on the Tanner code).
// Flooding has no dependence between check rows within an iteration, so
// phase 1 gives every check row a thread (tree over its d slots in
// registers, new message and delta written), a barrier, phase 2 gives every
// variable a thread (its column's deltas summed in ascending slot order and
// added once: no atomics, so the order is fixed), a barrier, and the
// syndrome check is a block-wide __syncthreads_or. The block leaves at
// convergence, which is the reference's freeze: a converged shot's new
// message is its old one and its delta exactly 0. A lone shot therefore
// costs d + column-weight dependent steps per iteration instead of one
// thread walking all S * L edges, which is where the one-thread-per-shot
// kernels (ms_qc.cu, seq_qc.cu, general_h.cu) lose their time.
//
// What bounds it on an H100: operations, not bytes (a shot reads m floats
// and writes n: ~3 KB against ~1,920 edges x 15 (MS) or 71 (BP) operations
// per iteration). No tensor cores (wgmma) and no TMA: this is compare,
// select and transcendental work on state that never leaves the SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;  // +inf stand-in of the reference's min
constexpr int kMS = 0;         // kinds, in the order of flood_qc_cuda.KINDS
constexpr int kBP = 1;
constexpr int kMaxSmem = 232448;  // shared memory a block can use (227 KB)

__device__ __forceinline__ float sign_floor(float x, float floor_abs) {
  // (x < 0 ? -1 : 1) * max(|x|, floor_abs), as the reference writes it
  return (x < 0.0f ? -1.0f : 1.0f) * fmaxf(fabsf(x), floor_abs);
}

// (min1, min2) of m1[0..DD) by the reference's pairwise merge tree
// (_min12_tree / _min12_merge), in place; the result lands in m1[0], m2[0].
template <int DD>
__device__ __forceinline__ void min12_tree(float* m1, float* m2) {
  if constexpr (DD > 1) {
    constexpr int h = DD / 2;
#pragma unroll
    for (int q = 0; q < h; ++q) {
      const float a1 = m1[q], a2 = m2[q], b1 = m1[q + h], b2 = m2[q + h];
      const bool take_a = a1 <= b1;
      m1[q] = take_a ? a1 : b1;
      m2[q] = take_a ? fminf(a2, b1) : fminf(b2, a1);
    }
    if constexpr (DD % 2) {
      m1[h] = m1[2 * h];
      m2[h] = m2[2 * h];
    }
    min12_tree<h + DD % 2>(m1, m2);
  }
}

// Product of p[0..DD) by the same pairing, clamped to |q| >= 1e-30 with its
// sign at every level; the result lands in p[0].
template <int DD>
__device__ __forceinline__ void prod_tree(float* p) {
  if constexpr (DD > 1) {
    constexpr int h = DD / 2;
#pragma unroll
    for (int q = 0; q < h; ++q) p[q] = sign_floor(p[q] * p[q + h], 1e-30f);
    if constexpr (DD % 2) p[h] = p[2 * h];
    prod_tree<h + DD % 2>(p);
  }
}

template <int KIND, int D>
__global__ void flood_qc_kernel(const float* __restrict__ syn, float lch,
                                float beta, float clamp, int max_iter, int L,
                                int m_b, int n_b,
                                const int* __restrict__ g_slot_j,
                                const int* __restrict__ g_slot_s,
                                const int* __restrict__ g_col_ptr,
                                const int* __restrict__ g_col_k,
                                float* __restrict__ post_out,
                                int* __restrict__ n_iter,
                                uint8_t* __restrict__ conv) {
  extern __shared__ float smem[];
  const int S = m_b * D, m = m_b * L, n = n_b * L, E = S * L;
  float* post = smem;                  // n
  float* c2v = post + n;               // E: slot k, check row r at k * L + r
  float* delta = c2v + E;              // E
  float* ssign = delta + E;            // m: 1 - 2 syndrome
  int* slot_j = (int*)(ssign + m);     // S
  int* slot_s = slot_j + S;            // S
  int* col_ptr = slot_s + S;           // n_b + 1
  int* col_k = col_ptr + (n_b + 1);    // S
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t b = blockIdx.x;

  for (int t = tid; t < S; t += nt) {
    slot_j[t] = g_slot_j[t];
    slot_s[t] = g_slot_s[t];
    col_k[t] = g_col_k[t];
  }
  for (int t = tid; t <= n_b; t += nt) col_ptr[t] = g_col_ptr[t];
  for (int t = tid; t < n; t += nt) post[t] = lch;
  for (int t = tid; t < E; t += nt) c2v[t] = 0.0f;
  for (int t = tid; t < m; t += nt) ssign[t] = 1.0f - 2.0f * syn[b * m + t];
  __syncthreads();

  int it_lat = max_iter;
  bool done = false;
  for (int it = 0; it < max_iter; ++it) {
    // phase 1: one check row per thread, all from the same snapshot (the
    // posterior is not written before the barrier)
    for (int row = tid; row < m; row += nt) {
      const int i = row / L, r = row - i * L;
      const int k0 = i * D;
      const float ss = ssign[row];
      float old[D], a[D];
      if constexpr (KIND == kMS) {
        float neg[D], m1[D], m2[D];
        float neg_par = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          int rs = r + slot_s[k0 + d];
          if (rs >= L) rs -= L;
          old[d] = c2v[(k0 + d) * L + r];
          const float v = post[slot_j[k0 + d] * L + rs] - old[d];
          a[d] = fabsf(v);
          neg[d] = v < 0.0f ? 1.0f : 0.0f;
          neg_par = neg_par + neg[d];
          m1[d] = a[d];
          m2[d] = kBig;
        }
        min12_tree<D>(m1, m2);
        const float lo1 = m1[0] >= kBig ? 0.0f : m1[0];
        const float lo2 = m2[0] >= kBig ? 0.0f : m2[0];
        const float par = neg_par - 2.0f * floorf(neg_par * 0.5f);
        const float coef = (beta * ss) * (1.0f - 2.0f * par);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float mag = (a[d] == lo1) ? lo2 : lo1;
          const float nv = coef * (mag - 2.0f * (neg[d] * mag));
          c2v[(k0 + d) * L + r] = nv;
          delta[(k0 + d) * L + r] = nv - old[d];
        }
      } else {
        float p[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          int rs = r + slot_s[k0 + d];
          if (rs >= L) rs -= L;
          old[d] = c2v[(k0 + d) * L + r];
          const float v = post[slot_j[k0 + d] * L + rs] - old[d];
          a[d] = sign_floor(tanhf(v * 0.5f), 1e-12f);  // t per slot
          p[d] = a[d];
        }
        prod_tree<D>(p);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float th2 = fminf(fmaxf(p[0] / a[d], -clamp), clamp);
          const float nv = ss * logf((1.0f + th2) / (1.0f - th2));
          c2v[(k0 + d) * L + r] = nv;
          delta[(k0 + d) * L + r] = nv - old[d];
        }
      }
    }
    __syncthreads();
    // phase 2: one variable per thread; its slots' deltas are summed in
    // ascending slot order, then added to the posterior once
    for (int v = tid; v < n; v += nt) {
      const int j = v / L, vr = v - j * L;
      const int c0 = col_ptr[j], c1 = col_ptr[j + 1];
      if (c1 > c0) {
        float acc = 0.0f;
        for (int c = c0; c < c1; ++c) {
          const int k = col_k[c];
          int rr = vr - slot_s[k];
          if (rr < 0) rr += L;
          const float x = delta[k * L + rr];
          acc = (c == c0) ? x : acc + x;
        }
        post[v] = post[v] + acc;
      }
    }
    __syncthreads();
    // one syndrome check per iteration: H (posterior < 0) == syn (mod 2)
    int bad = 0;
    for (int row = tid; row < m; row += nt) {
      const int i = row / L, r = row - i * L;
      int parity = 0;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        int rs = r + slot_s[i * D + d];
        if (rs >= L) rs -= L;
        parity ^= post[slot_j[i * D + d] * L + rs] < 0.0f;
      }
      bad |= parity != (ssign[row] < 0.0f);
    }
    // also the barrier between this check's reads and the next writes
    if (__syncthreads_or(bad) == 0) {
      it_lat = it + 1;
      done = true;
      break;
    }
  }
  for (int t = tid; t < n; t += nt) post_out[b * n + t] = post[t];
  if (tid == 0) {
    n_iter[b] = it_lat;
    conv[b] = done ? 1 : 0;
  }
}

size_t smem_bytes(int L, int m_b, int n_b, int deg) {
  const size_t S = (size_t)m_b * deg;
  return sizeof(float) * ((size_t)n_b * L + 2 * S * L + (size_t)m_b * L) +
         sizeof(int) * (3 * S + n_b + 1);
}

template <int KIND, int D>
cudaError_t launch(const float* syn, int B, float lch, float beta,
                   float clamp, int max_iter, int L, int m_b, int n_b,
                   const int* slot_j, const int* slot_s, const int* col_ptr,
                   const int* col_k, float* post, int* n_iter, uint8_t* conv,
                   cudaStream_t stream) {
  const size_t shmem = smem_bytes(L, m_b, n_b, D);
  if (shmem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = flood_qc_kernel<KIND, D>;
  if (shmem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (rc != cudaSuccess) return rc;
  }
  // a thread per check row, in whole warps, at most 512
  int threads = ((m_b * L + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  kernel<<<B, threads, shmem, stream>>>(syn, lch, beta, clamp, max_iter, L,
                                        m_b, n_b, slot_j, slot_s, col_ptr,
                                        col_k, post, n_iter, conv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flood_qc_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

// kind: 0 = MS, 1 = BP; beta: the MS normalization; clamp: BP's 1 - eps as
// float32. syn: (B, m) float32 0/1, shot-major, m = m_b * L; deg: the
// uniform block-row degree (1..16), slot k = i * deg + d of block-row i;
// slot_j, slot_s: (m_b * deg,) as in convert.QCTables; col_ptr (n_b + 1,),
// col_k (m_b * deg,): QCTables.col_slots(); all int32 on the device. post:
// (B, n) posterior out, shot-major; n_iter: (B,) int32 out; conv: (B,)
// uint8 out. Launches on `stream` and returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a degree or a state size it cannot run).
int flood_qc_decode(const void* syn, int B, int kind, float lch, float beta,
                    float clamp, int max_iter, int L, int m_b, int n_b,
                    int deg, const void* slot_j, const void* slot_s,
                    const void* col_ptr, const void* col_k, void* post,
                    void* n_iter, void* conv, void* stream) {
  if (B <= 0) return 0;
#define QLDPC_FLOOD_ARGS                                                     \
  (const float*)syn, B, lch, beta, clamp, max_iter, L, m_b, n_b,             \
      (const int*)slot_j, (const int*)slot_s, (const int*)col_ptr,           \
      (const int*)col_k, (float*)post, (int*)n_iter, (uint8_t*)conv,         \
      (cudaStream_t)stream
#define QLDPC_FLOOD_CASE(D)                                                  \
  case D:                                                                    \
    return (int)(kind == kMS ? launch<kMS, D>(QLDPC_FLOOD_ARGS)              \
                             : launch<kBP, D>(QLDPC_FLOOD_ARGS));
  if (kind != kMS && kind != kBP) return (int)cudaErrorInvalidValue;
  switch (deg) {
    QLDPC_FLOOD_CASE(1)
    QLDPC_FLOOD_CASE(2)
    QLDPC_FLOOD_CASE(3)
    QLDPC_FLOOD_CASE(4)
    QLDPC_FLOOD_CASE(5)
    QLDPC_FLOOD_CASE(6)
    QLDPC_FLOOD_CASE(7)
    QLDPC_FLOOD_CASE(8)
    QLDPC_FLOOD_CASE(9)
    QLDPC_FLOOD_CASE(10)
    QLDPC_FLOOD_CASE(11)
    QLDPC_FLOOD_CASE(12)
    QLDPC_FLOOD_CASE(13)
    QLDPC_FLOOD_CASE(14)
    QLDPC_FLOOD_CASE(15)
    QLDPC_FLOOD_CASE(16)
  }
#undef QLDPC_FLOOD_CASE
#undef QLDPC_FLOOD_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
