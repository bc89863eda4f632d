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
// (posterior n, c2v and deltas S * L each, the syndrome signs m floats, and
// the slot and column tables: 17.5 KB on lp118_0, 34 KB on the Tanner code).
// An iteration is two passes and two barriers:
//   phase 1: the check rows side by side, a thread per row. A thread loads
//     its row's posterior words and messages and computes v (MS) or the
//     clamped tanh (BP), runs the row's pairwise tree over the d values in
//     the reference's order (MS: the count of negative values, an exact
//     small integer, by popc), then the row's new messages; the
//     deltas are stored by variable, the c-th slot of variable block j at
//     (col_ptr[j] + c) * L. The same loads give the row's parity of the
//     posterior's signs, which is the previous iteration's syndrome check:
//     it joins the block-wide __syncthreads_or that ends phase 1, and a
//     shot whose check passes leaves there, before phase 2 writes the
//     posterior (iteration 0 skips the test; a standalone check follows
//     the last iteration).
//   phase 2: a thread per variable (up to 3 each) sums its column's deltas
//     (consecutive words L apart, loaded side by side) in ascending slot
//     order and adds the sum once: no atomics, so the order is fixed.
// Each thread computes its row's posterior and delta word addresses (packed
// 16 + 16 bits, both below 2^16 within shared memory) and its variables'
// first delta words and counts once per launch, into registers; the block
// has a thread per row and at least n / 3 (at most 1024): 256 on lp118_0,
// so that a 4096-shot launch keeps several shots on each SM. Rows beyond
// the block's threads take their addresses from the shared tables. The
// block leaves at convergence, which is the reference's freeze: a converged
// shot's new message is its old one and its delta exactly 0.
//
// What bounds it on an H100: latency, then operations, not bytes (a shot
// reads m floats and writes n: ~3 KB against ~1,920 edges x 15 (MS) or 71
// (BP) operations per iteration). A lone shot's iteration is the chain of
// one check row's loads, tree and stores, a barrier, one variable's sums
// and a barrier (BP adds tanhf, a division and logf to the chain; spreading
// a row over 4 lanes, its values gathered by shuffles, was timed slower
// under MS and BP). No tensor cores (wgmma) and no TMA: this is compare, select and
// transcendental work on state that never leaves the SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;  // +inf stand-in of the reference's min
constexpr int kMS = 0;         // kinds, in the order of flood_qc_cuda.KINDS
constexpr int kBP = 1;
constexpr int kMaxSmem = 232448;  // shared memory a block can use (227 KB)
constexpr int kVPT = 3;  // variables per thread with addresses in registers
constexpr int kCW = 6;   // a variable's deltas loaded side by side

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

// The addresses of check row `row`'s slots: posterior word (low 16 bits)
// and delta word (high 16 bits); and the row's first c2v word.
template <int D>
__device__ __forceinline__ void row_addresses(int row, int L, const int* sjL,
                                              const int* sslot,
                                              const int* spos,
                                              unsigned (&pk)[D], int& cbase) {
  const int i = row / L, r = row - i * L;
  cbase = i * D * L + r;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int k = i * D + d;
    int rs = r + sslot[k];
    if (rs >= L) rs -= L;
    pk[d] = ((unsigned)(spos[k] * L + rs) << 16) | (unsigned)(sjL[k] + rs);
  }
}

// Phase 1 for one check row: loads its slots' posterior words and messages
// and computes v (MS) or the clamped tanh (BP), runs the pairwise tree over
// the row's d values in the reference's order, then writes the row's
// messages and deltas. Returns 1 when `check` is set and the row's parity
// of the posterior's signs differs from its syndrome bit.
template <int KIND, int D>
__device__ __forceinline__ int row_update(const unsigned (&pk)[D], int cbase,
                                          float ss, bool check, float beta,
                                          float clamp, int L,
                                          const float* post, float* c2v,
                                          float* dv) {
  float x[D];  // MS: v; BP: the clamped tanh, in slot order
  float old[D];
  int par = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float pv = post[pk[d] & 0xffff];
    par ^= pv < 0.0f;
    old[d] = c2v[cbase + d * L];
    const float v = pv - old[d];
    if constexpr (KIND == kMS)
      x[d] = v;
    else
      x[d] = sign_floor(tanhf(v * 0.5f), 1e-12f);
  }
  const int bad = check && (par != (ss < 0.0f));
  if constexpr (KIND == kMS) {
    float m1[D], m2[D];
    unsigned negm = 0u;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      m1[d] = fabsf(x[d]);
      m2[d] = kBig;
      negm |= (x[d] < 0.0f ? 1u : 0u) << d;
    }
    min12_tree<D>(m1, m2);
    const float lo1 = m1[0] >= kBig ? 0.0f : m1[0];
    const float lo2 = m2[0] >= kBig ? 0.0f : m2[0];
    // the count of negative values is an exact small integer in float32,
    // so its parity, neg_par - 2 floor(neg_par / 2), is popc & 1
    const float npar = (float)(__popc(negm) & 1);
    const float coef = (beta * ss) * (1.0f - 2.0f * npar);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float neg = x[d] < 0.0f ? 1.0f : 0.0f;
      const float mag = (fabsf(x[d]) == lo1) ? lo2 : lo1;
      const float nv = coef * (mag - 2.0f * (neg * mag));
      c2v[cbase + d * L] = nv;
      dv[pk[d] >> 16] = nv - old[d];
    }
  } else {
    float p[D];
#pragma unroll
    for (int d = 0; d < D; ++d) p[d] = x[d];
    prod_tree<D>(p);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float th2 = fminf(fmaxf(p[0] / x[d], -clamp), clamp);
      const float nv = ss * logf((1.0f + th2) / (1.0f - th2));
      c2v[cbase + d * L] = nv;
      dv[pk[d] >> 16] = nv - old[d];
    }
  }
  return bad;
}

template <int KIND, int D>
__global__ void __launch_bounds__(1024)
    flood_qc_kernel(const float* __restrict__ syn, float lch, float beta,
                    float clamp, int max_iter, int L, int m_b, int n_b,
                    const int* __restrict__ g_slot_j,
                    const int* __restrict__ g_slot_s,
                    const int* __restrict__ g_col_ptr,
                    const int* __restrict__ g_col_k,
                    float* __restrict__ post_out, int* __restrict__ n_iter,
                    uint8_t* __restrict__ conv) {
  extern __shared__ float smem[];
  const int S = m_b * D, m = m_b * L, n = n_b * L, E = S * L;
  float* post = smem;                  // n
  float* c2v = post + n;               // E: slot k, check row r at k * L + r
  float* dv = c2v + E;                 // E: by variable (see above)
  float* ssign = dv + E;               // m: 1 - 2 syndrome
  int* sjL = (int*)(ssign + m);        // S: slot_j * L
  int* sslot = sjL + S;                // S: slot_s
  int* spos = sslot + S;               // S: slot k's place in col_k
  int* cptr = spos + S;                // n_b + 1
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t b = blockIdx.x;

  for (int t = tid; t < S; t += nt) {
    sjL[t] = g_slot_j[t] * L;
    sslot[t] = g_slot_s[t];
    spos[g_col_k[t]] = t;
  }
  for (int t = tid; t <= n_b; t += nt) cptr[t] = g_col_ptr[t];
  for (int t = tid; t < n; t += nt) post[t] = lch;
  for (int t = tid; t < E; t += nt) c2v[t] = 0.0f;
  for (int t = tid; t < m; t += nt) ssign[t] = 1.0f - 2.0f * syn[b * m + t];
  __syncthreads();

  // loop-invariant addresses of this thread's row (when the rows take one
  // pass of the block; else they are recomputed from the tables each pass)
  const bool one_pass = m <= nt;
  unsigned pk[D];
  int cbase = 0;
  float ss = 1.0f;
  if (tid < m) {
    row_addresses<D>(tid, L, sjL, sslot, spos, pk, cbase);
    ss = ssign[tid];
  }
  // phase 2's variables tid + q * nt, q < kVPT: first delta word (low 16
  // bits) and count (high 16 bits)
  unsigned vpk[kVPT];
#pragma unroll
  for (int q = 0; q < kVPT; ++q) {
    const int v = tid + q * nt;
    vpk[q] = 0u;
    if (v < n) {
      const int j = v / L;
      vpk[q] = (unsigned)(cptr[j] * L + (v - j * L)) |
               ((unsigned)(cptr[j + 1] - cptr[j]) << 16);
    }
  }

  int it_lat = max_iter;
  bool done = false;
  for (int it = 0; it < max_iter; ++it) {
    // phase 1 (and the check of the posterior the last phase 2 left)
    int bad = 0;
    for (int row = tid; row < m; row += nt) {
      if (!one_pass) {
        row_addresses<D>(row, L, sjL, sslot, spos, pk, cbase);
        ss = ssign[row];
      }
      bad |= row_update<KIND, D>(pk, cbase, ss, it > 0, beta, clamp, L, post,
                                 c2v, dv);
    }
    if (__syncthreads_or(bad) == 0 && it > 0) {
      it_lat = it;  // the posterior after iteration it - 1 satisfies H
      done = true;
      break;
    }
    // phase 2: a thread per variable (up to kVPT each, then the tables);
    // a variable's deltas are summed in ascending slot order, then added to
    // the posterior once. All sums are loaded before any posterior store.
    float acc[kVPT];
#pragma unroll
    for (int q = 0; q < kVPT; ++q) {
      // up to kCW deltas loaded side by side (a word past the column's
      // last repeats it, unused), then added in ascending slot order
      const int v0 = vpk[q] & 0xffff, cw = vpk[q] >> 16;
      float y[kCW];
#pragma unroll
      for (int c = 0; c < kCW; ++c)
        y[c] = dv[v0 + min(c, max(cw - 1, 0)) * L];
      acc[q] = y[0];
#pragma unroll
      for (int c = 1; c < kCW; ++c) acc[q] = c < cw ? acc[q] + y[c] : acc[q];
      for (int c = kCW; c < cw; ++c) acc[q] = acc[q] + dv[v0 + c * L];
    }
#pragma unroll
    for (int q = 0; q < kVPT; ++q)
      if (vpk[q] >> 16) post[tid + q * nt] = post[tid + q * nt] + acc[q];
    for (int v = tid + kVPT * nt; v < n; v += nt) {
      const int j = v / L;
      const int v0 = cptr[j] * L + (v - j * L), cw = cptr[j + 1] - cptr[j];
      if (cw > 0) {
        float a = dv[v0];
        for (int c = 1; c < cw; ++c) a = a + dv[v0 + c * L];
        post[v] = post[v] + a;
      }
    }
    __syncthreads();
  }
  if (!done && max_iter > 0) {
    // the check after the last iteration
    int bad = 0;
    for (int row = tid; row < m; row += nt) {
      const int i = row / L, r = row - i * L;
      int parity = 0;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        int rs = r + sslot[i * D + d];
        if (rs >= L) rs -= L;
        parity ^= post[sjL[i * D + d] + rs] < 0.0f;
      }
      bad |= parity != (ssign[row] < 0.0f);
    }
    done = __syncthreads_or(bad) == 0;
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
                   int threads, const int* slot_j, const int* slot_s,
                   const int* col_ptr, const int* col_k, float* post,
                   int* n_iter, uint8_t* conv, cudaStream_t stream) {
  const size_t shmem = smem_bytes(L, m_b, n_b, D);
  if (shmem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = flood_qc_kernel<KIND, D>;
  if (shmem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (rc != cudaSuccess) return rc;
  }
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
// threads per shot (a multiple of 32, at most 1024): ops/flood_qc_cuda.plan;
// slot_j, slot_s: (m_b * deg,) as
// in convert.QCTables; col_ptr (n_b + 1,), col_k (m_b * deg,):
// QCTables.col_slots(); all int32 on the device. post: (B, n) posterior
// out, shot-major; n_iter: (B,) int32 out; conv: (B,) uint8 out. Launches
// on `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a degree or a state size it cannot run).
int flood_qc_decode(const void* syn, int B, int kind, float lch, float beta,
                    float clamp, int max_iter, int L, int m_b, int n_b,
                    int deg, int threads, const void* slot_j,
                    const void* slot_s, const void* col_ptr,
                    const void* col_k, void* post, void* n_iter, void* conv,
                    void* stream) {
  if (B <= 0) return 0;
  // packed addresses: 16 bits each for the posterior and the delta words
  if ((kind != kMS && kind != kBP) || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || (size_t)n_b * L >= 65536 ||
      (size_t)m_b * deg * L >= 65536)
    return (int)cudaErrorInvalidValue;
#define QLDPC_FLOOD_ARGS                                                     \
  (const float*)syn, B, lch, beta, clamp, max_iter, L, m_b, n_b, threads,    \
      (const int*)slot_j, (const int*)slot_s, (const int*)col_ptr,           \
      (const int*)col_k, (float*)post, (int*)n_iter, (uint8_t*)conv,         \
      (cudaStream_t)stream
#define QLDPC_FLOOD_CASE(D)                                                  \
  case D:                                                                    \
    return (int)(kind == kMS ? launch<kMS, D>(QLDPC_FLOOD_ARGS)              \
                             : launch<kBP, D>(QLDPC_FLOOD_ARGS));
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
