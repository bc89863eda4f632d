// Message passing over an arbitrary parity-check matrix H (kernel E of
// qldpcsim_torch): normalized min-sum (kind MS) and tanh-product sum-product
// (kind BP), under the flooding schedule or any layered schedule whose
// layers are contiguous runs of check rows.
//
// Replaces the TPU kernel qldpcsim_tpu/ops/general_h_pallas.py::
// make_gh_decoder (kinds "MS" and "BP"): the whole decode of a shot block in
// one launch. That kernel gathers the posterior at each edge's variable and
// scatters the message deltas back with two one-hot float32 matrix products
// (n x E and E x n), because a gather is slow on the TPU and a matrix product
// nearly free. Here the gather is an indexed load through var_of[m][dmax]
// and the scatter an indexed add; the incidence matrices are never built. It
// computes what that kernel computes, in the same float32 order of
// operations (see ops/general_h_cuda.py); -fmad=false keeps every multiply
// and add apart, as the reference's compiled form does here (its `new` feeds
// both the stored message and `new - old`, so nothing is contracted). Kind
// BP calls the CUDA math library's tanhf and logf and divides with IEEE
// division (no fast math), as PyTorch's tanh, log and `/` do on the card, so
// it can equal its plain version.
//
// Design: one thread per shot. The TPU kernel puts the shots on the lanes
// and runs a block until all its shots are done, keeping the messages of the
// done ones so that their deltas are 0; shots never interact, so here a
// thread runs its own loop and leaves it at the iteration where its shot
// latches, which gives the same result. State lies in device memory
// shot-minor, as in the reference (c2v (E, B), post (n, B)), so a warp's
// loads and stores are coalesced: the posterior is the output buffer itself,
// the messages c2v are scratch the caller keeps. dmax is a run-time value: a
// row is passed over twice (minima or product first, messages second; the
// second pass finds the first's words in cache) and nothing of it is held in
// registers. A layer whose rows share no variable updates the posterior in
// place; a layer whose rows share variables (the flooding schedule's one
// layer) reads the posterior as it stood at the layer's start, sums each
// variable's deltas in ascending edge order in the scratch acc (n, B), and
// adds the sums afterwards. The hard decision's syndrome is tested once per
// iteration, row by row, up to the first row that disagrees. var_of sits in
// shared memory when it fits there, else it is read from device memory.
//
// What bounds it on an H100: latency, not bytes or operations (its bound
// from either is microseconds): m * dmax dependent gathers per iteration per
// thread on B threads only (4,096 on a chunk: one warp per SM), with
// (E + n) * 4 bytes of state per shot (40 MB at B = 4096 on a 240 x 544
// matrix of row weight 8). Measured times: PERF.md. Later designs: several
// threads per shot (the rows of a layer share no variable, so they can go
// side by side), the state of a shot block in shared memory, both sides in
// one launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;  // +inf stand-in of the reference's min
constexpr int kMS = 0;         // kinds, in the order of ms_qc_cuda.KINDS
constexpr int kBP = 1;
// largest var_of (bytes) copied to shared memory: the 48 KB a block may use
// without opting in to more
constexpr size_t kMaxSharedTable = 48 * 1024;

__device__ __forceinline__ float sign_floor(float x, float floor_abs) {
  // (x < 0 ? -1 : 1) * max(|x|, floor_abs), as the reference writes it
  return (x < 0.0f ? -1.0f : 1.0f) * fmaxf(fabsf(x), floor_abs);
}

template <int KIND>
__global__ void general_h_kernel(const float* __restrict__ syn, int B,
                                 float lch, float beta, float clamp,
                                 int max_iter, int m, int n, int dmax,
                                 int n_runs, int table_in_shared,
                                 const int* __restrict__ g_var_of,
                                 const int* __restrict__ run_ptr,
                                 const int* __restrict__ run_shared,
                                 float* __restrict__ c2v,
                                 float* __restrict__ acc,
                                 float* __restrict__ post,
                                 int* __restrict__ n_iter,
                                 uint8_t* __restrict__ conv) {
  extern __shared__ int tab[];
  const int E = m * dmax;
  const int* var_of = g_var_of;
  if (table_in_shared) {
    for (int t = threadIdx.x; t < E; t += blockDim.x) tab[t] = g_var_of[t];
    __syncthreads();
    var_of = tab;
  }

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  for (int v = 0; v < n; ++v) post[v * sB + b] = lch;
  for (int e = 0; e < E; ++e) c2v[e * sB + b] = 0.0f;
  if (acc != nullptr) {
    for (int v = 0; v < n; ++v) acc[v * sB + b] = 0.0f;
  }

  int it_lat = max_iter;
  bool done = false;
  for (int it = 0; it < max_iter && !done; ++it) {
    for (int l = 0; l < n_runs; ++l) {
      const bool shared_vars = run_shared[l] != 0;
      for (int i = run_ptr[l]; i < run_ptr[l + 1]; ++i) {
        const int* row = var_of + i * dmax;
        const size_t e0 = (size_t)i * dmax;
        const float ss = 1.0f - 2.0f * syn[i * sB + b];
        // pass 1 over the row's slots: minima and sign parity (MS) or the
        // running product (BP); a pad slot leaves all of them as they are
        float m1 = kBig, m2 = kBig, neg_par = 0.0f, prod = 1.0f;
        for (int k = 0; k < dmax; ++k) {
          const int v = row[k];
          if (v < 0) continue;
          const float V = post[v * sB + b] - c2v[(e0 + k) * sB + b];
          if constexpr (KIND == kMS) {
            const float a = fabsf(V);
            neg_par = neg_par + (V < 0.0f ? 1.0f : 0.0f);
            const bool is_new = a < m1;
            m2 = is_new ? m1 : fminf(m2, a);
            m1 = fminf(m1, a);
          } else {
            prod = sign_floor(prod * sign_floor(tanhf(V * 0.5f), 1e-12f),
                              1e-30f);
          }
        }
        float coef = 0.0f;
        if constexpr (KIND == kMS) {
          if (m1 >= kBig) m1 = 0.0f;
          if (m2 >= kBig) m2 = 0.0f;
          const float par = neg_par - 2.0f * floorf(neg_par * 0.5f);
          coef = (beta * ss) * (1.0f - 2.0f * par);
        }
        // pass 2: the extrinsic message of each slot, its write-back, and
        // its delta into the posterior (or into the layer's sums)
        for (int k = 0; k < dmax; ++k) {
          const int v = row[k];
          if (v < 0) continue;
          const float pos = post[v * sB + b];
          const float old = c2v[(e0 + k) * sB + b];
          const float V = pos - old;
          float nw;
          if constexpr (KIND == kMS) {
            const float sign = 1.0f - 2.0f * (V < 0.0f ? 1.0f : 0.0f);
            const float mag = (fabsf(V) == m1) ? m2 : m1;
            nw = (coef * sign) * mag;
          } else {
            const float t = sign_floor(tanhf(V * 0.5f), 1e-12f);
            const float th2 = fminf(fmaxf(prod / t, -clamp), clamp);
            nw = ss * logf((1.0f + th2) / (1.0f - th2));
          }
          const float delta = nw - old;
          c2v[(e0 + k) * sB + b] = nw;
          if (shared_vars) {
            acc[v * sB + b] = acc[v * sB + b] + delta;
          } else {
            post[v * sB + b] = pos + delta;
          }
        }
      }
      if (shared_vars) {
        for (int v = 0; v < n; ++v) {
          post[v * sB + b] = post[v * sB + b] + acc[v * sB + b];
          acc[v * sB + b] = 0.0f;
        }
      }
    }
    // the hard decision's syndrome against the shot's, once per iteration
    bool ok = true;
    for (int i = 0; i < m && ok; ++i) {
      const int* row = var_of + i * dmax;
      int par = syn[i * sB + b] > 0.5f ? 1 : 0;
      for (int k = 0; k < dmax; ++k) {
        const int v = row[k];
        if (v >= 0 && post[v * sB + b] < 0.0f) par ^= 1;
      }
      ok = par == 0;
    }
    if (ok) {
      it_lat = it + 1;
      done = true;
    }
  }
  n_iter[b] = it_lat;
  conv[b] = done ? 1 : 0;
}

template <int KIND>
cudaError_t launch(const float* syn, int B, float lch, float beta,
                   float clamp, int max_iter, int m, int n, int dmax,
                   int n_runs, const int* var_of, const int* run_ptr,
                   const int* run_shared, float* c2v, float* acc, float* post,
                   int* n_iter, uint8_t* conv, cudaStream_t stream) {
  const int threads = 32;  // one warp per block: spreads B shots over SMs
  const int blocks = (B + threads - 1) / threads;
  const size_t table = sizeof(int) * (size_t)m * (size_t)dmax;
  const int in_shared = table <= kMaxSharedTable ? 1 : 0;
  general_h_kernel<KIND><<<blocks, threads, in_shared ? table : 0, stream>>>(
      syn, B, lch, beta, clamp, max_iter, m, n, dmax, n_runs, in_shared,
      var_of, run_ptr, run_shared, c2v, acc, post, n_iter, conv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* general_h_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

// kind: 0 = MS, 1 = BP; beta: the MS normalization; clamp: BP's 1 - eps as
// float32. syn: (m, B) float32 0/1; var_of: (m, dmax) int32, -1 pads;
// run_ptr: (n_runs + 1,) int32 layer boundaries; run_shared: (n_runs,) int32,
// 1 where rows of the layer share a variable (all on the device); c2v:
// (m * dmax, B) float32 scratch; acc: (n, B) float32 scratch, may be null
// when no run is shared; post: (n, B) posterior out; n_iter: (B,) int32 out;
// conv: (B,) uint8 out. Launches on `stream` and returns cudaGetLastError()
// after the launch.
int general_h_decode(const void* syn, int B, int kind, float lch, float beta,
                     float clamp, int max_iter, int m, int n, int dmax,
                     int n_runs, const void* var_of, const void* run_ptr,
                     const void* run_shared, void* c2v, void* acc, void* post,
                     void* n_iter, void* conv, void* stream) {
  if (B <= 0) return 0;
#define QLDPC_GH_ARGS                                                        \
  (const float*)syn, B, lch, beta, clamp, max_iter, m, n, dmax, n_runs,      \
      (const int*)var_of, (const int*)run_ptr, (const int*)run_shared,       \
      (float*)c2v, (float*)acc, (float*)post, (int*)n_iter, (uint8_t*)conv,  \
      (cudaStream_t)stream
  if (kind == kMS) return (int)launch<kMS>(QLDPC_GH_ARGS);
  if (kind == kBP) return (int)launch<kBP>(QLDPC_GH_ARGS);
#undef QLDPC_GH_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
