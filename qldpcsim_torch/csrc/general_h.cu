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
// and the scatter an indexed store; the incidence matrices are never built.
// It computes what that kernel computes, in the same float32 order of
// operations (see ops/general_h_cuda.py); -fmad=false keeps every multiply
// and add apart, as the reference's compiled form does here (its `new` feeds
// both the stored message and `new - old`, so nothing is contracted). Kind
// BP calls the CUDA math library's tanhf and logf and divides with IEEE
// division (no fast math), as PyTorch's tanh, log and `/` do on the card, so
// it can equal its plain version.
//
// Design: a block per shot, the shot's state in shared memory, the check
// rows of a layer side by side (kernel B's design, ms_qc.cu, on check-major
// edges padded to dmax slots). Per shot the posterior (n), the messages c2v
// (m * dmax), the syndrome signs (m) and, when some layer's rows share a
// variable, the deltas of the largest such layer are loaded once; the
// posterior is written back once, shot-major. The greedy layerizer's rows
// of a layer meet disjoint variables, so every row of such a layer reads and
// writes its own posterior entries, and one barrier separates a layer from
// the next. A layer whose rows share a variable (flooding's one layer, or a
// caller's layer with run_shared set) runs in two phases: every row computes
// its new messages from the posterior as it stands (nothing writes it before
// the barrier) and keeps the deltas; then every variable gets a thread that
// sums its deltas in ascending edge order from 0 (the column table) and adds
// the sum to the posterior once: this kernel's association, not kernel B's,
// which adds the deltas one by one. No float atomics. The hard decision's
// syndrome is tested once per iteration, every row's parity at once, and a
// block-wide vote ends the shot's loop.
//
// Two mappings of a layer's rows onto threads, chosen by the wrapper from
// the tables when the decoder is built (EDGE, a template parameter):
//  - a thread per edge, a check row's slots on 2, 4, 8, 16 or 32 lanes side
//    by side (dmax rounded up): MS's min/min2 is a selection and its parity
//    a count of small integers, so a butterfly of shuffles gives the bits of
//    the reference's fold; BP's running `prod = sign_floor(prod * t,
//    1e-30)` rounds at every step, so each lane takes its own tanhf, logf and
//    division and repeats the left fold in slot order over the row's
//    shuffled t values (a pad's t of 1 leaves prod as it is). For layers of
//    tens of rows (a layered schedule: 16 to 32 rows, 128 to 256 edges on
//    the permuted lp118_0), where it divides a lone shot's chain of dependent
//    instructions by the row's degree.
//  - a thread per check row, its slots in sequence: the reference's loop as
//    it stands, in two passes over the row (minima or product first, messages
//    second, the state re-read from shared memory). For layers of hundreds of
//    rows (flooding: 240) and for rows of more than 32 slots.
// Threads per shot: one per edge (lanes per row x rows) or per row of the
// largest layer, in whole warps, up to 256; a thread per edge when that
// layer's edges fit two passes of 256 threads.
//
// Tables: var_of (m * dmax), the layer bounds and, when a layer's rows share
// a variable, the column table (col_ptr (n + 1), col_edge: each variable's
// edges in ascending order) are copied into shared memory once per block
// when they fit there beside the state (tables_in_shared, decided from the
// tables when the decoder is built); else every block reads the same words
// from device memory, where the L2 cache and L1 hold them (they are a few
// hundred KB at most for a code whose state still fits a block). Shared
// memory goes to the state first because every edge update reads and writes
// it, while the tables are only read.
//
// A code whose per-shot state exceeds a block's 232,448 bytes runs the same
// mapping with the state in device memory (GMEM, a template parameter chosen
// by the wrapper from the tables when the decoder is built; shot-major
// scratch, so a shot's threads touch neighbouring words).
//
// What bounds it on an H100: not bytes (a shot reads m floats and writes n)
// nor operations (1,920 edges x 15 (MS) or 71 (BP) per iteration on the
// permuted lp118_0: microseconds for a 4,096-shot launch) but, within a
// shot, the chain of dependent layers: 11 barriers per iteration on the
// permuted lp118_0 under L, each a few hundred cycles for a block whose
// dependent instructions nothing hides; and a launch lasts as long as its
// slowest shot. No tensor cores and no TMA: compare, select and
// transcendental work on state that never leaves the SM.
// Measured on an NVIDIA H100 80GB HBM3 (700 W) by chip_smoke.py on the
// permuted lp118_0, ms, mapping / threads per shot (PERF.md has the table;
// one thread per shot, the design before this one, in brackets): MS-L, the
// cascade's head (4,096 shots, 4 iterations) edge/256 0.237, row/256 0.360
// (5.236); its last stage (128 shots, 50 iterations) edge/256 0.294,
// row/256 0.797; 4,096 shots at 50 iterations edge/256 0.625 (44.1); a lone
// shot 5.7 us per iteration edge/256, 15.8 row/256 (427). MS-F, 4,096 x 50
// row/256 0.737, edge/256 0.645 (72.3); its last stage row 0.225, edge
// 0.251; a lone shot 4.4 and 4.9 us. The state in device memory costs 8-20 %
// under a thread per edge and up to 2x under a thread per row. Left for
// later: both sides in one launch.

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
  const float* syn;  // (m, B): element (row, shot) at row * B + shot
  int B;
  float lch, beta, clamp;
  int max_iter, m, n, dmax, n_runs;
  int n_col;          // entries of the column table (0: no shared layer)
  int delta_edges;    // edge slots of the largest shared layer (or 0)
  int lanes;          // lanes per check row of the thread-per-edge mapping
  int tables_in_shared;
  const int *var_of, *run_ptr, *run_shared, *col_ptr, *col_edge;
  float* state;  // GMEM: (B, state words) scratch, else unused
  float* post;   // (B, n) out
  int* n_iter;   // (B,) out
  uint8_t* conv; // (B,) out
};

__host__ __device__ inline int state_words(int m, int n, int dmax,
                                           int delta_edges) {
  return n + m * dmax + delta_edges + m;
}

__host__ __device__ inline int table_words(int m, int n, int dmax,
                                           int n_runs, int n_col) {
  return m * dmax + 2 * n_runs + 1 + (n_col > 0 ? n + 1 + n_col : 0);
}

// GMEM: the shots' state in device memory instead of shared memory; EDGE:
// a thread per edge (lanes side by side per check row) instead of a thread
// per check row.
template <int KIND, bool GMEM, bool EDGE>
__global__ void general_h_kernel(const Args a) {
  extern __shared__ float smem[];
  const int m = a.m, n = a.n, dmax = a.dmax, R = a.n_runs;
  const int E = m * dmax;
  const int T = blockDim.x;  // threads of this shot
  const int t = threadIdx.x;
  const long long shot = blockIdx.x;
  const int words = state_words(m, n, dmax, a.delta_edges);
  float* st = GMEM ? a.state + shot * words : smem;
  float* post = st;                   // n
  float* c2v = post + n;              // E: edge i * dmax + k
  float* dbuf = c2v + E;              // delta_edges: a shared layer's deltas
  float* ssign = dbuf + a.delta_edges;  // m: 1 - 2 syndrome

  const int* var_of = a.var_of;
  const int* run_ptr = a.run_ptr;
  const int* run_shared = a.run_shared;
  const int* col_ptr = a.col_ptr;
  const int* col_edge = a.col_edge;
  if (a.tables_in_shared) {
    int* tab = (int*)(GMEM ? smem : smem + words);
    int* s_var_of = tab;                  // E
    int* s_run_ptr = s_var_of + E;        // R + 1
    int* s_run_shared = s_run_ptr + R + 1;  // R
    int* s_col_ptr = s_run_shared + R;    // n + 1 when n_col > 0
    int* s_col_edge = s_col_ptr + n + 1;  // n_col
    for (int q = t; q < E; q += T) s_var_of[q] = a.var_of[q];
    for (int q = t; q <= R; q += T) s_run_ptr[q] = a.run_ptr[q];
    for (int q = t; q < R; q += T) s_run_shared[q] = a.run_shared[q];
    var_of = s_var_of;
    run_ptr = s_run_ptr;
    run_shared = s_run_shared;
    if (a.n_col > 0) {
      for (int q = t; q <= n; q += T) s_col_ptr[q] = a.col_ptr[q];
      for (int q = t; q < a.n_col; q += T) s_col_edge[q] = a.col_edge[q];
      col_ptr = s_col_ptr;
      col_edge = s_col_edge;
    }
  }
  for (int v = t; v < n; v += T) post[v] = a.lch;
  for (int e = t; e < E; e += T) c2v[e] = 0.0f;
  for (int row = t; row < m; row += T)
    ssign[row] = 1.0f - 2.0f * a.syn[(long long)row * a.B + shot];
  __syncthreads();

  int it_lat = a.max_iter;
  bool done = false;
  for (int it = 0; it < a.max_iter && !done; ++it) {
    for (int l = 0; l < R; ++l) {
      const int r0 = run_ptr[l], r1 = run_ptr[l + 1];
      const bool shared_vars = run_shared[l] != 0;
      const int e0 = r0 * dmax;
      if constexpr (EDGE) {
        // one edge per thread, a row's lanes side by side; the trip count
        // is the same for all threads of the shot: the shuffles need the
        // whole warp
        const int lanes = a.lanes;
        const int lane = t & 31;
        const int d = lane & (lanes - 1);
        const int seg = lane - d;  // first lane of this row's slots
        const int per_pass = T / lanes;
        for (int q0 = r0; q0 < r1; q0 += per_pass) {
          const int row = q0 + t / lanes;
          const int e = row * dmax + d;
          const int v = (row < r1 && d < dmax) ? var_of[e] : -1;
          const bool on = v >= 0;
          float pos = 0.0f, old = 0.0f, V = 0.0f;
          if (on) {
            pos = post[v];
            old = c2v[e];
            V = pos - old;
          }
          float nw = 0.0f;
          if constexpr (KIND == kMS) {
            const float av = on ? fabsf(V) : kBig;
            const bool neg = on && V < 0.0f;
            float m1 = av, m2 = kBig;
            for (int off = lanes >> 1; off > 0; off >>= 1) {
              const float b1 = __shfl_xor_sync(kFull, m1, off);
              const float b2 = __shfl_xor_sync(kFull, m2, off);
              m2 = fminf(fmaxf(m1, b1), fminf(m2, b2));
              m1 = fminf(m1, b1);
            }
            unsigned negs = __ballot_sync(kFull, neg);
            if (lanes < 32) negs = (negs >> seg) & ((1u << lanes) - 1u);
            if (on) {
              const float neg_par = (float)__popc(negs);
              if (m1 >= kBig) m1 = 0.0f;
              if (m2 >= kBig) m2 = 0.0f;
              const float par = neg_par - 2.0f * floorf(neg_par * 0.5f);
              const float coef = (a.beta * ssign[row]) * (1.0f - 2.0f * par);
              const float sign = 1.0f - 2.0f * (neg ? 1.0f : 0.0f);
              const float mag = (av == m1) ? m2 : m1;
              nw = (coef * sign) * mag;
            }
          } else {
            const float tt = on ? sign_floor(tanhf(V * 0.5f), 1e-12f) : 1.0f;
            float prod = 1.0f;
            for (int dd = 0; dd < dmax; ++dd) {
              const float td = __shfl_sync(kFull, tt, seg + dd);
              prod = sign_floor(prod * td, 1e-30f);
            }
            if (on) {
              const float th2 = fminf(fmaxf(prod / tt, -a.clamp), a.clamp);
              nw = ssign[row] * logf((1.0f + th2) / (1.0f - th2));
            }
          }
          if (on) {
            const float delta = nw - old;
            c2v[e] = nw;
            if (shared_vars) {
              dbuf[e - e0] = delta;
            } else {
              post[v] = pos + delta;
            }
          }
        }
      } else {
        // one check row per thread; a layer's rows write disjoint variables
        // (no sharing) or only their own messages and deltas (sharing)
        for (int row = r0 + t; row < r1; row += T) {
          const int* rv = var_of + row * dmax;
          const int er = row * dmax;
          const float ss = ssign[row];
          // pass 1 over the row's slots: minima and sign parity (MS) or the
          // running product (BP); a pad slot leaves all of them as they are
          float m1 = kBig, m2 = kBig, neg_par = 0.0f, prod = 1.0f;
          for (int k = 0; k < dmax; ++k) {
            const int v = rv[k];
            if (v < 0) continue;
            const float V = post[v] - c2v[er + k];
            if constexpr (KIND == kMS) {
              const float av = fabsf(V);
              neg_par = neg_par + (V < 0.0f ? 1.0f : 0.0f);
              const bool is_new = av < m1;
              m2 = is_new ? m1 : fminf(m2, av);
              m1 = fminf(m1, av);
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
            coef = (a.beta * ss) * (1.0f - 2.0f * par);
          }
          // pass 2: the extrinsic message of each slot, its write-back, and
          // its delta into the posterior (or into the layer's deltas)
          for (int k = 0; k < dmax; ++k) {
            const int v = rv[k];
            if (v < 0) continue;
            const float pos = post[v];
            const float old = c2v[er + k];
            const float V = pos - old;
            float nw;
            if constexpr (KIND == kMS) {
              const float sign = 1.0f - 2.0f * (V < 0.0f ? 1.0f : 0.0f);
              const float mag = (fabsf(V) == m1) ? m2 : m1;
              nw = (coef * sign) * mag;
            } else {
              const float tk = sign_floor(tanhf(V * 0.5f), 1e-12f);
              const float th2 = fminf(fmaxf(prod / tk, -a.clamp), a.clamp);
              nw = ss * logf((1.0f + th2) / (1.0f - th2));
            }
            const float delta = nw - old;
            c2v[er + k] = nw;
            if (shared_vars) {
              dbuf[er + k - e0] = delta;
            } else {
              post[v] = pos + delta;
            }
          }
        }
      }
      __syncthreads();
      if (shared_vars) {
        // one variable per thread: its deltas in the layer summed in
        // ascending edge order from 0, then one add into the posterior
        const int e1 = r1 * dmax;
        for (int v = t; v < n; v += T) {
          float acc = 0.0f;
          bool met = false;
          for (int c = col_ptr[v]; c < col_ptr[v + 1]; ++c) {
            const int e = col_edge[c];
            if (e < e0) continue;
            if (e >= e1) break;
            acc = acc + dbuf[e - e0];
            met = true;
          }
          if (met) post[v] = post[v] + acc;
        }
        __syncthreads();
      }
    }
    // the hard decision's syndrome against the shot's, once per iteration
    bool bad = false;
    for (int row = t; row < m; row += T) {
      const int* rv = var_of + row * dmax;
      int par = ssign[row] < 0.0f ? 1 : 0;
      for (int k = 0; k < dmax; ++k) {
        const int v = rv[k];
        if (v >= 0 && post[v] < 0.0f) par ^= 1;
      }
      bad |= par != 0;
    }
    if (!__syncthreads_or(bad)) {
      it_lat = it + 1;
      done = true;
    }
  }
  for (int v = t; v < n; v += T) a.post[shot * n + v] = post[v];
  if (t == 0) {
    a.n_iter[shot] = it_lat;
    a.conv[shot] = done ? 1 : 0;
  }
}

template <int KIND, bool GMEM, bool EDGE>
cudaError_t launch(const Args& a, int threads, cudaStream_t stream) {
  const size_t words =
      (GMEM ? 0 : (size_t)state_words(a.m, a.n, a.dmax, a.delta_edges)) +
      (a.tables_in_shared
           ? (size_t)table_words(a.m, a.n, a.dmax, a.n_runs, a.n_col)
           : 0);
  const size_t shmem = sizeof(float) * words;
  if (shmem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = general_h_kernel<KIND, GMEM, EDGE>;
  if (shmem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<a.B, threads, shmem, stream>>>(a);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t dispatch(const Args& a, bool gmem, bool edge, int threads,
                     cudaStream_t stream) {
  if (gmem)
    return edge ? launch<KIND, true, true>(a, threads, stream)
                : launch<KIND, true, false>(a, threads, stream);
  return edge ? launch<KIND, false, true>(a, threads, stream)
              : launch<KIND, false, false>(a, threads, stream);
}

}  // namespace

extern "C" {

const char* general_h_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

// kind: 0 = MS, 1 = BP; beta: the MS normalization; clamp: BP's 1 - eps as
// float32. syn: (m, B) float32 0/1; var_of: (m, dmax) int32, -1 pads;
// run_ptr: (n_runs + 1,) int32 layer boundaries; run_shared: (n_runs,) int32,
// 1 where rows of the layer share a variable; col_ptr (n + 1,) and col_edge
// (n_col,) int32: the edges of each variable in ascending order
// (GHTables.col_edges(); n_col 0 and both may be null when no layer is
// shared); delta_edges: the edge slots of the largest shared layer (0 when
// there is none); all tables on the device. per_edge: 1 for a thread per
// edge (dmax at most 32), 0 for a thread per check row. threads: the threads
// of a shot's block, a multiple of 32 up to 1024. tables_in_shared: 1 to
// copy the tables into shared memory beside the state. state: null for the
// shots' state in shared memory, or (B, words) float32 scratch in device
// memory, words = n + m * dmax + delta_edges + m. post: (B, n) posterior
// out, shot-major; n_iter: (B,) int32 out; conv: (B,) uint8 out. Launches on
// `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a mapping, a thread count or a shared-memory
// size it cannot run).
int general_h_decode(const void* syn, int B, int kind, float lch, float beta,
                     float clamp, int max_iter, int m, int n, int dmax,
                     int n_runs, int n_col, int delta_edges, int per_edge,
                     int threads, int tables_in_shared, const void* var_of,
                     const void* run_ptr, const void* run_shared,
                     const void* col_ptr, const void* col_edge, void* state,
                     void* post, void* n_iter, void* conv, void* stream) {
  if (B <= 0) return 0;
  if (threads < 32 || threads > 1024 || threads % 32 || dmax < 1)
    return (int)cudaErrorInvalidValue;
  if ((n_col > 0) != (col_ptr != nullptr && col_edge != nullptr))
    return (int)cudaErrorInvalidValue;
  int lanes = 2;
  while (lanes < dmax) lanes <<= 1;
  if (per_edge && lanes > 32) return (int)cudaErrorInvalidValue;
  Args a;
  a.syn = (const float*)syn;
  a.B = B;
  a.lch = lch;
  a.beta = beta;
  a.clamp = clamp;
  a.max_iter = max_iter;
  a.m = m;
  a.n = n;
  a.dmax = dmax;
  a.n_runs = n_runs;
  a.n_col = n_col;
  a.delta_edges = delta_edges;
  a.lanes = lanes;
  a.tables_in_shared = tables_in_shared;
  a.var_of = (const int*)var_of;
  a.run_ptr = (const int*)run_ptr;
  a.run_shared = (const int*)run_shared;
  a.col_ptr = (const int*)col_ptr;
  a.col_edge = (const int*)col_edge;
  a.state = (float*)state;
  a.post = (float*)post;
  a.n_iter = (int*)n_iter;
  a.conv = (uint8_t*)conv;
  const bool gmem = state != nullptr;
  const bool e = per_edge != 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == kMS) return (int)dispatch<kMS>(a, gmem, e, threads, s);
  if (kind == kBP) return (int)dispatch<kBP>(a, gmem, e, threads, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
