// Batched GF(2) elimination for OSD (kernel C of qldpcsim_torch).
//
// Replaces two TPU kernels that share one contract and give bit-identical
// outputs: qldpcsim_tpu/ops/gf2_elim_panel_pallas.py::make_eliminate_panel
// (the reference's default) and qldpcsim_tpu/ops/gf2_elim_pallas.py::
// make_eliminate_pallas. Per shot it sweeps the permuted packed columns of
// H in order and keeps an RREF basis of the independent ones, with tags
// saying which selected columns sum to each basis row (see
// ops/gf2_elim_cuda.py); it stops at rank r. Outputs equal the reference's
// XLA sweep (decoders/osd.py:129-199) bit for bit: pivots -1 where unset,
// tags only for the first r rows, sel the selected columns. XOR is
// associative and commutative, so the order in which rows are updated does
// not change a bit of the result.
//
// Design: a block of T threads per shot (T from ops/gf2_elim_cuda.plan:
// a thread per basis row, 128 to 512; 256 on lp118_0). The shot's basis
// rows (check words | tag words, bw = mW + rW words, stored at an odd row
// stride so that threads walking rows side by side hit distinct banks) live
// in shared memory, or, when r x stride words exceed a block's 232,448
// bytes, in a device-memory scratch of the wrapper's (template GMEM); the
// map from check position to the row holding that pivot, the new row and a
// double-buffered copy of the raw column always live in shared memory. Per
// column j:
//   A. warp 0 folds into the new row the rows whose pivots the raw column
//      covers (rows of an RREF basis are zero at each other's pivots, so the
//      raw column's bits decide), a lane per word, four row loads in flight;
//      finds the pivot, the lowest set bit of the first nonzero check word,
//      by a ballot; sets the tag self-bit of slot cnt and stores the row in
//      shared memory. The other warps meanwhile load column j + 1 into the
//      other buffer.
//   barrier; a dependent column (no pivot) ends here.
//   D. back-elimination in one step: a thread per basis row (or `lanes`
//      threads per row, a word each, the alternative mapping) tests its
//      row's bit at the pivot and XORs in the new row, eight words of loads
//      in flight, the new row's words read as shared-memory broadcasts; all
//      hit rows at once. The new row goes in at slot cnt.
//   barrier.
// The shot leaves its loop at cnt == r; the least-reliable order reaches
// rank after r plus a small slack of columns, which is where the reference
// exits too.
//
// What bounds it on an H100: latency. A column is a chain of a dozen or so
// dependent shared-memory and warp steps and two barriers, and only as many
// blocks run as there are decoder-failed shots in an OSD window (up to 256
// on 132 SMs). Device memory sees the columns (n x mW words per shot, read
// once), the outputs and, for a basis beyond shared memory, the scratch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // shared memory a block can use (227 KB)

// shared words besides the basis: pivot map, new row, two column buffers
// and the two pivot slots
__host__ __device__ inline size_t aux_words(int mW, int stride) {
  return 32 * (size_t)mW + stride + 2 * (size_t)mW + 2;
}

// XOR into acc word w of the rows k held by the lanes of mask hm (a row
// per lane), four loads in flight at a time.
__device__ __forceinline__ uint32_t fold_rows(uint32_t acc, unsigned hm,
                                              int k, int w, int bw,
                                              const uint32_t* rows,
                                              int stride) {
  while (hm) {
    uint32_t x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int src = hm ? __ffs(hm) - 1 : -1;
      hm &= hm - 1;
      const int kk = __shfl_sync(kFull, k, src < 0 ? 0 : src);
      x[u] = src >= 0 && w < bw ? rows[(size_t)kk * stride + w] : 0u;
    }
    acc ^= (x[0] ^ x[1]) ^ (x[2] ^ x[3]);
  }
  return acc;
}

// A lane's raw check word (word q of a column): the rows holding the pivots
// of its lowest two set bits (-1 where none); clears those bits.
__device__ __forceinline__ void pivot_rows(uint32_t& word, int q,
                                           const int* pivrow, int (&k)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    k[h] = -1;
    if (word) {
      k[h] = pivrow[32 * q + __ffs(word) - 1];
      word &= word - 1;
    }
  }
}

template <bool GMEM, bool PAIR>
__global__ void __launch_bounds__(1024)
    gf2_elim_kernel(const uint32_t* __restrict__ cols, int n, int mW, int r,
                    int rW, int stride, int lanes, uint32_t* scratch,
                    uint32_t* __restrict__ tags, int* __restrict__ pivots,
                    uint8_t* __restrict__ sel) {
  extern __shared__ uint32_t smem[];
  const int bw = mW + rW;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const size_t b = blockIdx.x;
  uint32_t* rows = GMEM ? scratch + b * (size_t)r * stride : smem;
  uint32_t* aux = GMEM ? smem : smem + (size_t)r * stride;
  int* pivrow = reinterpret_cast<int*>(aux);      // 32 mW
  uint32_t* newrow = aux + 32 * mW;               // stride
  uint32_t* colbuf = newrow + stride;             // 2 x mW
  int* s_piv = reinterpret_cast<int*>(colbuf + 2 * mW);  // 2

  const uint32_t* colb = cols + b * (size_t)n * mW;
  for (int p = tid; p < 32 * mW; p += nt) pivrow[p] = -1;
  for (int q = tid; q < mW; q += nt) colbuf[q] = colb[q];
  __syncthreads();

  int cnt = 0;
  for (int j = 0; j < n && cnt < r; ++j) {
    const uint32_t* cur = colbuf + (j & 1) * mW;
    if (tid < 32) {
      // A. fold, pivot, tag self-bit; lanes own words lane + 32 i
      int piv = -1;
      for (int w0 = 0; w0 < bw; w0 += 32) {
        const int w = w0 + lane;
        uint32_t acc = w < mW ? cur[w] : 0u;
        for (int q0 = 0; q0 < mW; q0 += 32) {
          // each lane walks the set bits of its own raw check word, two a
          // round, and looks up the rows holding those pivots; the warp
          // then XORs the hit rows in
          uint32_t word = q0 + lane < mW ? cur[q0 + lane] : 0u;
          while (__any_sync(kFull, word != 0u)) {
            int k[2];
            pivot_rows(word, q0 + lane, pivrow, k);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              acc = fold_rows(acc, __ballot_sync(kFull, k[h] >= 0), k[h], w,
                              bw, rows, stride);
          }
        }
        if (piv < 0 && w0 < mW) {
          const unsigned nz = __ballot_sync(kFull, w < mW && acc != 0u);
          if (nz) {
            const int src = __ffs(nz) - 1;
            const uint32_t word = __shfl_sync(kFull, acc, src);
            piv = (w0 + src) * 32 + __ffs(word) - 1;
          }
        }
        // the tag words follow every check word, so piv is final here
        if (piv >= 0 && w - mW == (cnt >> 5)) acc ^= 1u << (cnt & 31);
        if (w < bw) newrow[w] = acc;
      }
      if (lane == 0) s_piv[j & 1] = piv;
    } else {
      // prefetch column j + 1 into the other buffer
      if (j + 1 < n) {
        uint32_t* nxt = colbuf + ((j + 1) & 1) * mW;
        const uint32_t* src = colb + (size_t)(j + 1) * mW;
        for (int q = tid - 32; q < mW; q += nt - 32) nxt[q] = src[q];
      }
    }
    __syncthreads();
    const int piv = s_piv[j & 1];
    if (piv < 0) continue;  // dependent column (uniform across the block)
    // D. back-eliminate the new pivot from rows 0 .. cnt-1
    const int pw = piv >> 5;
    const uint32_t pbit = 1u << (piv & 31);
    if (!PAIR) {
      for (int k = tid; k < cnt; k += nt) {
        uint32_t* row = rows + (size_t)k * stride;
        if (row[pw] & pbit) {
          // eight words at a time: all loads issued before the stores
          for (int w0 = 0; w0 < bw; w0 += 8) {
            uint32_t a[8], c[8];
#pragma unroll
            for (int q = 0; q < 8; ++q)
              if (w0 + q < bw) {
                a[q] = row[w0 + q];
                c[q] = newrow[w0 + q];
              }
#pragma unroll
            for (int q = 0; q < 8; ++q)
              if (w0 + q < bw) row[w0 + q] = a[q] ^ c[q];
          }
        }
      }
    } else {
      // `lanes` threads per row (a power of two <= 32: a row never spans
      // two warps), word w on lane w mod lanes; the hit bit is read by all
      // lanes of the row before any of them writes
      const int sub = tid & (lanes - 1);
      const int per_pass = nt / lanes;
      for (int k0 = 0; k0 < cnt; k0 += per_pass) {
        const int k = k0 + tid / lanes;
        uint32_t* row = rows + (size_t)k * stride;
        const bool hit = k < cnt && (row[pw] & pbit);
        __syncwarp();
        if (hit)
          for (int w = sub; w < bw; w += lanes) row[w] ^= newrow[w];
      }
    }
    // insert at slot cnt
    for (int w = tid; w < bw; w += nt)
      rows[(size_t)cnt * stride + w] = newrow[w];
    if (tid == 0) {
      pivrow[piv] = cnt;
      pivots[b * r + cnt] = piv;
      sel[b * n + j] = 1;
    }
    ++cnt;
    __syncthreads();
  }
  // the tag half of the first cnt rows (the wrapper zeroed the rest)
  for (int e = tid; e < cnt * rW; e += nt) {
    const int k = e / rW;
    const int t = e - k * rW;
    tags[(b * r + k) * rW + t] = rows[(size_t)k * stride + mW + t];
  }
}

template <bool GMEM, bool PAIR>
cudaError_t launch(const uint32_t* cols, int B, int n, int mW, int r, int rW,
                   int stride, int threads, int lanes, uint32_t* scratch,
                   uint32_t* tags, int* pivots, uint8_t* sel,
                   cudaStream_t stream) {
  const size_t shmem =
      sizeof(uint32_t) * ((GMEM ? 0 : (size_t)r * stride) +
                          aux_words(mW, stride));
  if (shmem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = gf2_elim_kernel<GMEM, PAIR>;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, threads, shmem, stream>>>(cols, n, mW, r, rW, stride, lanes,
                                        scratch, tags, pivots, sel);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gf2_elim_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

// cols: (B, n, mW) uint32 packed permuted columns; tags: (B, r, rW) uint32
// out, zeroed by the caller; pivots: (B, r) int32 out, filled with -1 by the
// caller; sel: (B, n) uint8 out, zeroed by the caller. stride (>= mW + rW),
// threads (a multiple of 32, at most 1024), lanes (1: a thread per basis
// row in the back-elimination; else a power of two <= 32 of threads per
// row) and on_device (the basis in scratch, (B, r * stride) uint32, instead
// of shared memory) come from ops/gf2_elim_cuda.plan. Launches on `stream`
// and returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a plan it cannot run).
int gf2_elim(const void* cols, int B, int n, int mW, int r, int rW,
             int stride, int threads, int lanes, int on_device, void* scratch,
             void* tags, void* pivots, void* sel, void* stream) {
  if (B <= 0) return 0;
  if (n <= 0 || mW <= 0 || r <= 0 || rW <= 0 || stride < mW + rW ||
      threads < 64 || threads > 1024 || threads % 32 != 0 || lanes < 1 ||
      lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      (on_device && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
#define QLDPC_GF2_ARGS                                                      \
  (const uint32_t*)cols, B, n, mW, r, rW, stride, threads, lanes,           \
      (uint32_t*)scratch, (uint32_t*)tags, (int*)pivots, (uint8_t*)sel,     \
      (cudaStream_t)stream
  if (on_device)
    return (int)(lanes > 1 ? launch<true, true>(QLDPC_GF2_ARGS)
                           : launch<true, false>(QLDPC_GF2_ARGS));
  return (int)(lanes > 1 ? launch<false, true>(QLDPC_GF2_ARGS)
                         : launch<false, false>(QLDPC_GF2_ARGS));
#undef QLDPC_GF2_ARGS
}

}  // extern "C"
