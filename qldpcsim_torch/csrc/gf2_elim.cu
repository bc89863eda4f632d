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
// tags only for the first r rows, sel the selected columns.
//
// Design: one warp per shot, one warp per block. The shot's fused rows
// (basis words | tag words, r x (mW + rW) uint32: 232 x 16 x 4 B = 14.8 KB
// on lp118_0) and a map from check position to the row that holds its
// pivot (32 mW ints) live in shared memory; lane q owns word q of every
// row. Per column j:
//   1. fold: for each set bit p of the raw column (a few on an LDPC code),
//      the row whose pivot is p (if any) is XORed into the lanes' words.
//      These are exactly the rows whose pivot the raw column covers, which
//      the reference folds: rows of an RREF basis are zero at each other's
//      pivots, so the raw column's bits decide, not the partly reduced one.
//   2. pivot: the lowest set bit of the first nonzero basis word (ballot,
//      shuffle, __ffs), as at osd.py:148-152; a zero column is dependent.
//   3. the new row gets its tag self-bit at slot cnt;
//   4. back-elimination: 32 rows at a time, each lane tests one row's bit
//      at the new pivot, and the warp XORs the new row into the hit rows;
//   5. the row is inserted at slot cnt, its pivot recorded, sel[j] set.
// The shot leaves its loop at cnt == r; the least-reliable order reaches
// rank after r plus a small slack of columns, which is where the reference
// exits too.
//
// What bounds it on an H100: latency. Each column is a dependent chain of
// about ten warp steps (loads, ballots, shuffles, shared-memory XORs) of a
// few dozen cycles each, for a few hundred columns per shot, and only as
// many warps run as there are decoder-failed shots in an OSD window (up to
// 256, on 132 SMs). The state never leaves shared memory, and device memory
// sees only the columns (n x mW words per shot, read once) and the outputs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <int NQ>  // words per lane: mW + rW <= 32 * NQ
__global__ void gf2_elim_kernel(const uint32_t* __restrict__ cols, int B,
                                int n, int mW, int r, int rW,
                                uint32_t* __restrict__ tags,
                                int* __restrict__ pivots,
                                uint8_t* __restrict__ sel) {
  extern __shared__ uint32_t smem[];
  const int bw = mW + rW;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // a whole warp leaves; no block-wide barrier follows
  uint32_t* rows = smem + (size_t)warp * ((size_t)r * bw + 32 * mW);
  int* pivrow = reinterpret_cast<int*>(rows + (size_t)r * bw);
  for (int p = lane; p < 32 * mW; p += 32) pivrow[p] = -1;
  __syncwarp();

  const uint32_t* colb = cols + (size_t)b * n * mW;
  int cnt = 0;
  for (int j = 0; j < n && cnt < r; ++j) {
    const uint32_t* col = colb + (size_t)j * mW;
    // 1. fold the rows whose pivots the raw column covers
    uint32_t acc[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int q = lane + 32 * i;
      acc[i] = q < mW ? col[q] : 0u;
    }
    for (int w = 0; w < mW; ++w) {
      uint32_t word = col[w];  // the same word for every lane: a broadcast
      while (word) {
        const int k = pivrow[32 * w + __ffs(word) - 1];
        word &= word - 1;
        if (k >= 0) {
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            const int q = lane + 32 * i;
            if (q < bw) acc[i] ^= rows[(size_t)k * bw + q];
          }
        }
      }
    }
    // 2. the new pivot: lowest set bit of the first nonzero basis word
    int piv = -1;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int q = lane + 32 * i;
      const unsigned nz = __ballot_sync(kFull, q < mW && acc[i] != 0u);
      if (piv < 0 && nz) {
        const int src = __ffs(nz) - 1;
        const uint32_t word = __shfl_sync(kFull, acc[i], src);
        piv = (32 * i + src) * 32 + __ffs(word) - 1;
      }
    }
    if (piv < 0) continue;  // dependent column (uniform across the warp)
    // 3. tag self-bit of slot cnt
#pragma unroll
    for (int i = 0; i < NQ; ++i)
      if (lane + 32 * i == mW + (cnt >> 5)) acc[i] ^= 1u << (cnt & 31);
    // 4. back-eliminate the new pivot from rows 0 .. cnt-1
    const int pw = piv >> 5;
    const uint32_t pbit = 1u << (piv & 31);
    for (int k0 = 0; k0 < cnt; k0 += 32) {
      const int k = k0 + lane;
      const bool hit = k < cnt && (rows[(size_t)k * bw + pw] & pbit);
      unsigned m = __ballot_sync(kFull, hit);
      while (m) {
        const int kk = k0 + __ffs(m) - 1;
        m &= m - 1;
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          const int q = lane + 32 * i;
          if (q < bw) rows[(size_t)kk * bw + q] ^= acc[i];
        }
      }
      __syncwarp();
    }
    // 5. insert at slot cnt
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int q = lane + 32 * i;
      if (q < bw) rows[(size_t)cnt * bw + q] = acc[i];
    }
    if (lane == 0) {
      pivrow[piv] = cnt;
      pivots[(size_t)b * r + cnt] = piv;
      sel[(size_t)b * n + j] = 1;
    }
    ++cnt;
    __syncwarp();
  }
  // the tag half of the first cnt rows (the wrapper zeroed the rest)
  for (int e = lane; e < cnt * rW; e += 32) {
    const int k = e / rW;
    const int t = e - k * rW;
    tags[((size_t)b * r + k) * rW + t] = rows[(size_t)k * bw + mW + t];
  }
}

template <int NQ>
cudaError_t launch(const uint32_t* cols, int B, int n, int mW, int r, int rW,
                   uint32_t* tags, int* pivots, uint8_t* sel,
                   cudaStream_t stream) {
  const int warps = 1;  // one shot per block: spreads a window over the SMs
  const size_t shmem =
      sizeof(uint32_t) * warps * ((size_t)r * (mW + rW) + 32 * (size_t)mW);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf2_elim_kernel<NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (e != cudaSuccess) return e;
  }
  gf2_elim_kernel<NQ><<<(B + warps - 1) / warps, 32 * warps, shmem, stream>>>(
      cols, B, n, mW, r, rW, tags, pivots, sel);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gf2_elim_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

// cols: (B, n, mW) uint32 packed permuted columns; tags: (B, r, rW) uint32
// out, zeroed by the caller; pivots: (B, r) int32 out, filled with -1 by the
// caller; sel: (B, n) uint8 out, zeroed by the caller. Launches on `stream`
// and returns cudaGetLastError() after the launch.
int gf2_elim(const void* cols, int B, int n, int mW, int r, int rW,
             void* tags, void* pivots, void* sel, void* stream) {
  if (B <= 0) return 0;
#define QLDPC_GF2_ARGS                                                      \
  (const uint32_t*)cols, B, n, mW, r, rW, (uint32_t*)tags, (int*)pivots,    \
      (uint8_t*)sel, (cudaStream_t)stream
  const int bw = mW + rW;
  if (bw <= 32) return (int)launch<1>(QLDPC_GF2_ARGS);
  if (bw <= 64) return (int)launch<2>(QLDPC_GF2_ARGS);
  if (bw <= 128) return (int)launch<4>(QLDPC_GF2_ARGS);
#undef QLDPC_GF2_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
