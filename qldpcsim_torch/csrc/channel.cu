// Depolarizing channel on the threefry stream, with the syndromes formed in
// the same launch (kernel A of qldpcsim_torch).
//
// Replaces the TPU kernel qldpcsim_tpu/ops/channel_pallas.py::sample_tiles_hw
// (:94, called at :157) and, fused into it, the XLA syndrome products of
// qldpcsim_tpu/channel/depolarizing.py::syndromes_of (:50). The TPU kernel
// draws from the TPU's hardware PRNG; that stream cannot exist on a GPU, so
// this kernel computes the stream that the reference uses on every other
// backend, channel/depolarizing.py::sample_shot_tiles: one
// jax.random.bits(key_t, (tile, n), uint32) draw per shot tile with
// jax_threefry_partitionable=True, i.e. for word w = r * n + col, r the row
// within tile t,
//     bits = threefry2x32(key_t, (0, w)) -> bits1 ^ bits2
// and then the depolarizing partition of [0, 2^32) by the three thresholds
// t1 = u32(p/3), t2 = u32(2p/3), t3 = u32(p), compared unsigned:
//     err_x = bits < t2              (X or Y)
//     err_z = t1 <= bits < t3        (Y or Z)
// With SYN the block then forms the syndromes sy_z = Hz err_x and
// sy_x = Hx err_z (mod 2) as XOR parities of the packed error bits, read
// through a CSR table of each H; they equal remainder(err @ H^T, 2) bit for
// bit, and the float32 0/1 outputs are what the decoders read.
//
// What bounds it on an H100. Bytes: keys, the two uint8 error arrays, the
// two float32 syndrome arrays and the tables, about 12.3 MB on the
// flagship's chunk (4096 x 544, 240 checks a side), 0.0037 ms at 3.35 TB/s.
// Operations: threefry2x32 is 20 dependent rounds of 32-bit add, rotate and
// xor, about 84 integer operations a draw; 2.2M draws issue on the SMs'
// 64 INT32 lanes a clock (half the FP32 lanes), so the realistic floor is
// 0.011-0.013 ms, not the 0.003 ms that 67 Top/s would give. The design:
//   * a block per (tile, group of S shots), S a power of two from the
//     wrapper's plan, so that the flagship chunk gives 512 blocks, not 64;
//     the tile key and its schedule are loaded once into registers; no
//     per-element division (a warp draws whole 32-bit words);
//   * each thread runs kChains independent threefry chains interleaved, a
//     rotate is one funnel shift;
//   * the block's errors live in shared memory column by column, the S
//     shots of a column side by side (bit col * S + r): a warp's lanes
//     draw S shots of 32 / S columns, and __ballot_sync packs one word of
//     err_x and one of err_z bits; lanes past n give zero bits;
//   * err_x and err_z leave shot by shot as 4-byte stores of four 0/1
//     bytes (the head and tail bytes of a row that is not 4-byte aligned
//     go one by one);
//   * the syndromes: a thread a check, the XOR of its columns' S-bit
//     fields is the check's parity in all S shots at once, so a column
//     costs one shared load and one XOR for S shots (a thread a (shot,
//     check) pair over a shot-major packing re-reads the check's columns
//     for each shot: half the kernel's time on an H100); consecutive
//     checks on consecutive threads, so the float32 stores of each shot
//     coalesce.
// The integer work cannot be changed by FMA contraction; the stream is
// bit-exact with the reference's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 4;
constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

// The tile key's schedule: threefry2x32's three key words and the five
// injections (key word, key word + round number).
struct KeySchedule {
  uint32_t k0, k1;
  uint32_t inj0[5], inj1[5];
};

__device__ __forceinline__ KeySchedule key_schedule(uint32_t k0,
                                                    uint32_t k1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t ks[3] = {k0, k1, k2};
  KeySchedule s;
  s.k0 = k0;
  s.k1 = k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    s.inj0[i] = ks[(i + 1) % 3];
    s.inj1[i] = ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return s;
}

#define QLDPC_TF_ROUND(r)                            \
  _Pragma("unroll") for (int i = 0; i < K; ++i) {    \
    x0[i] += x1[i];                                  \
    x1[i] = __funnelshift_l(x1[i], x1[i], r);        \
    x1[i] ^= x0[i];                                  \
  }

#define QLDPC_TF_INJECT(j)                           \
  _Pragma("unroll") for (int i = 0; i < K; ++i) {    \
    x0[i] += s.inj0[j];                              \
    x1[i] += s.inj1[j];                              \
  }

// K interleaved threefry2x32 draws of the counters (0, w[i]): bits1 ^ bits2.
template <int K>
__device__ __forceinline__ void threefry_bits(const KeySchedule& s,
                                              const uint32_t (&w)[K],
                                              uint32_t (&out)[K]) {
  uint32_t x0[K], x1[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    x0[i] = s.k0;
    x1[i] = w[i] + s.k1;
  }
  QLDPC_TF_ROUND(13) QLDPC_TF_ROUND(15) QLDPC_TF_ROUND(26) QLDPC_TF_ROUND(6)
  QLDPC_TF_INJECT(0)
  QLDPC_TF_ROUND(17) QLDPC_TF_ROUND(29) QLDPC_TF_ROUND(16) QLDPC_TF_ROUND(24)
  QLDPC_TF_INJECT(1)
  QLDPC_TF_ROUND(13) QLDPC_TF_ROUND(15) QLDPC_TF_ROUND(26) QLDPC_TF_ROUND(6)
  QLDPC_TF_INJECT(2)
  QLDPC_TF_ROUND(17) QLDPC_TF_ROUND(29) QLDPC_TF_ROUND(16) QLDPC_TF_ROUND(24)
  QLDPC_TF_INJECT(3)
  QLDPC_TF_ROUND(13) QLDPC_TF_ROUND(15) QLDPC_TF_ROUND(26) QLDPC_TF_ROUND(6)
  QLDPC_TF_INJECT(4)
#pragma unroll
  for (int i = 0; i < K; ++i) out[i] = x0[i] ^ x1[i];
}

#undef QLDPC_TF_ROUND
#undef QLDPC_TF_INJECT

// K units of the draw: unit u is the shared word u of each side, which
// holds the bits of the block's S shots at 32 / S consecutive columns
// (bit (col, r) at position col * S + r). Lane l draws shot r = l % S of
// column u * 32 / S + l / S; the ballots give the two words, and lane 0
// stores them.
template <int K>
__device__ __forceinline__ void draw_units(int u0, int ustep,
                                           const KeySchedule& s,
                                           uint32_t row_word0, int n,
                                           int log_s, int lane, uint32_t t1,
                                           uint32_t t2, uint32_t t3,
                                           uint32_t* xs, uint32_t* zs) {
  const int r = lane & ((1 << log_s) - 1);
  int col[K];
  uint32_t w[K], bits[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    col[i] = ((u0 + i * ustep) << (5 - log_s)) + (lane >> log_s);
    // the word index within the tile: (row in tile) * n + col
    w[i] = row_word0 + (uint32_t)r * (uint32_t)n + (uint32_t)col[i];
  }
  threefry_bits<K>(s, w, bits);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const bool in = col[i] < n;
    const uint32_t bx = __ballot_sync(kFull, in && bits[i] < t2);
    const uint32_t bz =
        __ballot_sync(kFull, in && bits[i] >= t1 && bits[i] < t3);
    if (lane == 0) {
      xs[u0 + i * ustep] = bx;
      zs[u0 + i * ustep] = bz;
    }
  }
}

// Bit `pos` of a side's packed words.
__device__ __forceinline__ uint32_t bit_at(const uint32_t* bits, int pos) {
  return (bits[pos >> 5] >> (pos & 31)) & 1u;
}

// Four 0/1 bytes of shot r at columns c .. c + 3, lowest column in the
// lowest byte. For S <= 8 the four bits lie in one 32-bit window, S apart.
__device__ __forceinline__ uint32_t four_bytes(const uint32_t* bits, int nw,
                                               int c, int r, int log_s) {
  const int S = 1 << log_s;
  const int pos = (c << log_s) + r;
  if (S <= 8) {
    const int wi = pos >> 5;
    const uint32_t hi = wi + 1 < nw ? bits[wi + 1] : 0u;
    const uint32_t win = __funnelshift_r(bits[wi], hi, pos & 31);
    return (win & 1u) | ((win >> S) & 1u) << 8 | ((win >> (2 * S)) & 1u) << 16
           | ((win >> (3 * S)) & 1u) << 24;
  }
  return bit_at(bits, pos) | bit_at(bits, pos + S) << 8
         | bit_at(bits, pos + 2 * S) << 16 | bit_at(bits, pos + 3 * S) << 24;
}

// Shot r's packed bits out as n uint8 0/1 values at `out`, by the threads
// li = li0, li0 + step, ... of the row: head bytes up to the first 4-byte
// aligned address, 4-byte words, tail bytes.
__device__ __forceinline__ void store_row(const uint32_t* __restrict__ bits,
                                          int nw, int r, int log_s,
                                          uint8_t* __restrict__ out, int n,
                                          int li0, int step) {
  const int head = min(n, (int)((4u - ((uintptr_t)out & 3u)) & 3u));
  const int body = (n - head) >> 2;
  const int tail = (n - head) & 3;
  if (li0 < head) out[li0] = (uint8_t)bit_at(bits, (li0 << log_s) + r);
  if (li0 < tail) {
    const int c = n - tail + li0;
    out[c] = (uint8_t)bit_at(bits, (c << log_s) + r);
  }
  for (int k = li0; k < body; k += step) {
    const int c = head + 4 * k;
    *reinterpret_cast<uint32_t*>(out + c) = four_bytes(bits, nw, c, r, log_s);
  }
}

// One side's syndromes of the block's S shots: a thread a check, the XOR of
// the S-bit fields of its columns (CSR row c of H: cols[rp[c] .. rp[c+1]))
// gives the check's parity for every shot at once; out[r * m + c] is shot
// r's, so consecutive threads store consecutive words.
__device__ __forceinline__ void syndromes(const uint32_t* __restrict__ bits,
                                          int log_s,
                                          const int* __restrict__ rp,
                                          const int* __restrict__ cols, int m,
                                          float* __restrict__ out) {
  const int S = 1 << log_s;
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    uint32_t acc = 0;
    const int e1 = __ldg(rp + c + 1);
    for (int e = __ldg(rp + c); e < e1; ++e) {
      const int pos = __ldg(cols + e) << log_s;
      acc ^= bits[pos >> 5] >> (pos & 31);
    }
    for (int r = 0; r < S; ++r) out[r * m + c] = (float)((acc >> r) & 1u);
  }
}

template <bool SYN>
__global__ void __launch_bounds__(kMaxThreads, 4)
    depolarizing_kernel(const uint32_t* __restrict__ keys, int tile, int n,
                        int log_s, uint32_t t1, uint32_t t2, uint32_t t3,
                        uint8_t* __restrict__ err_x,
                        uint8_t* __restrict__ err_z,
                        const int* __restrict__ rp_z,
                        const int* __restrict__ cols_z, int m_z,
                        const int* __restrict__ rp_x,
                        const int* __restrict__ cols_x, int m_x,
                        float* __restrict__ sy_z, float* __restrict__ sy_x) {
  extern __shared__ uint32_t smem[];
  const int S = 1 << log_s;
  const int nw = (n * S + 31) >> 5;  // words a side
  uint32_t* xs = smem;               // err_x bits, column-major over shots
  uint32_t* zs = smem + nw;          // err_z bits

  const int groups = tile >> log_s;  // blocks of a tile
  const int t = blockIdx.x / groups;
  const int g = blockIdx.x - t * groups;
  const long long shot0 = (long long)blockIdx.x << log_s;  // t tile + g S
  // keys: (n_tiles, 2) int64 words below 2^32; their low 32-bit halves
  const KeySchedule s =
      key_schedule(__ldg(keys + 4 * t), __ldg(keys + 4 * t + 2));

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const uint32_t row_word0 = (uint32_t)(g << log_s) * (uint32_t)n;
  int u = warp;
  for (; u + (kChains - 1) * W < nw; u += kChains * W)
    draw_units<kChains>(u, W, s, row_word0, n, log_s, lane, t1, t2, t3, xs,
                        zs);
  for (; u < nw; u += W)
    draw_units<1>(u, W, s, row_word0, n, log_s, lane, t1, t2, t3, xs, zs);
  __syncthreads();

  // errors out, shot by shot: a warp a row, or W / S warps a row
  const int wpr = W > S ? W / S : 1;
  const int li0 = (warp % wpr) * 32 + lane;
  for (int r = warp / wpr; r < S; r += W / wpr) {
    const long long off = (shot0 + r) * n;
    store_row(xs, nw, r, log_s, err_x + off, n, li0, 32 * wpr);
    store_row(zs, nw, r, log_s, err_z + off, n, li0, 32 * wpr);
  }
  if (SYN) {
    // Z-checks see X errors, X-checks see Z errors
    syndromes(xs, log_s, rp_z, cols_z, m_z, sy_z + shot0 * m_z);
    syndromes(zs, log_s, rp_x, cols_x, m_x, sy_x + shot0 * m_x);
  }
}

}  // namespace

extern "C" {

const char* channel_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

// keys: (n_tiles, 2) int64 on the device, each word below 2^32; err_x,
// err_z: (n_tiles * tile, n) uint8 on the device, row-major, at any
// address; S = 2^log_s shots a block (S divides tile, S <= 32), `threads` a
// block (whole warps, at most 256), `smem` bytes of dynamic shared memory
// (at least 8 ceil(n S / 32)). With sy_z non-null the syndromes are formed
// too: rp_z, cols_z the CSR table of Hz (m_z rows) and sy_z
// (n_tiles * tile, m_z) float32; likewise Hx and sy_x. Launches on
// `stream` and returns cudaGetLastError() after the launch.
int channel_depolarizing(const void* keys, int n_tiles, int tile, int n,
                         int log_s, int threads, int smem, unsigned t1,
                         unsigned t2, unsigned t3, void* err_x, void* err_z,
                         const void* rp_z, const void* cols_z, int m_z,
                         const void* rp_x, const void* cols_x, int m_x,
                         void* sy_z, void* sy_x, void* stream) {
  if (n_tiles <= 0 || n <= 0) return 0;
  if (log_s < 0 || log_s > 5 || tile % (1 << log_s) != 0 ||
      threads % 32 != 0 || threads <= 0 || threads > kMaxThreads ||
      (long long)smem < 8LL * ((((long long)n << log_s) + 31) / 32))
    return (int)cudaErrorInvalidValue;
  const bool syn = sy_z != nullptr;
  const unsigned blocks = (unsigned)n_tiles * (unsigned)(tile >> log_s);
  cudaStream_t st = (cudaStream_t)stream;
  if (syn) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(depolarizing_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    depolarizing_kernel<true><<<blocks, threads, smem, st>>>(
        (const uint32_t*)keys, tile, n, log_s, t1, t2, t3, (uint8_t*)err_x,
        (uint8_t*)err_z, (const int*)rp_z, (const int*)cols_z, m_z,
        (const int*)rp_x, (const int*)cols_x, m_x, (float*)sy_z,
        (float*)sy_x);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(depolarizing_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    depolarizing_kernel<false><<<blocks, threads, smem, st>>>(
        (const uint32_t*)keys, tile, n, log_s, t1, t2, t3, (uint8_t*)err_x,
        (uint8_t*)err_z, nullptr, nullptr, 0, nullptr, nullptr, 0, nullptr,
        nullptr);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
