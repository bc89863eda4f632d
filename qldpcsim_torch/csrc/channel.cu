// Depolarizing channel on the threefry stream (kernel A of qldpcsim_torch).
//
// Replaces the TPU kernel qldpcsim_tpu/ops/channel_pallas.py::sample_tiles_hw,
// which draws from the TPU's hardware PRNG. That stream cannot exist on a
// GPU, so this kernel computes the stream that the reference uses on every
// other backend, channel/depolarizing.py::sample_shot_tiles: one
// jax.random.bits(key_tile, (tile, n), uint32) draw per shot tile with
// jax_threefry_partitionable=True, i.e. for element w = r * n + col of tile t
//     bits = threefry2x32(key_t, (0, w)) -> bits1 ^ bits2
// and then the depolarizing partition of [0, 2^32) by the three thresholds
// t1 = u32(p/3), t2 = u32(2p/3), t3 = u32(p):
//     err_x = bits < t2              (X or Y)
//     err_z = t1 <= bits < t3        (Y or Z)
// The result is bit-exact with the reference's threefry path.
//
// One thread per (tile, row, column) element, grid-stride. What bounds it on
// an H100: 20 rounds of 32-bit add/rotate/xor (~110 integer ops per draw),
// not the store of 2 bytes per element; the flagship chunk (64 tiles x 64 x
// 544) is ~2.2M draws, ~0.10 ms measured on an H100 SXM (700 W), several
// times the integer-issue bound (the 64-bit tile division and byte stores
// are the suspects). The integer work cannot be changed by FMA contraction.
// The syndrome product (H err mod 2) can be fused into this kernel later, so
// that the errors never leave registers before the syndromes are formed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define QLDPC_TF_ROUND(r) \
  x0 += x1;               \
  x1 = rotl32(x1, r);     \
  x1 ^= x0;

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  QLDPC_TF_ROUND(13) QLDPC_TF_ROUND(15) QLDPC_TF_ROUND(26) QLDPC_TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  QLDPC_TF_ROUND(17) QLDPC_TF_ROUND(29) QLDPC_TF_ROUND(16) QLDPC_TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  QLDPC_TF_ROUND(13) QLDPC_TF_ROUND(15) QLDPC_TF_ROUND(26) QLDPC_TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  QLDPC_TF_ROUND(17) QLDPC_TF_ROUND(29) QLDPC_TF_ROUND(16) QLDPC_TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  QLDPC_TF_ROUND(13) QLDPC_TF_ROUND(15) QLDPC_TF_ROUND(26) QLDPC_TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

#undef QLDPC_TF_ROUND

__global__ void depolarizing_kernel(const uint32_t* __restrict__ keys,
                                    uint32_t per_tile, uint64_t total,
                                    uint32_t t1, uint32_t t2, uint32_t t3,
                                    uint8_t* __restrict__ err_x,
                                    uint8_t* __restrict__ err_z) {
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  for (uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const uint64_t tile = i / per_tile;
    const uint32_t w = (uint32_t)(i - tile * per_tile);
    const uint32_t bits =
        threefry_bits(__ldg(keys + 2 * tile), __ldg(keys + 2 * tile + 1), 0u, w);
    err_x[i] = (uint8_t)(bits < t2);
    err_z[i] = (uint8_t)((bits >= t1) & (bits < t3));
  }
}

}  // namespace

extern "C" {

const char* channel_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

// keys: (n_tiles, 2) uint32 on the device; err_x, err_z: (n_tiles * tile, n)
// uint8 on the device, row-major; per_tile = tile * n. Launches on `stream`
// and returns cudaGetLastError() after the launch.
int channel_depolarizing(const void* keys, unsigned n_tiles, unsigned per_tile,
                         unsigned t1, unsigned t2, unsigned t3, void* err_x,
                         void* err_z, void* stream) {
  const uint64_t total = (uint64_t)n_tiles * per_tile;
  if (total == 0) return 0;
  const int threads = 256;
  uint64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond that
  depolarizing_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)keys, per_tile, total, t1, t2, t3, (uint8_t*)err_x,
      (uint8_t*)err_z);
  return (int)cudaGetLastError();
}

}  // extern "C"
