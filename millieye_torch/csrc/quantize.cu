// Kernel K13: int8 quantization with unbiased stochastic rounding,
//   q = clip(floor(w / scale + u), -127, 127) -> int8,
//   u = (bits >> 8) * 2^-24 uniform in [0, 1),
// for a float32 matrix w [M, N] with a per-tensor scale computed by the
// caller (max(absmax(w), 1e-8) / 127, a reduction outside the kernel).
//
// Replaces: millieye_tpu/ops/quantize.py:quantize_int8_stochastic, a
// Pallas kernel gridded over row tiles of row_tile rows whose random bits
// came from the TPU's on-chip PRNG seeded seed + tile. Those bits cannot
// be had here, so the bits are Philox4x32-10 (the Random123 constants)
// keyed by (seed + tile, 0): element j of a tile (row-major index within
// the tile) takes word j % 4 of the block at counter (j / 4, 0, 0, 0).
// The plain version (ops/quantize.py:quantize_int8_stochastic_plain)
// computes the same words in int64 PyTorch, so kernel and plain version
// are bit-equal. The division is IEEE (__fdiv_rn; the library is built
// without fast math) and the add of u is __fadd_rn; u is exact in float32.
//
// Bound on an H100: bytes. It must read 4 bytes and write 1 byte per
// element (23.6 MB, 7.0 us at 3.35 TB/s for the 4608 x 1024 weight of
// block 12); the Philox rounds are ~25 integer operations per element.
//
// Design: one thread per four consecutive elements of a tile, i.e. per
// Philox call; a 2-D grid of (groups of a tile, tiles). Tile-local
// indices are contiguous in memory (a tile is row_tile whole rows), so
// neighbouring threads read neighbouring 16-byte runs. A ragged last
// tile is masked; the padding rows the JAX wrapper adds are never read.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Words {
  uint32_t x[4];
};

__device__ __forceinline__ Words philox4x32_10(uint32_t c0, uint32_t k0) {
  uint32_t c1 = 0, c2 = 0, c3 = 0, k1 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return Words{{c0, c1, c2, c3}};
}

__global__ void __launch_bounds__(kThreads)
quantize_stochastic_kernel(const float* __restrict__ w,
                           const float* __restrict__ scale,
                           int8_t* __restrict__ out, int m, int n, int tile,
                           int seed) {
  const int t = blockIdx.y;
  const long long g = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const int rows = min(tile, m - t * tile);
  const long long elems = static_cast<long long>(rows) * n;
  const long long j0 = 4 * g;
  if (j0 >= elems) return;
  const float s = *scale;
  const Words r = philox4x32_10(static_cast<uint32_t>(g),
                                static_cast<uint32_t>(seed)
                                    + static_cast<uint32_t>(t));
  const long long base = static_cast<long long>(t) * tile * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (j0 + i >= elems) break;
    const float scaled = __fdiv_rn(w[base + j0 + i], s);
    const float u = static_cast<float>(r.x[i] >> 8) * (1.0f / 16777216.0f);
    const float v = fminf(fmaxf(floorf(__fadd_rn(scaled, u)), -127.0f),
                          127.0f);
    out[base + j0 + i] = static_cast<int8_t>(v);
  }
}

}  // namespace

extern "C" {

const char* millieye_cuda_error_name(int code) {
  return cudaGetErrorName(static_cast<cudaError_t>(code));
}

// w [m, n] f32, scale [] f32 on the card -> out [m, n] int8; tile rows per
// PRNG stream (the last tile may be short), seed as the TPU wrapper's int32.
int millieye_quantize_stochastic(const void* w, const void* scale, void* out,
                                 int m, int n, int tile, int seed,
                                 void* stream) {
  if (m <= 0 || n <= 0 || tile <= 0 || tile > m)
    return cudaErrorInvalidValue;
  const long long groups = (static_cast<long long>(tile) * n + 3) / 4;
  const long long blocks = (groups + kThreads - 1) / kThreads;
  const int tiles = (m + tile - 1) / tile;
  if (blocks > 0x7FFFFFFF || tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), tiles);
  quantize_stochastic_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(scale),
      static_cast<int8_t*>(out), m, n, tile, seed);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
