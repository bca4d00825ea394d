// Kernel K13: int8 quantization with unbiased stochastic rounding,
//   scale = max(absmax(w), 1e-8) * (1 / 127),
//   q = clip(floor(w / scale + u), -127, 127) -> int8,
//   u = (bits >> 8) * 2^-24 uniform in [0, 1),
// for a float32 matrix w [M, N] with one scale for the whole tensor.
//
// Replaces: millieye_tpu/ops/quantize.py:quantize_int8_stochastic, a
// Pallas kernel gridded over row tiles of row_tile rows whose random bits
// came from the TPU's on-chip PRNG seeded seed + tile. Those bits cannot
// be had here, so the bits are Philox4x32-10 (the Random123 constants)
// keyed by (seed + tile, 0): element j of a tile (row-major index within
// the tile) takes word j % 4 of the block at counter (j / 4, 0, 0, 0).
// The plain version (ops/quantize.py:quantize_int8_stochastic_plain)
// computes the same words in int64 PyTorch, so kernel and plain version
// are bit-equal. The JAX wrapper's scale, `max(absmax, 1e-8) / 127.0`,
// is compiled by XLA into a product with the float32 reciprocal of 127,
// and so is computed here; w / scale is an IEEE division (__fdiv_rn; the
// library is built without fast math), the add of u is __fadd_rn, and u
// is exact in float32. A NaN anywhere in w makes the scale NaN, and a
// NaN reaches the int8 cast as it does in the plain version's clamp.
//
// Bound on an H100: bytes. The absmax pass reads 4 bytes an element and
// the rounding pass reads 4 and writes 1 (9 bytes an element: 42.5 MB,
// 12.7 us at 3.35 TB/s for the 4608 x 1024 weight of block 12, though
// the second read may come from the 50 MB L2); the Philox rounds are ~25
// integer operations per element.
//
// Design: the wrapper's whole function in two launches and no PyTorch
// operation but the outputs' allocation.
//  1. absmax_kernel: at most kParts blocks stride over the matrix with
//     16-byte loads (4-byte loads where the pointer is not 16-byte
//     aligned). A value's |w| is compared as the bits of fabsf(w), an
//     unsigned integer: for non-negative floats integer order is float
//     order, and a NaN's bits exceed inf's, so a NaN wins the max as
//     torch.amax and jnp.max propagate it. Each block writes its max to
//     parts[block]; no memory needs to be zero first.
//  2. round_kernel: a grid-stride loop over the groups of four
//     consecutive elements of each tile (one Philox call a group), the
//     tiles laid end to end on a 1-D grid, so any number of tiles goes
//     (no grid dimension holds the tiles). Each block
//     first reduces the partial maxima (a few KB, from L2) to the scale;
//     block 0 writes it out. A group whose first element is 16-byte
//     aligned (tile * row_tile * N % 4 == 0 for its tile, and an aligned
//     pointer) reads a float4 and writes its four int8 values as one
//     32-bit store; a group past the end of a ragged tile is masked.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kParts = 512;        // absmax blocks, at most
constexpr int kRoundBlocks = 2048; // rounding blocks, at most

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

__device__ __forceinline__ uint32_t abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

// the largest of one value a thread over the block, in every thread
__device__ __forceinline__ uint32_t block_max(uint32_t m) {
  __shared__ uint32_t s_max[kThreads / 32];
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = s_max[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) m = max(m, s_max[i]);
  return m;
}

__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ w, long long elems, bool vec,
              uint32_t* __restrict__ parts) {
  uint32_t m = 0;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (vec) {
    const float4* w4 = reinterpret_cast<const float4*>(w);
    for (; i < elems / 4; i += stride) {
      const float4 v = __ldg(w4 + i);
      m = max(max(m, abs_bits(v.x)), abs_bits(v.y));
      m = max(max(m, abs_bits(v.z)), abs_bits(v.w));
    }
    // the last elems % 4 values
    i = 4 * (elems / 4) + static_cast<long long>(blockIdx.x) * kThreads
        + threadIdx.x;
  }
  for (; i < elems; i += stride) m = max(m, abs_bits(__ldg(w + i)));
  m = block_max(m);
  if (threadIdx.x == 0) parts[blockIdx.x] = m;
}

__device__ __forceinline__ int8_t round_one(float w, float s, uint32_t bits) {
  const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
  const float v = floorf(__fadd_rn(__fdiv_rn(w, s), u));
  // PyTorch's clamp keeps a NaN, and its cast to int8 is this one
  return static_cast<int8_t>(v != v ? v : fminf(fmaxf(v, -127.0f), 127.0f));
}

__global__ void __launch_bounds__(kThreads)
round_kernel(const float* __restrict__ w, const uint32_t* __restrict__ parts,
             int n_parts, float* __restrict__ scale_out,
             int8_t* __restrict__ out, int m, int n, int tile, int seed,
             bool aligned) {
  // the scale: max(absmax, 1e-8) as bits (a NaN stays NaN), then times
  // the float32 reciprocal of 127
  uint32_t mb = 0;
  for (int i = threadIdx.x; i < n_parts; i += kThreads)
    mb = max(mb, parts[i]);
  mb = max(block_max(mb), __float_as_uint(1e-8f));
  const float s = __fmul_rn(__uint_as_float(mb), 1.0f / 127.0f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = s;

  const long long tile_elems = static_cast<long long>(tile) * n;
  const long long per_tile = (tile_elems + 3) / 4;     // groups a tile
  const int tiles = (m + tile - 1) / tile;
  const long long groups = per_tile * tiles;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long gi = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
       gi < groups; gi += stride) {
    const int t = static_cast<int>(gi / per_tile);
    const long long g = gi - t * per_tile;
    const long long elems =
        static_cast<long long>(min(tile, m - t * tile)) * n;
    const long long j0 = 4 * g;
    if (j0 >= elems) continue;                 // past a ragged last tile
    const Words r = philox4x32_10(static_cast<uint32_t>(g),
                                  static_cast<uint32_t>(seed)
                                      + static_cast<uint32_t>(t));
    const long long at = t * tile_elems + j0;
    if (aligned && (at & 3) == 0 && j0 + 4 <= elems) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(w + at));
      const uint32_t q =
          static_cast<uint8_t>(round_one(v.x, s, r.x[0]))
          | static_cast<uint32_t>(static_cast<uint8_t>(
                round_one(v.y, s, r.x[1]))) << 8
          | static_cast<uint32_t>(static_cast<uint8_t>(
                round_one(v.z, s, r.x[2]))) << 16
          | static_cast<uint32_t>(static_cast<uint8_t>(
                round_one(v.w, s, r.x[3]))) << 24;
      *reinterpret_cast<uint32_t*>(out + at) = q;
      continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (j0 + i < elems)
        out[at + i] = round_one(__ldg(w + at + i), s, r.x[i]);
  }
}

long long cdivll(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

const char* millieye_cuda_error_name(int code) {
  return cudaGetErrorName(static_cast<cudaError_t>(code));
}

// the unsigned ints of partial maxima `parts` must hold
int millieye_quantize_parts() { return kParts; }

// w [m, n] f32 on the card -> out [m, n] int8 and scale [] f32; tile rows
// per PRNG stream (the last tile may be short), seed as the TPU wrapper's
// int32; parts: millieye_quantize_parts() unsigned ints of scratch.
int millieye_quantize_stochastic(const void* w, void* scale, void* out,
                                 void* parts, int m, int n, int tile,
                                 int seed, void* stream) {
  if (m <= 0 || n <= 0 || tile <= 0 || tile > m)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long elems = static_cast<long long>(m) * n;
  const float* wf = static_cast<const float*>(w);
  const bool aligned = reinterpret_cast<uintptr_t>(w) % 16 == 0
                       && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const int n_parts = static_cast<int>(
      std::min<long long>(kParts, cdivll(elems, 4LL * kThreads * 4)));
  absmax_kernel<<<n_parts, kThreads, 0, st>>>(
      wf, elems, reinterpret_cast<uintptr_t>(w) % 16 == 0,
      static_cast<uint32_t*>(parts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long groups = cdivll(static_cast<long long>(tile) * n, 4)
                           * cdivll(m, tile);
  const int blocks = static_cast<int>(
      std::min<long long>(kRoundBlocks, cdivll(groups, kThreads)));
  round_kernel<<<blocks, kThreads, 0, st>>>(
      wf, static_cast<const uint32_t*>(parts), n_parts,
      static_cast<float*>(scale), static_cast<int8_t*>(out), m, n, tile, seed,
      aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
