// Kernel K15: the float32 convolution of an NHWC (channels_last) input
// with packed weights, as one implicit GEMM on the CUDA cores, written
// NHWC. Stride 1 or 2, kernel 1x1 or 3x3 (any kh, kw the wrapper passes),
// padding given, groups 1, dilation 1.
//
// Replaces no TPU kernel: on the TPU, XLA ran these convolutions. In the
// port they were F.conv2d, which cuDNN ran in float32 (TF32 off, the
// configurations' precision) with kernels that compute in NCHW: it
// transposed the NHWC input in and the output back around most calls, and
// took an FFT route for some 3x3 layers.
//
// Bound on an H100: operations. 2 * M * N * K floating-point operations
// (M = batch * Ho * Wo output pixels, N = Cout, K = kh * kw * Cin) at the
// 67 TFLOP/s float32 FFMA peak; the bytes (input read once, weights read
// once, output written once) are below that for every layer of
// Darknet-53 and CSPDarknet53 but the widest 1x1 convolutions with few
// channels, where the two are within a factor of two.
//
// Arithmetic: exact float32. Each output is float32 FFMAs (no tensor
// cores, no TF32) summed over K in (r, s, c) order, in two halves from K
// = 256 on (each half one accumulator, the second added to the first:
// the error of a sequential float32 sum grows with its length, and at K
// = 576 a single one was twice cuDNN's FFT route's), and under split-K S
// such sums over consecutive K ranges, written to a workspace and added
// by a second kernel in split order 0, 1, ..., S - 1: no atomics, so two
// runs give the same bits.
//
// Design. The GEMM is A [M, K] x B [K, N]: row m of A is output pixel m's
// receptive field in (r, s, c) order, read straight from the NHWC input
// (implicit im2col), so a group of four consecutive k is one 16-byte load
// along the contiguous channels when Cin % 4 == 0; B is the weights
// repacked once by the wrapper to [kh, kw, Cin, Cout padded to 4]. A
// thread block of four warps computes a 128 x 64 output tile (two warps
// and 128 x 32 where Cout <= 32); a warp 64 x 32; a thread 8 rows x 8
// channels, 64 accumulators, fed at each k by two 16-byte reads of A's
// buffer (four rows each: the buffer is k-major) and two of B's, the
// next k's read while this k's 64 FMAs run. Tiles of BK = 16 k (8 in the
// 32-channel tile) alternate between two buffers: tile t + 1's A comes
// from global memory into registers and its B by cp.async while tile t
// is computed, then A is stored k-major (transposed) into the free
// buffer; one barrier a tile.
// Out-of-range pixels (the padding), rows past M and k past K read as
// zeros. A's k-rows are padded by 4 floats.
//
// What bounds the design (measured on an H100 SXM, 700 W, at the layers
// of both networks): the main loop takes ~167 registers, so three blocks
// (12 warps) share an SM; at 4 blocks (128 registers) it spills and ran
// 7-15% slower. The k-major A buffer with register staging ran at 51-62%
// of the FFMA peak on the 3x3 layers with M >= 21,632, where a row-major
// A ring filled by cp.async (8 four-k reads of A a thread per four k)
// ran at 45-56%, tiles of 128 x 128 with 256 threads at 23-60%, and 8 x
// 16 outputs a thread (255 registers) at 19-52%.
//
// Parameters from the shapes alone (millieye_conv2d_plan): the tile, and
// a split of K where the tiles would leave SMs idle (the 13 to 26 px
// layers: M = 1352 to 5408 against K up to 4608), picked by a cost model
// of rounds of resident blocks plus the split's extra bytes. A small-K
// route (Cin % 4 != 0 and K <= 32: the first 3-channel convolution, K =
// 27) takes the whole of K in one tile of BK = 32, filled element by
// element by cp.async: for each output pixel and each kernel row r, kw *
// Cin consecutive floats of one input row. Cout % 4 != 0 (the 255-channel
// heads) reads B's zero padding and stores through each warp's region of
// shared memory, a row of 32 channels an instruction.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

struct Params {
  const float* x;       // [batch, H, W, C]
  const float* w;       // [kh, kw, C, cout], rows of ldw floats
  float* y;             // [batch, Ho, Wo, cout], or the split-K workspace
  int batch, h, w_in, c, cout, ldw, kh, kw, stride, pad, ho, wo;
  int m, k;             // GEMM sizes: m = batch * ho * wo, k = kh * kw * c
  int k_tiles;          // ceil(k / BK)
  int splits;
  int halves;           // 1: each split's K range summed in two halves
  long long split_stride;   // elements between the workspace's slices
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy, zero-filled where !valid (src must still be mapped)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The tile shape: a BM x BN output tile, warps of 64 x 32 (WARPS_M x
// WARPS_N of them), BK k a step. A warp's lanes are 8 (rows) x 4
// (channels); lane (tm, tn) holds rows tm * 4 + i and 32 + tm * 4 + i
// (i < 4) of the warp's 64, channels tn * 4 + j and 16 + tn * 4 + j (j <
// 4) of its 32. A buffer: [BK][BM + 4] (k-major, so a thread's four rows
// at one k are one 16-byte read); B buffer: [BK][BN]; two of each.
template <int BM_, int BN_, int BK_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WARPS_M = BM / 64, WARPS_N = BN / 32;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int AP = BM + 4;             // an A row, padded
  static constexpr int QUADS = BK / 4;          // four-wide groups a row
  static constexpr int A_STEP = THREADS / QUADS, A_ROWS = BM / A_STEP;
  static constexpr int B_GROUPS = BN / 4, B_STEP = THREADS / B_GROUPS;
  static constexpr int B_ROWS = BK / B_STEP;
  static constexpr int A_FLOATS = BK * AP, B_FLOATS = BK * BN;
  static constexpr int SMEM = 2 * (A_FLOATS + B_FLOATS) * 4;
  // with the ragged-channel store, a 64 x 33 region a warp after them
  static constexpr int STAGE_FLOATS = WARPS_M * WARPS_N * 64 * 33;
  static_assert(BM % 64 == 0 && BN % 32 == 0 && BK % 4 == 0, "tile");
  static_assert(BM % A_STEP == 0 && BK % B_STEP == 0, "loaders");
};

// The A loader: group q (four k) of rows row0 + j * A_STEP (j < A_ROWS)
// of each k tile, read from global memory into registers (the next
// tile's, while this one is computed), then stored k-major into the A
// buffer. Each row's output pixel is decoded once.
template <class T>
struct ALoader {
  int row0, q;
  int base[T::A_ROWS];     // offset of (n, hi0, wi0, 0) in x, may be < 0
  int hi0[T::A_ROWS], wi0[T::A_ROWS];
  float4 v[T::A_ROWS];

  __device__ __forceinline__ void init(const Params& p, int m0) {
    row0 = threadIdx.x / T::QUADS;
    q = threadIdx.x % T::QUADS;
    const int hw = p.ho * p.wo;
#pragma unroll
    for (int j = 0; j < T::A_ROWS; ++j) {
      const int m = m0 + row0 + j * T::A_STEP;
      if (m < p.m) {
        const int n = m / hw, rem = m - n * hw;
        const int oh = rem / p.wo, ow = rem - oh * p.wo;
        hi0[j] = oh * p.stride - p.pad;
        wi0[j] = ow * p.stride - p.pad;
        base[j] = ((n * p.h + hi0[j]) * p.w_in + wi0[j]) * p.c;
      } else {
        hi0[j] = -(1 << 20);       // never in range
        wi0[j] = 0;
        base[j] = 0;
      }
    }
  }

  __device__ __forceinline__ void load(const Params& p, int kt) {
    const int k = kt * T::BK + q * 4;
    int r = 0, s = 0, off = 0;
    const bool kin = k < p.k;
    if (kin) {
      const int rs = k / p.c, c = k - rs * p.c;
      r = rs / p.kw;
      s = rs - r * p.kw;
      off = (r * p.w_in + s) * p.c + c;
    }
#pragma unroll
    for (int j = 0; j < T::A_ROWS; ++j) {
      const int ih = hi0[j] + r, iw = wi0[j] + s;
      const bool valid = kin && static_cast<unsigned>(ih) <
                                    static_cast<unsigned>(p.h) &&
                         static_cast<unsigned>(iw) <
                             static_cast<unsigned>(p.w_in);
      v[j] = valid ? __ldg(reinterpret_cast<const float4*>(
                         p.x + (base[j] + off)))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  __device__ __forceinline__ void store(float* a) const {
#pragma unroll
    for (int j = 0; j < T::A_ROWS; ++j) {
      float* col = a + q * 4 * T::AP + row0 + j * T::A_STEP;
      col[0] = v[j].x;
      col[T::AP] = v[j].y;
      col[2 * T::AP] = v[j].z;
      col[3 * T::AP] = v[j].w;
    }
  }
};

// The small-K route's A tile: the whole of K (<= BK) in one tile, one
// element at a time by cp.async (committed with the B tile), k-major; k
// past K is zero.
template <class T>
__device__ __forceinline__ void load_a_small(const Params& p, float* a,
                                             int m0) {
  const int hw = p.ho * p.wo, run = p.kw * p.c;
  for (int t = threadIdx.x; t < T::BM * p.kh; t += T::THREADS) {
    const int row = t / p.kh, r = t - row * p.kh;
    const int m = m0 + row;
    int ih = -1, wi = 0, base = 0;
    if (m < p.m) {
      const int n = m / hw, rem = m - n * hw;
      const int oh = rem / p.wo, ow = rem - oh * p.wo;
      ih = oh * p.stride - p.pad + r;
      wi = ow * p.stride - p.pad;
      base = ((n * p.h + ih) * p.w_in + wi) * p.c;
    }
    const bool row_in = static_cast<unsigned>(ih) <
                        static_cast<unsigned>(p.h);
    int k = r * run;
    for (int s = 0; s < p.kw; ++s) {
      const bool valid = row_in && static_cast<unsigned>(wi + s) <
                                       static_cast<unsigned>(p.w_in);
      for (int c = 0; c < p.c; ++c, ++k)
        cp_async4(a + k * T::AP + row,
                  valid ? p.x + (base + s * p.c + c) : p.x, valid);
    }
  }
  for (int t = threadIdx.x; t < T::BM * (T::BK - p.k); t += T::THREADS) {
    const int row = t % T::BM, k = p.k + t / T::BM;
    a[k * T::AP + row] = 0.0f;
  }
}

// B tile: rows kt * BK .. + BK of the [K, ldw] weights, channels n0 ..
// n0 + BN, four at a time (ldw % 4 == 0; a group that starts below cout
// may read the zero padding past it)
template <class T>
__device__ __forceinline__ void load_b(const Params& p, float* b, int kt,
                                       int n0) {
#pragma unroll
  for (int j = 0; j < T::B_ROWS; ++j) {
    const int kr = threadIdx.x / T::B_GROUPS + j * T::B_STEP;
    const int g = threadIdx.x % T::B_GROUPS;
    const int k = kt * T::BK + kr, n = n0 + g * 4;
    const bool valid = k < p.k && n < p.cout;
    const float* src =
        valid ? p.w + (static_cast<long long>(k) * p.ldw + n) : p.w;
    cp_async16(b + kr * T::BN + g * 4, src, valid);
  }
  cp_async_commit();
}

// a row of a warp's staging region for ragged-channel stores (33: the
// lanes' column writes fall in distinct banks)
constexpr int kStageLd = 33;

// the four-wide fragments of A (rows) and B (channels) at one k
struct Frag {
  float4 a0, a1, b0, b1;
};

template <class T>
__device__ __forceinline__ Frag frag(const float* a, const float* b, int k,
                                     int arow, int bcol) {
  Frag f;
  f.a0 = *reinterpret_cast<const float4*>(a + k * T::AP + arow);
  f.a1 = *reinterpret_cast<const float4*>(a + k * T::AP + arow + 32);
  f.b0 = *reinterpret_cast<const float4*>(b + k * T::BN + bcol);
  f.b1 = *reinterpret_cast<const float4*>(b + k * T::BN + bcol + 16);
  return f;
}

// BK k of one tile: acc[i][j] += A[row i][k] * B[k][channel j], the next
// k's fragments read while this k's products run
template <class T>
__device__ __forceinline__ void mma_tile(const float* a, const float* b,
                                         int arow, int bcol,
                                         float (&acc)[8][8]) {
  Frag f[2];
  f[0] = frag<T>(a, b, 0, arow, bcol);
#pragma unroll
  for (int k = 0; k < T::BK; ++k) {
    if (k + 1 < T::BK) f[(k + 1) & 1] = frag<T>(a, b, k + 1, arow, bcol);
    const Frag& c = f[k & 1];
    const float av[8] = {c.a0.x, c.a0.y, c.a0.z, c.a0.w,
                         c.a1.x, c.a1.y, c.a1.z, c.a1.w};
    const float bv[8] = {c.b0.x, c.b0.y, c.b0.z, c.b0.w,
                         c.b1.x, c.b1.y, c.b1.z, c.b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// A thread's outputs: rows row + i (+ 28 from i = 4 on) of the [m, cout]
// result (NHWC), or of split `split`'s slice of the workspace, channels
// col + j (+ 12 from j = 4 on), four at a time (cout % 4 == 0); with
// `add`, what the slice holds there is added first (the first half's
// sum, stored by the same thread)
template <class T>
__device__ __forceinline__ void store_tile(const Params& p, int split,
                                           int row, int col,
                                           const float (&acc)[8][8],
                                           bool add) {
  float* out = p.y + split * p.split_stride;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = row + i + (i >= 4 ? 28 : 0);
    if (m >= p.m) continue;
    float* dst = out + static_cast<long long>(m) * p.cout;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int n = col + 16 * f;
      if (n < p.cout) {
        float4 v = make_float4(acc[i][4 * f], acc[i][4 * f + 1],
                               acc[i][4 * f + 2], acc[i][4 * f + 3]);
        if (add) {
          const float4 h = *reinterpret_cast<const float4*>(dst + n);
          v.x = h.x + v.x;
          v.y = h.y + v.y;
          v.z = h.z + v.z;
          v.w = h.w + v.w;
        }
        *reinterpret_cast<float4*>(dst + n) = v;
      }
    }
  }
}

// The ragged-channel store (cout % 4 != 0, rows not 16-byte aligned): a
// warp writes its 64 x 32 outputs into its own region of shared memory
// (rows of 33 floats), then stores them a row at a time, lane l at
// channel l: each instruction one contiguous run of 32 floats. With
// `add`, as store_tile.
template <class T>
__device__ __forceinline__ void store_tile_ragged(const Params& p, int split,
                                                  int row0, int col0,
                                                  const float (&acc)[8][8],
                                                  bool add, float* region) {
  const int lane = threadIdx.x % 32;
  const int lr = (lane / 4) * 4, lc = (lane % 4) * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      region[(lr + i + (i >= 4 ? 28 : 0)) * kStageLd + lc + j
             + (j >= 4 ? 12 : 0)] = acc[i][j];
  __syncwarp();
  float* out = p.y + split * p.split_stride;
  const int n = col0 + lane;
  for (int r = 0; r < 64; ++r) {
    const int m = row0 + r;
    if (m < p.m && n < p.cout) {
      float* dst = out + static_cast<long long>(m) * p.cout + n;
      const float v = region[r * kStageLd + lane];
      *dst = add ? *dst + v : v;
    }
  }
  __syncwarp();
}

// a thread's outputs by the store its channels allow
template <class T, bool VEC_OUT>
__device__ __forceinline__ void store(const Params& p, int split, int m0,
                                      int n0, int arow, int bcol,
                                      const float (&acc)[8][8], bool add,
                                      float* region) {
  if constexpr (VEC_OUT) {
    store_tile<T>(p, split, m0 + arow, n0 + bcol, acc, add);
  } else {
    const int warp = threadIdx.x / 32;
    store_tile_ragged<T>(p, split, m0 + (warp % T::WARPS_M) * 64,
                         n0 + (warp / T::WARPS_M) * 32, acc, add, region);
  }
}

template <class T, bool SMALL_K, bool VEC_OUT, int MIN_BLOCKS>
__global__ void __launch_bounds__(T::THREADS, MIN_BLOCKS)
conv_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                          // two A buffers
  float* bs = smem + 2 * T::A_FLOATS;        // two B buffers
  // this warp's staging region (ragged-channel stores only)
  float* region = bs + 2 * T::B_FLOATS + (threadIdx.x / 32) * 64 * kStageLd;

  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  // this block's k tiles: split blockIdx.z of p.splits, in even shares
  const int split = blockIdx.z;
  const int kt_begin = static_cast<int>(
      static_cast<long long>(p.k_tiles) * split / p.splits);
  const int kt_end = static_cast<int>(
      static_cast<long long>(p.k_tiles) * (split + 1) / p.splits);
  const int tiles = kt_end - kt_begin;
  // with p.halves, tiles [0, mid) are summed and stored, and the sum of
  // [mid, tiles) is added to them at the end
  const int mid = p.halves && tiles > 1 ? tiles / 2 : tiles;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % T::WARPS_M, wn = warp / T::WARPS_M;
  const int arow = wm * 64 + (lane / 4) * 4;
  const int bcol = wn * 32 + (lane % 4) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  if constexpr (SMALL_K) {
    load_a_small<T>(p, as, m0);
    load_b<T>(p, bs, 0, n0);
    cp_async_wait_all();
    __syncthreads();
    mma_tile<T>(as, bs, arow, bcol, acc);
  } else {
    // two buffers: tile t + 1's A in registers and its B in flight
    // (cp.async) while tile t is computed; one barrier a tile
    ALoader<T> al;
    al.init(p, m0);
    al.load(p, kt_begin);
    load_b<T>(p, bs, kt_begin, n0);
    al.store(as);
    cp_async_wait_all();
    __syncthreads();
    for (int t = 0; t < tiles; ++t) {
      const int buf = t & 1;
      const bool more = t + 1 < tiles;
      if (more) {
        al.load(p, kt_begin + t + 1);
        load_b<T>(p, bs + (buf ^ 1) * T::B_FLOATS, kt_begin + t + 1, n0);
      }
      mma_tile<T>(as + buf * T::A_FLOATS, bs + buf * T::B_FLOATS, arow,
                  bcol, acc);
      if (t + 1 == mid && mid < tiles) {
        store<T, VEC_OUT>(p, split, m0, n0, arow, bcol, acc, false, region);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      }
      if (more) {
        al.store(as + (buf ^ 1) * T::A_FLOATS);
        cp_async_wait_all();
      }
      __syncthreads();
    }
  }
  store<T, VEC_OUT>(p, split, m0, n0, arow, bcol, acc, mid < tiles, region);
}

// y[i] = ws[0][i] + ws[1][i] + ... + ws[splits - 1][i], in that order
__global__ void __launch_bounds__(256)
split_sum_kernel(const float* __restrict__ ws, float* __restrict__ y,
                 long long n, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * 256;
  long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (n % 4 == 0) {
    const float4* w4 = reinterpret_cast<const float4*>(ws);
    float4* y4 = reinterpret_cast<float4*>(y);
    for (; i < n / 4; i += stride) {
      float4 s = w4[i];
      for (int k = 1; k < splits; ++k) {
        const float4 v = w4[i + k * (n / 4)];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      y4[i] = s;
    }
  } else {
    for (; i < n; i += stride) {
      float s = ws[i];
      for (int k = 1; k < splits; ++k) s += ws[i + k * n];
      y[i] = s;
    }
  }
}

// the tiles; MIN_BLOCKS (launch bounds) = blocks_per_sm below caps the
// registers a thread at 65,536 / (threads * MIN_BLOCKS): 170 at 3 blocks
// of 128 threads, which the main loop uses (at 128 it spills), and at 6
// of 64
using Main = Tile<128, 64, 16>;          // 128 threads
using Narrow = Tile<128, 32, 8>;         // 64 threads
using Small = Tile<128, 32, 32>;         // 64 threads, K <= 32 in one tile

enum Cfg { kMain = 0, kNarrow = 1, kSmall = 2, kCfgs = 3 };
constexpr int kMaxDevices = 64;
// K from which each split's range is summed in two halves (the error of a
// sequential float32 sum grows with its length; halving it costs a
// store and a load of the output tile, L2-resident, against 2K FMAs an
// output)
constexpr int kHalvesK = 256;

struct CfgInfo {
  int bm, bn, bk, threads, blocks_per_sm;
  double speed;         // relative rate of a full SM (measured at the
                        // layers of Darknet-53 and CSPDarknet53)
};

constexpr CfgInfo kInfo[kCfgs] = {
    {Main::BM, Main::BN, Main::BK, Main::THREADS, 3, 1.0},
    {Narrow::BM, Narrow::BN, Narrow::BK, Narrow::THREADS, 6, 0.9},
    {Small::BM, Small::BN, Small::BK, Small::THREADS, 6, 0.5},
};

template <class T, bool SMALL_K, bool VEC_OUT, int MIN_BLOCKS>
int launch_tile(const Params& p, cudaStream_t st) {
  auto kern = conv_kernel<T, SMALL_K, VEC_OUT, MIN_BLOCKS>;
  const int smem = T::SMEM + (VEC_OUT ? 0 : T::STAGE_FLOATS * 4);
  // the shared-memory opt-in, once a device
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices || !ready[dev]) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) ready[dev] = true;
  }
  const dim3 grid((p.m + T::BM - 1) / T::BM, (p.cout + T::BN - 1) / T::BN,
                  p.splits);
  kern<<<grid, T::THREADS, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class T, bool SMALL_K, int MIN_BLOCKS>
int launch_b(const Params& p, cudaStream_t st) {
  return p.cout % 4 == 0
             ? launch_tile<T, SMALL_K, true, MIN_BLOCKS>(p, st)
             : launch_tile<T, SMALL_K, false, MIN_BLOCKS>(p, st);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
      sms = 132;
  }
  return sms;
}

bool small_k(int c, int k) { return c % 4 != 0 && k <= Small::BK; }

// the modelled time of (cfg, splits) in microseconds: the blocks run in
// rounds of up to blocks_per_sm a SM; a round of b blocks a SM takes b
// blocks' work at the SM's rate with b blocks' warps resident (0.45 of
// full with a warp a scheduler, full from 3); a 128 x 128 x 16
// tile's 262,144 FMAs take ~1.0 us of a whole SM. A split adds its
// workspace, written and read once more (8 bytes an element a split), and
// the summing launch.
double cost(int cfg, int splits, long long m, int n, int k) {
  const CfgInfo& f = kInfo[cfg];
  const long long sms = sm_count();
  long long left = ((m + f.bm - 1) / f.bm) * ((n + f.bn - 1) / f.bn)
                   * splits;
  const long long k_tiles = (k + f.bk - 1) / f.bk;
  const double block_us = static_cast<double>(f.bm) * f.bn * f.bk
                          * ((k_tiles + splits - 1) / splits)
                          / (128.0 * 128 * 16) / f.speed;
  const int warps = f.threads / 32;
  double t = 0.0;
  while (left > 0) {
    const long long b = std::min<long long>(f.blocks_per_sm,
                                            (left + sms - 1) / sms);
    const double rate = std::min(1.0, 0.45 * b * warps / 4);
    t += b * block_us / rate;
    left -= b * sms;
  }
  if (splits > 1) t += 8.0 * splits * m * n / 3.0e12 * 1e6 + 3.0;
  return t;
}

}  // namespace

extern "C" {

const char* millieye_cuda_error_name(int code) {
  return cudaGetErrorName(static_cast<cudaError_t>(code));
}

// The tile and split of K the launch below takes for a convolution of
// these sizes (out: *cfg, *splits): the cheapest by `cost`, unless
// force_cfg >= 0 (and force_splits >= 1) names one. Returns 0, or
// cudaErrorInvalidValue for sizes the kernel does not take.
int millieye_conv2d_plan(int batch, int h, int w, int c, int cout, int kh,
                         int kw, int stride, int pad, int force_cfg,
                         int force_splits, int* cfg, int* splits) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || cout <= 0 || kh <= 0
      || kw <= 0 || stride <= 0 || pad < 0)
    return cudaErrorInvalidValue;
  const long long ho = (h + 2LL * pad - kh) / stride + 1;
  const long long wo = (w + 2LL * pad - kw) / stride + 1;
  const long long m = batch * ho * wo;
  const long long k = static_cast<long long>(kh) * kw * c;
  // 32-bit offsets into x, y and w
  if (ho <= 0 || wo <= 0 || static_cast<long long>(batch) * h * w * c
      >= (1LL << 31) || m * cout >= (1LL << 31) || k * cout >= (1LL << 31))
    return cudaErrorInvalidValue;
  const bool small = small_k(c, static_cast<int>(k));
  if (c % 4 != 0 && !small) return cudaErrorInvalidValue;
  if (force_cfg >= 0) {
    if (force_cfg >= kCfgs || (force_cfg == kSmall) != small)
      return cudaErrorInvalidValue;
    const long long kt = (k + kInfo[force_cfg].bk - 1) / kInfo[force_cfg].bk;
    *cfg = force_cfg;
    *splits = static_cast<int>(std::max(1LL, std::min<long long>(
        force_splits, kt)));
    return 0;
  }
  if (small) {
    *cfg = kSmall;
    *splits = 1;
    return 0;
  }
  int best_cfg = kMain, best_splits = 1;
  double best = 1e300;
  for (int f = kMain; f <= kNarrow; ++f) {
    const long long kt = (k + kInfo[f].bk - 1) / kInfo[f].bk;
    for (int s = 1; s <= 8 && s <= kt; ++s) {
      const double t = cost(f, s, m, cout, static_cast<int>(k));
      if (t < best * 0.999) {
        best = t;
        best_cfg = f;
        best_splits = s;
      }
    }
  }
  *cfg = best_cfg;
  *splits = best_splits;
  return 0;
}

// y [batch, Ho, Wo, cout] = the convolution of x [batch, h, w, c] (NHWC,
// dense) with w [kh, kw, c, cout] (rows of ldw floats, ldw a multiple of
// 4 and >= cout, zero past cout), stride and zero padding `pad` on every
// side, as planned: cfg and splits from millieye_conv2d_plan; with splits
// > 1, ws holds splits * batch * Ho * Wo * cout floats. The ints come as
// one array, a = {batch, h, w, c, cout, ldw, kh, kw, stride, pad, cfg,
// splits}: the caller keeps it for the shape, and a call passes six
// arguments.
int millieye_conv2d_nhwc(const float* x, const float* w, float* y, float* ws,
                         const int* a, void* stream) {
  const int batch = a[0], h = a[1], wd = a[2], c = a[3], cout = a[4];
  const int ldw = a[5], kh = a[6], kw = a[7], stride = a[8], pad = a[9];
  const int cfg = a[10], splits = a[11];
  int check_cfg = 0, check_splits = 0;
  int rc = millieye_conv2d_plan(batch, h, wd, c, cout, kh, kw, stride, pad,
                                cfg, splits, &check_cfg, &check_splits);
  if (rc != 0) return rc;
  if (check_splits != splits || (splits > 1 && !ws) || ldw % 4 != 0
      || ldw < cout
      || static_cast<long long>(kh) * kw * c * ldw >= (1LL << 31))
    return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.w = w;
  p.batch = batch;
  p.h = h;
  p.w_in = wd;
  p.c = c;
  p.cout = cout;
  p.ldw = ldw;
  p.kh = kh;
  p.kw = kw;
  p.stride = stride;
  p.pad = pad;
  p.ho = (h + 2 * pad - kh) / stride + 1;
  p.wo = (wd + 2 * pad - kw) / stride + 1;
  p.m = batch * p.ho * p.wo;
  p.k = kh * kw * c;
  p.k_tiles = (p.k + kInfo[cfg].bk - 1) / kInfo[cfg].bk;
  p.splits = splits;
  p.halves = p.k >= kHalvesK;
  p.y = splits > 1 ? ws : y;
  p.split_stride = static_cast<long long>(p.m) * cout;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cfg) {
    case kMain: rc = launch_b<Main, false, 3>(p, st); break;
    case kNarrow: rc = launch_b<Narrow, false, 6>(p, st); break;
    case kSmall: rc = launch_b<Small, true, 6>(p, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (rc != 0 || splits == 1) return rc;
  const long long n = p.split_stride;
  const long long work = n % 4 == 0 ? n / 4 : n;
  const int blocks = static_cast<int>(std::max<long long>(1, std::min<
      long long>((work + 255) / 256, static_cast<long long>(sm_count()) * 8)));
  split_sum_kernel<<<blocks, 256, 0, st>>>(ws, y, n, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
