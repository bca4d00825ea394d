// Fused stem kernels: the two-stage pair (K4, and K8, K11 and K12 at the
// stem shape), the deep pair (K12 at stages 4+6), the single stage K9 and
// its NHWC spelling K10.
//
// The stem pair:
//   out = maxpool2(leaky(conv3x3(maxpool2(leaky(conv3x3(x, w0) + b0)), w1)
//                  + b1))
// for NHWC float32 x [N, H, W, Cin] -> NHWC [N, H/4, W/4, Cout] stored as
// float32, bf16 or float16; convolutions with zero padding 1, leaky slope
// 0.1, 2x2/2 max pools.
//
// Replaces four Pallas kernels that compute this one function on the TPU
// and differ there in how they tile the MXU and buffer VMEM:
// millieye_tpu/ops/stem_pallas.py:fused_stem2_phase (K4; its bf16_only,
// scratch_dtype and input_mode options are buffering),
// stem_pallas.py:fused_stem2_planar (K8), and
// stem_pallas_rejected.py:fused_stem2_packed (K11, stage 0 K-packed) and
// fused_stem2_s2d (K12, stage 1 as space-to-depth). The K-packing and the
// s2d regrouping are MXU layouts with no meaning on this card, so K11 and
// K12 launch the same kernel as K4. Numerics:
//   precision "default": the input and w0 are rounded to bf16, products
//     accumulate in float32, then +b0, leaky and the pool; the float32
//     intermediate is rounded to bf16 as stage 1's operand, with w1 in
//     bf16; one rounding to the store type at the end. The products run
//     on the tensor cores, which sum each k-group of 16 in an order and
//     with a rounding of their own (as the TPU's MXU does), so the
//     kernel is held to its plain version within 2^-6 of the largest
//     output, not bit for bit.
//   precision "highest": float32 throughout, each product rounded before
//     its add (__fmul_rn, __fadd_rn), so the plain version can repeat it
//     bit for bit.
//   K8 ("select" pool, "default" only): the TPU picks the pooled columns
//     with a one-hot matmul split into hi = bf16(v) and bf16(v - hi)
//     (stem_pallas.py:_pool_select_dot), so each pooled value becomes
//     hi + bf16(v - hi) at both stages before its use. At "highest" the
//     select is exact and K8 is K4's function.
//
// Bound on an H100 at 416 px: bytes. Per image it must read the 2.08 MB
// float32 input and write the 0.69 MB float16 output (0.83 us at
// 3.35 TB/s; 26.5 us at batch 32), against 0.55 GFLOP of products
// (0.56 us at the bf16 989 TFLOP/s; 8.2 us at "highest" on the
// 67 TFLOP/s float32 cores).
//
// Design at "default" (stem_pair_tc_kernel): a persistent grid, as many
// 256-thread blocks as fit on the card, each walking 8x8 tiles of output
// pixels (169 tiles at 416 px, batch 1) with a stride of the grid. A
// block rounds both weight sets to bf16 once, in mma fragment order, into
// shared memory. Each tile's 38x38xCin float32 input halo is copied with
// cp.async (zero fill outside the frame: the conv's padding) while the
// previous tile computes. Stage 0 is an implicit GEMM on
// mma.sync.m16n8k16 (bf16 in, float32 accumulators): M = the conv
// positions of the tile's 18x18 intermediate (one halo pixel each side),
// N = Cmid, K = the 27 taps (u, v, c) padded to 32, A gathered from the
// halo through a table of tap offsets. The M rows are ordered so that the
// four conv outputs of one pooled pixel land in one thread's
// accumulators (rows gid and gid + 8 of two m16 tiles), so +b0, leaky,
// the 2x2 max, K8's select and the bf16 rounding are a register
// epilogue; it writes the bf16 intermediate to shared memory (zero
// outside the H/2 x W/2 map, stage 1's padding), columns split by parity
// and 16-byte chunks swizzled so that ldmatrix reads it without bank
// conflicts. Stage 1: M = the tile's 16x16 conv positions, N = Cout,
// K = 9 taps x 16 channels, one k-step per tap, A straight from the
// intermediate by ldmatrix at the tap's offset (no im2col buffer). The
// same register pool, then each pixel's 8-channel groups go out as
// 16-byte stores. The 2x-down intermediate (1.4 MB float32 per 416 px
// image) never reaches device memory, which is what the Pallas kernels
// kept in VMEM. 64 KB of shared memory and at most 80 registers a thread
// at the stem widths, so three blocks share an SM.
//
// Design at "highest" (stem_pair_kernel): mul-then-add on the CUDA cores,
// two issue slots a product. At 416 px a tile's stage 0 covers its 18x18
// intermediate (one halo pixel each side), so an image takes 294 M
// products (199 M of them stage 1's), 588 M float32 instructions: at
// 132 SMs x 128 lanes x 1.755-1.98 GHz the ceiling is 17.6-19.9 us an
// image, 0.56-0.63 ms at batch 32, half the 67 TFLOP/s that FMAs would
// reach. The layout is built so that this ceiling, not shared memory,
// bounds it:
//  - a persistent grid of 256-thread blocks walks 8x8 output tiles with
//    a stride of the grid; both weight sets arrive once per block, in
//    the [ci, 3, 3, co] order the wrapper gives them, by 16-byte
//    cp.async;
//  - the 38x38xCin input halo lands planar ([c][row][col]) by 4-byte
//    cp.async (zero fill outside the frame), into a second buffer while
//    the previous tile computes where two fit shared memory (the stem
//    widths: 75,744 bytes, three blocks an SM), else into one;
//  - each thread owns 4 output channels of 2 horizontally adjacent
//    pixels at all four pool positions (32 sums); the lanes of a warp
//    run 4-channel groups fastest, so a weight load is one float4 that
//    neighbouring lanes read side by side, and the operands are the same
//    word for all lanes of a group (a broadcast) and, across the groups
//    of a warp, words of one row a stride of 4 apart (distinct banks at
//    the stem widths). Per (u, v, c) a thread loads 8 operands and one
//    float4 for 32 products;
//  - stage 0 writes the float32 intermediate planar into shared memory,
//    zero outside the H/2 x W/2 map (stage 1's padding); stage 1 reads it
//    the same way and stores each pixel's 4 channels as one 16- or 8-byte
//    store.
// Each sum runs over (u, v, c), c fastest, one __fmul_rn and one
// __fadd_rn a product, so the plain version repeats it bit for bit.
// Shapes whose weights and halo do not fit one buffer take the deep pair
// below (the wrappers' ops/stem.py:pair_route).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 8;               // output pixels per tile side
constexpr int kMid = 2 * kTile + 2;    // intermediate pixels, with halo
constexpr int kIn = 4 * kTile + 6;     // input pixels, with halo
constexpr int kThreads = 256;
constexpr int kGroup = 8;              // channels per thread
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;    // the per-block opt-in limit

enum StoreType { kStoreF32 = 0, kStoreBf16 = 1, kStoreF16 = 2 };

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float leaky(float v) {
  return v > 0.0f ? v : 0.1f * v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the TPU's one-hot column select as two bf16 passes: hi + bf16(v - hi)
// (both the difference and the sum are exact in float32)
__device__ __forceinline__ float pool_select(float v) {
  const float hi = bf16_round(v);
  return __fadd_rn(hi, bf16_round(__fsub_rn(v, hi)));
}

__device__ __forceinline__ void store_value(void* out, size_t i, float v,
                                            int store) {
  if (store == kStoreF32)
    static_cast<float*>(out)[i] = v;
  else if (store == kStoreBf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<__half*>(out)[i] = __float2half_rn(v);
}

// ---------------------------------------------------------------------
// The pair at precision "default" on the tensor cores (see the note at
// the top of the file). Stage 0 is an implicit GEMM with M = the tile's
// conv positions, N = cmid, K = the 9*cin taps (u, v, c) padded with
// zeros to a multiple of 16; stage 1 one with M = the tile's stage-1 conv
// positions, N = cout, K = 9 taps x cmid channels (padded to a multiple
// of 16: one k-step per tap and 16-channel slice). Products are
// mma.sync.m16n8k16 on bf16 operands with float32 accumulators.
constexpr int kWarps = kThreads / 32;
constexpr int kMidHalf = kMid / 2;     // intermediate columns per parity
constexpr int kOutPitch = 40;          // floats per pixel, store staging

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline size_t pair_tc_smem_bytes(int cin, int cmid,
                                                     int cout) {
  const int ks0 = cdiv(9 * cin, 16), cs = cdiv(cmid, 16);
  return 256 * static_cast<size_t>(ks0 * (cmid / 8) + 9 * cs * (cout / 8))
         + 4 * (align4(cmid) + align4(cout) + 16 * ks0
                + 2 * align4(kIn * kIn * cin))
         + 32 * cs * kMid * kMid + 4 * kWarps * 8 * kOutPitch;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4-byte asynchronous copy into shared memory; zero fill where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 16-byte asynchronous copy into shared memory
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// two floats rounded to bf16, lo in the low half (the fragments' order)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* a, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p))
      : "memory");
}

// Byte offset of 16-byte chunk `chunk` (8 channels) of intermediate pixel
// (row, col), `pitch` bytes a pixel. Columns are split by parity, so the
// stride-2 columns that one pool position reads lie side by side, and
// the chunk index is XORed with bit 2 of the column's place, so eight
// side-by-side columns fall on eight distinct bank groups: ldmatrix reads
// them without conflicts.
__device__ __forceinline__ int mid_offset(int row, int col, int chunk,
                                          int pitch) {
  const int idx = col >> 1;
  return ((row * 2 + (col & 1)) * kMidHalf + idx) * pitch
         + ((chunk ^ ((idx >> 2) & 1)) << 4);
}

// the four pool positions of one channel: +bias, leaky, 2x2 max (in the
// CUDA-core kernels' order), and K8's select
template <bool kSelect>
__device__ __forceinline__ float pool4(float a00, float a01, float a10,
                                       float a11, float bias) {
  float m = leaky(__fadd_rn(a00, bias));
  m = fmaxf(m, leaky(__fadd_rn(a01, bias)));
  m = fmaxf(m, leaky(__fadd_rn(a10, bias)));
  m = fmaxf(m, leaky(__fadd_rn(a11, bias)));
  return kSelect ? pool_select(m) : m;
}

// eight channels from shared memory to the output as 16-byte stores
__device__ __forceinline__ void store8(void* out, size_t o, const float* v,
                                       int store) {
  if (store == kStoreF32) {
    float4* d = reinterpret_cast<float4*>(static_cast<float*>(out) + o);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
  const bool bf = store == kStoreBf16;
  uint4 q;
  q.x = bf ? pack_bf16(v[0], v[1]) : pack_f16(v[0], v[1]);
  q.y = bf ? pack_bf16(v[2], v[3]) : pack_f16(v[2], v[3]);
  q.z = bf ? pack_bf16(v[4], v[5]) : pack_f16(v[4], v[5]);
  q.w = bf ? pack_bf16(v[6], v[7]) : pack_f16(v[6], v[7]);
  *reinterpret_cast<uint4*>(static_cast<__half*>(out) + o) = q;
}

// four channels to the output as one 16-byte (float32) or 8-byte store
__device__ __forceinline__ void store4(void* out, size_t o, const float* v,
                                       int store) {
  if (store == kStoreF32) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
        make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  const bool bf = store == kStoreBf16;
  *reinterpret_cast<uint2*>(static_cast<__half*>(out) + o) = make_uint2(
      bf ? pack_bf16(v[0], v[1]) : pack_f16(v[0], v[1]),
      bf ? pack_bf16(v[2], v[3]) : pack_f16(v[2], v[3]));
}

// ---------------------------------------------------------------------
// The pair at precision "highest" (see the note at the top of the file).

// The input halo of a tile, rows x cols pixels from frame pixel (iy0,
// ix0) of image img, planar [cin][rows][cols], zero outside the frame,
// by 4-byte cp.async (the caller commits and waits): a warp copies whole
// frame rows, a contiguous run of cols * cin floats, and tracks each
// float's (column, channel) by adding 32 / cin columns and 32 % cin
// channels a step.
__device__ __forceinline__ void load_halo_planar(float* dst,
                                                 const float* __restrict__ x,
                                                 int img, int h, int w,
                                                 int cin, int iy0, int ix0,
                                                 int rows, int cols,
                                                 int pitch = 0) {
  if (pitch == 0) pitch = cols;
  const int lane = threadIdx.x & 31;
  const int run = cols * cin, col_step = 32 / cin, c_step = 32 % cin;
  for (int row = threadIdx.x >> 5; row < rows; row += blockDim.x >> 5) {
    const int gy = iy0 + row;
    const float* src = x + (static_cast<ptrdiff_t>(img) * h + gy) * w * cin;
    int c = lane % cin, col = lane / cin;
    for (int k = lane; k < run; k += 32) {
      const int gk = ix0 * cin + k;   // float index within the frame row
      const bool ok = gy >= 0 && gy < h && gk >= 0 && gk < w * cin;
      cp_async4(dst + (c * rows + row) * pitch + col, ok ? src + gk : x, ok);
      c += c_step;
      col += col_step;
      if (c >= cin) {
        c -= cin;
        ++col;
      }
    }
  }
}


// bytes of shared memory: the biases, both weight sets, the intermediate
// and `bufs` input halos (ops/stem.py:_tile_fits mirrors it at bufs = 1)
__host__ __device__ inline size_t pair_smem_bytes(int cin, int cmid,
                                                  int cout, int bufs) {
  return sizeof(float) * (align4(cmid) + align4(cout) + 9 * cin * cmid
                          + 9 * cmid * cout + kMid * kMid * cmid
                          + bufs * align4(kIn * kIn * cin));
}

// The 2x2-pooled conv of two horizontally adjacent pooled pixels x 4
// channels, summed as the plain version sums: over (u, v, c), c fastest,
// each product rounded before its add. src: planar [nc][rows][pitch]
// (plane floats a channel), the pixels' conv windows starting at local
// row r0 and columns c0 and c0 + 2; sw: [nc][3][3][nco] with the 4
// channels at co. acc[q][d][k]: pixel q, pool position d = 2 dy + dx.
__device__ __forceinline__ void conv_pair_hi(float (&acc)[2][4][4],
                                             const float* src, int pitch,
                                             int plane, int nc,
                                             const float* sw, int nco, int co,
                                             int r0, int c0) {
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const float* p = src + (r0 + u) * pitch + c0 + v;
      const float* wr = sw + (u * 3 + v) * nco + co;
      for (int c = 0; c < nc; ++c, p += plane, wr += 9 * nco) {
        const float4 wv = *reinterpret_cast<const float4*>(wr);
        const float wk[4] = {wv.x, wv.y, wv.z, wv.w};
        float a[2][4];
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int t = 0; t < 4; ++t) a[dy][t] = p[dy * pitch + t];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int d = 0; d < 4; ++d)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              acc[q][d][k] = __fadd_rn(
                  acc[q][d][k], __fmul_rn(a[d >> 1][2 * q + (d & 1)], wk[k]));
      }
    }
}

__global__ void __launch_bounds__(kThreads, 3)
stem_pair_kernel(const float* __restrict__ x,
                 const float* __restrict__ w0,   // [cin, 3, 3, cmid]
                 const float* __restrict__ b0,
                 const float* __restrict__ w1,   // [cmid, 3, 3, cout]
                 const float* __restrict__ b1, void* __restrict__ out,
                 int n, int h, int w, int cin, int cmid, int cout, int store,
                 int bufs) {
  extern __shared__ __align__(16) float smem[];
  float* s_b0 = smem;
  float* s_b1 = s_b0 + align4(cmid);
  float* s_w0 = s_b1 + align4(cout);          // [cin][3][3][cmid]
  float* s_w1 = s_w0 + 9 * cin * cmid;        // [cmid][3][3][cout]
  float* s_mid = s_w1 + 9 * cmid * cout;      // [cmid][kMid][kMid]
  float* s_in = s_mid + kMid * kMid * cmid;   // [bufs][cin][kIn][kIn]
  const int halo = align4(kIn * kIn * cin);

  const int tid = threadIdx.x;
  const int hm = h / 2, wm = w / 2, ho = h / 4, wo = w / 4;
  const int tiles_x = cdiv(wo, kTile), per_img = tiles_x * cdiv(ho, kTile);
  const int n_tiles = n * per_img;

  auto load_halo = [&](int tile, float* dst) {
    const int img = tile / per_img, r = tile % per_img;
    load_halo_planar(dst, x, img, h, w, cin, 4 * kTile * (r / tiles_x) - 3,
                     4 * kTile * (r % tiles_x) - 3, kIn, kIn);
  };

  // once per block: both weight sets and the biases
  for (int i = tid; i < 9 * cin * cmid / 4; i += kThreads)
    cp_async16(s_w0 + 4 * i, w0 + 4 * i);
  for (int i = tid; i < 9 * cmid * cout / 4; i += kThreads)
    cp_async16(s_w1 + 4 * i, w1 + 4 * i);
  for (int i = tid; i < cmid; i += kThreads) s_b0[i] = b0[i];
  for (int i = tid; i < cout; i += kThreads) s_b1[i] = b1[i];
  int tile = blockIdx.x;
  if (bufs == 2 && tile < n_tiles) load_halo(tile, s_in);
  cp_async_commit();

  const int groups0 = cmid / 4, groups1 = cout / 4;
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const float* cur = s_in + (bufs == 2 ? (it & 1) * halo : 0);
    if (bufs == 2) {   // the next tile's halo loads while this one computes
      if (tile + gridDim.x < n_tiles)
        load_halo(tile + gridDim.x, s_in + ((it + 1) & 1) * halo);
      cp_async_commit();
      cp_async_wait1();
    } else {
      load_halo(tile, s_in);
      cp_async_commit();
      cp_async_wait0();
    }
    __syncthreads();
    const int img = tile / per_img, r = tile % per_img;
    const int ty = r / tiles_x, tx = r % tiles_x;
    // intermediate local (ly, lx) <-> global (2*kTile*ty - 1 + ly, ...);
    // its conv outputs read input local rows 2*ly + dy + u
    const int my0 = 2 * kTile * ty - 1, mx0 = 2 * kTile * tx - 1;

    // stage 0: item = (pair of intermediate pixels, 4-channel group)
    for (int e = tid; e < kMid * kMidHalf * groups0; e += kThreads) {
      const int g = e % groups0, p = e / groups0;
      const int ly = p / kMidHalf, lx = 2 * (p % kMidHalf);
      const int gy = my0 + ly, gx = mx0 + lx;
      const bool row_in = gy >= 0 && gy < hm;
      const bool in[2] = {row_in && gx >= 0 && gx < wm,
                          row_in && gx + 1 >= 0 && gx + 1 < wm};
      float acc[2][4][4] = {};
      if (in[0] || in[1])
        conv_pair_hi(acc, cur, kIn, kIn * kIn, cin, s_w0, cmid, 4 * g,
                     2 * ly, 2 * lx);
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int k = 0; k < 4; ++k)   // zero outside the map: stage 1's pad
          s_mid[((4 * g + k) * kMid + ly) * kMid + lx + q] =
              in[q] ? pool4<false>(acc[q][0][k], acc[q][1][k], acc[q][2][k],
                                   acc[q][3][k], s_b0[4 * g + k])
                    : 0.0f;
    }
    __syncthreads();

    // stage 1: item = (pair of output pixels, 4-channel group); output
    // local (py, px) <-> global (kTile*ty + py, ...), its conv outputs
    // read intermediate local rows 2*py + dy + u
    for (int e = tid; e < kTile * (kTile / 2) * groups1; e += kThreads) {
      const int g = e % groups1, p = e / groups1;
      const int py = p / (kTile / 2), px = 2 * (p % (kTile / 2));
      const int oy = kTile * ty + py, ox = kTile * tx + px;
      if (oy >= ho || ox >= wo) continue;
      float acc[2][4][4] = {};
      conv_pair_hi(acc, s_mid, kMid, kMid * kMid, cmid, s_w1, cout, 4 * g,
                   2 * py, 2 * px);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (ox + q >= wo) continue;
        float m[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          m[k] = pool4<false>(acc[q][0][k], acc[q][1][k], acc[q][2][k],
                              acc[q][3][k], s_b1[4 * g + k]);
        store4(out, ((static_cast<size_t>(img) * ho + oy) * wo + ox + q)
                        * cout + 4 * g, m, store);
      }
    }
    __syncthreads();            // every buffer is free for the next tile
  }
}

template <bool kSelect>
__global__ void __launch_bounds__(kThreads, 3)
stem_pair_tc_kernel(const float* __restrict__ x,
                    const float* __restrict__ w0,   // [cmid, cin, 3, 3]
                    const float* __restrict__ b0,
                    const float* __restrict__ w1,   // [cout, cmid, 3, 3]
                    const float* __restrict__ b1, void* __restrict__ out,
                    int n, int h, int w, int cin, int cmid, int cout,
                    int store) {
  extern __shared__ __align__(16) unsigned char tsm[];
  const int ks0 = cdiv(9 * cin, 16), nt0 = cmid / 8, nt1 = cout / 8;
  const int cs = cdiv(cmid, 16), pitch = 32 * cs;
  const int halo = align4(kIn * kIn * cin);
  uint2* s_w0f = reinterpret_cast<uint2*>(tsm);   // [ks0][nt0][32 lanes]
  uint2* s_w1f = s_w0f + ks0 * nt0 * 32;          // [9*cs][nt1][32 lanes]
  float* s_b0 = reinterpret_cast<float*>(s_w1f + 9 * cs * nt1 * 32);
  float* s_b1 = s_b0 + align4(cmid);
  int* s_koff = reinterpret_cast<int*>(s_b1 + align4(cout));  // [16*ks0]
  float* s_in = reinterpret_cast<float*>(s_koff + 16 * ks0);  // [2][halo]
  unsigned char* s_mid = reinterpret_cast<unsigned char*>(s_in + 2 * halo);
  float* s_out = reinterpret_cast<float*>(s_mid + kMid * kMid * pitch);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t4 = lane & 3;
  const int hm = h / 2, wm = w / 2, ho = h / 4, wo = w / 4;
  const int tiles_x = cdiv(wo, kTile), per_img = tiles_x * cdiv(ho, kTile);
  const int n_tiles = n * per_img;

  // the input halo of a tile, float32 as stored, zero outside the frame:
  // a warp copies whole rows, each a contiguous run of kIn*cin floats
  auto load_halo = [&](int tile, float* dst) {
    const int img = tile / per_img, r = tile % per_img;
    const int iy0 = 4 * kTile * (r / tiles_x) - 3;
    const int ix0 = 4 * kTile * (r % tiles_x) - 3;
    const int run = kIn * cin;
    for (int row = warp; row < kIn; row += kWarps) {
      const int gy = iy0 + row;
      const float* src = x + (static_cast<ptrdiff_t>(img) * h + gy) * w * cin;
      for (int k = lane; k < run; k += 32) {
        const int gk = ix0 * cin + k;   // float index within the frame row
        const bool ok = gy >= 0 && gy < h && gk >= 0 && gk < w * cin;
        cp_async4(dst + row * run + k, ok ? src + gk : x, ok);
      }
    }
  };
  int tile = blockIdx.x;
  if (tile < n_tiles) load_halo(tile, s_in);
  cp_async_commit();

  // once per block: both weight sets rounded to bf16 in fragment order
  // (lane l of n-tile j holds column 8j + l/4, rows 2(l%4), +1, +8, +9 of
  // the k-step), the biases, the tap offsets of stage 0's k (-1 past 9*cin)
  // and the intermediate zeroed (channels past cmid stay zero)
  for (int e = tid; e < ks0 * nt0 * 32; e += kThreads) {
    const int l = e & 31, j = (e >> 5) % nt0, ks = (e >> 5) / nt0;
    const int col = 8 * j + (l >> 2), k = 16 * ks + 2 * (l & 3);
    auto wv = [&](int kk) {   // k = (u*3 + v)*cin + c
      return kk < 9 * cin ? w0[(col * cin + kk % cin) * 9 + kk / cin] : 0.0f;
    };
    s_w0f[e] = make_uint2(pack_bf16(wv(k), wv(k + 1)),
                          pack_bf16(wv(k + 8), wv(k + 9)));
  }
  for (int e = tid; e < 9 * cs * nt1 * 32; e += kThreads) {
    const int l = e & 31, j = (e >> 5) % nt1, ks = (e >> 5) / nt1;
    const int tap = ks / cs, col = 8 * j + (l >> 2);
    const int c = 16 * (ks % cs) + 2 * (l & 3);
    auto wv = [&](int cc) {
      return cc < cmid ? w1[(col * cmid + cc) * 9 + tap] : 0.0f;
    };
    s_w1f[e] = make_uint2(pack_bf16(wv(c), wv(c + 1)),
                          pack_bf16(wv(c + 8), wv(c + 9)));
  }
  for (int i = tid; i < cmid; i += kThreads) s_b0[i] = b0[i];
  for (int i = tid; i < cout; i += kThreads) s_b1[i] = b1[i];
  for (int k = tid; k < 16 * ks0; k += kThreads) {
    const int tap = k / cin;
    s_koff[k] = k < 9 * cin ? ((tap / 3) * kIn + tap % 3) * cin + k % cin
                            : -1;
  }
  for (int i = tid; i < kMid * kMid * pitch / 16; i += kThreads)
    reinterpret_cast<uint4*>(s_mid)[i] = make_uint4(0, 0, 0, 0);

  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    // the next tile's halo loads while this one computes
    const float* cur = s_in + (it & 1) * halo;
    if (tile + gridDim.x < n_tiles)
      load_halo(tile + gridDim.x, s_in + ((it + 1) & 1) * halo);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int img = tile / per_img, r = tile % per_img;
    const int ty = r / tiles_x, tx = r % tiles_x;
    const int my0 = 2 * kTile * ty - 1, mx0 = 2 * kTile * tx - 1;

    // stage 0. A warp takes 8 intermediate pixels at a time (one per row
    // group gid of the mma tile) in two m16 tiles, dy = 0 and 1; rows gid
    // and gid + 8 of a tile are dx = 0 and 1. So a thread's accumulators
    // hold all four conv outputs of its pixel's pool.
    for (int g = warp; 8 * g < kMid * kMid; g += kWarps) {
      const bool live = 8 * g + gid < kMid * kMid;
      const int p = live ? 8 * g + gid : kMid * kMid - 1;
      const int ly = p / kMid, lx = p % kMid;
      const bool inside = my0 + ly >= 0 && my0 + ly < hm && mx0 + lx >= 0
                          && mx0 + lx < wm;
      for (int j0 = 0; j0 < nt0; j0 += 4) {
        float acc[2][4][4] = {};
        for (int ks = 0; ks < ks0; ++ks) {
          const int kb = 16 * ks + 2 * t4;
          const int o0 = s_koff[kb], o1 = s_koff[kb + 1];
          const int o2 = s_koff[kb + 8], o3 = s_koff[kb + 9];
#pragma unroll
          for (int dy = 0; dy < 2; ++dy) {
            const float* p0 = cur + ((2 * ly + dy) * kIn + 2 * lx) * cin;
            const float* p1 = p0 + cin;
            auto at = [](const float* q, int off) {
              return off < 0 ? 0.0f : q[off];
            };
            const unsigned a[4] = {
                pack_bf16(at(p0, o0), at(p0, o1)),
                pack_bf16(at(p1, o0), at(p1, o1)),
                pack_bf16(at(p0, o2), at(p0, o3)),
                pack_bf16(at(p1, o2), at(p1, o3))};
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j0 + j < nt0)
                mma_bf16(acc[dy][j], a, s_w0f[(ks * nt0 + j0 + j) * 32 + lane]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j0 + j >= nt0) continue;
          const int ch = 8 * (j0 + j) + 2 * t4;
          float m[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            m[e] = inside ? pool4<kSelect>(acc[0][j][e], acc[0][j][2 + e],
                                           acc[1][j][e], acc[1][j][2 + e],
                                           s_b0[ch + e])
                          : 0.0f;
          if (live)
            *reinterpret_cast<unsigned*>(
                s_mid + mid_offset(ly, lx, ch >> 3, pitch) + 2 * (ch & 7)) =
                pack_bf16(m[0], m[1]);   // stage 1's bf16 operand
        }
      }
    }
    __syncthreads();

    // stage 1. A warp takes one output row of 8 pixels, again in two m16
    // tiles (dy) whose rows gid and gid + 8 are dx = 0 and 1; A comes
    // from the intermediate by ldmatrix at the tap's offset. Lane l gives
    // the address of row l % 8 of matrix l / 8: matrices 0-3 are (dx 0,
    // channels 0-7), (dx 1, 0-7), (dx 0, 8-15), (dx 1, 8-15).
    const int mrow = lane & 7, mdx = (lane >> 3) & 1, mhalf = lane >> 4;
    for (int py = warp; py < kTile; py += kWarps) {
      const int oy = kTile * ty + py;
      for (int j0 = 0; j0 < nt1; j0 += 4) {
        float acc[2][4][4] = {};
        for (int tap = 0; tap < 9; ++tap) {
          const int u = tap / 3, v = tap % 3;
          for (int sl = 0; sl < cs; ++sl) {
            const int ks = tap * cs + sl;
            unsigned a[2][4];
#pragma unroll
            for (int dy = 0; dy < 2; ++dy)
              ldmatrix_x4(a[dy], s_mid + mid_offset(2 * py + dy + u,
                                                    2 * mrow + mdx + v,
                                                    2 * sl + mhalf, pitch));
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j0 + j < nt1) {
                const uint2 bw = s_w1f[(ks * nt1 + j0 + j) * 32 + lane];
                mma_bf16(acc[0][j], a[0], bw);
                mma_bf16(acc[1][j], a[1], bw);
              }
          }
        }
        // pool in registers, stage through shared memory, and store each
        // pixel's 8-channel groups as 16-byte stores
        float* so = s_out + (warp * 8 + gid) * kOutPitch;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j0 + j >= nt1) continue;
          const int ch = 8 * (j0 + j) + 2 * t4;
          *reinterpret_cast<float2*>(so + 8 * j + 2 * t4) = make_float2(
              pool4<kSelect>(acc[0][j][0], acc[0][j][2], acc[1][j][0],
                             acc[1][j][2], s_b1[ch]),
              pool4<kSelect>(acc[0][j][1], acc[0][j][3], acc[1][j][1],
                             acc[1][j][3], s_b1[ch + 1]));
        }
        __syncwarp();
        const int px = lane >> 2, jj = lane & 3, ox = kTile * tx + px;
        if (j0 + jj < nt1 && oy < ho && ox < wo)
          store8(out,
                 ((static_cast<size_t>(img) * ho + oy) * wo + ox) * cout
                     + 8 * (j0 + jj),
                 s_out + (warp * 8 + px) * kOutPitch + 8 * jj, store);
        __syncwarp();
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------
// Tensor-core pieces shared by K9 and the deep pair at "default".
//
// Weights go through device memory once per call in mma fragment order
// (frag_weights_kernel, into scratch the wrapper allocates): for k-step
// ks = tap * cs + sl (sl a 16-channel slice of the input channels, zero
// past cin) and n-tile j, lane l holds column 8j + l/4 and channels
// 16 sl + 2(l%4), +1, +8, +9 as two bf16 pairs, so a block copies its
// weights with 16-byte cp.async and each lane reads its B fragment as one
// 8-byte word. Activations sit in shared memory as bf16, a pixel's
// channels padded to 16 per slice and its 16-byte chunks a power of two
// (tile_offset), read as A fragments by ldmatrix at each tap's offset.

__host__ __device__ inline int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// bytes of the fragment-order weights of a [cin, 3, 3, cout] layer
__host__ __device__ inline size_t frag_bytes(int cin, int cout) {
  return 256 * static_cast<size_t>(9 * cdiv(cin, 16)) * (cout / 8);
}

// w [cin, 3, 3, cout] float32 -> frag, one uint2 a thread
__global__ void frag_weights_kernel(const float* __restrict__ w,
                                    uint2* __restrict__ frag, int cin,
                                    int cout) {
  const int cs = cdiv(cin, 16), nt = cout / 8;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 9 * cs * nt * 32) return;
  const int l = e & 31, j = (e >> 5) % nt, ks = (e >> 5) / nt;
  const int tap = ks / cs, col = 8 * j + (l >> 2);
  const int c = 16 * (ks % cs) + 2 * (l & 3);
  auto wv = [&](int cc) {
    return cc < cin ? w[(static_cast<size_t>(cc) * 9 + tap) * cout + col]
                    : 0.0f;
  };
  frag[e] = make_uint2(pack_bf16(wv(c), wv(c + 1)),
                       pack_bf16(wv(c + 8), wv(c + 9)));
}

int launch_frag_weights(const void* w, void* frag, int cin, int cout,
                        cudaStream_t st) {
  const int total = 9 * cdiv(cin, 16) * (cout / 8) * 32;
  frag_weights_kernel<<<cdiv(total, kThreads), kThreads, 0, st>>>(
      static_cast<const float*>(w), static_cast<uint2*>(frag), cin, cout);
  return static_cast<int>(cudaGetLastError());
}

// Byte offset of 16-byte chunk `chunk` of pixel (row, col) in a bf16
// activation tile `half` columns per parity, `units` chunks a pixel (a
// power of two). Columns are split by parity, so the stride-2 columns one
// pool position reads lie side by side, and the chunk index is XORed with
// bits of the column's place so that the eight pixels of one ldmatrix
// phase fall on eight distinct 16-byte bank groups.
__device__ __forceinline__ int tile_offset(int row, int col, int chunk,
                                           int half, int units) {
  const int idx = col >> 1;
  const int swz = units >= 8 ? idx & 7
                             : (idx >> (units == 4 ? 1 : 2)) & (units - 1);
  return (((row * 2 + (col & 1)) * half + idx) * units + (chunk ^ swz)) << 4;
}

// A float32 NHWC halo into a bf16 activation tile: rows x cols pixels from
// global (y0, x0) of image img, zero outside the frame and past cin, in
// 16-byte chunks of 8 channels (2 cs chunks a pixel).
__device__ __forceinline__ void load_halo_bf16(
    unsigned char* dst, const float* __restrict__ x, int img, int h, int w,
    int cin, int y0, int x0, int rows, int cols, int units) {
  const int cc = 2 * cdiv(cin, 16);
  for (int e = threadIdx.x; e < rows * cols * cc; e += blockDim.x) {
    const int ch = e % cc, pix = e / cc;
    const int ly = pix / cols, lx = pix % cols;
    const int gy = y0 + ly, gx = x0 + lx, c0 = 8 * ch;
    float v[8];
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const float* src = x + ((static_cast<size_t>(img) * h + gy) * w + gx) * cin
                       + c0;
    if (in && (cin & 7) == 0) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(src));
      const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = in && c0 + k < cin ? src[k] : 0.0f;
    }
    *reinterpret_cast<uint4*>(dst + tile_offset(ly, lx, ch, cols / 2, units)) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

// One warp's 2x2-pooled conv row: 8 pooled pixels (px = 0..7 of pooled
// row py) x 4 n-tiles (channels 8 (jw + j), j < 4, n-tiles past nj
// skipped), an implicit GEMM over 9 taps x cs slices of a 16x16 conv
// window read from the bf16 tile `act` (18 columns, rows 2py + dy + u),
// weights `wf` with `wstride` n-tiles a k-step, first n-tile jw0. Rows
// gid and gid + 8 of m16 tile dy are conv positions (2py + dy, 2 gid) and
// (2py + dy, 2 gid + 1), so acc[dy][j] holds a pooled pixel's four conv
// outputs in registers. Lane l gives ldmatrix the address of row l % 8 of
// matrix l / 8: matrices 0-3 are (dx 0, channels 0-7), (dx 1, 0-7),
// (dx 0, 8-15), (dx 1, 8-15) of the slice.
__device__ __forceinline__ void conv_row_mma(
    float (&acc)[2][4][4], const unsigned char* act, int units, int py,
    int cs, int taps0, int ntaps, const uint2* wf, int wstride, int jw0,
    int nj) {
  const int lane = threadIdx.x & 31;
  const int mrow = lane & 7, mdx = (lane >> 3) & 1, mhalf = lane >> 4;
  for (int t = 0; t < ntaps; ++t) {
    const int tap = taps0 + t, u = tap / 3, v = tap % 3;
    for (int sl = 0; sl < cs; ++sl) {
      const int ks = t * cs + sl;
      unsigned a[2][4];
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
        ldmatrix_x4(a[dy], act + tile_offset(2 * py + dy + u,
                                             2 * mrow + mdx + v,
                                             2 * sl + mhalf, kMidHalf, units));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nj) {
          const uint2 bw = wf[(ks * wstride + jw0 + j) * 32 + lane];
          mma_bf16(acc[0][j], a[0], bw);
          mma_bf16(acc[1][j], a[1], bw);
        }
    }
  }
}

// +bias, leaky, the 2x2 max (and K8's select) of a warp's 8 pooled pixels
// x 4 n-tiles, staged through the warp's 8 x kOutPitch floats of shared
// memory so that each pixel's 8-channel groups go out as 16-byte stores.
// ch0: the output channel of n-tile 0; px >= wo and n-tiles past nj are
// not stored.
template <bool kSelect>
__device__ __forceinline__ void pool_store_row(
    const float (&acc)[2][4][4], const float* bias, float* so_warp, void* out,
    size_t row_base, int ox0, int wo, int cout, int ch0, int nj, int store) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, t4 = lane & 3;
  float* so = so_warp + gid * kOutPitch;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= nj) continue;
    const int c = 8 * j + 2 * t4;
    *reinterpret_cast<float2*>(so + c) = make_float2(
        pool4<kSelect>(acc[0][j][0], acc[0][j][2], acc[1][j][0], acc[1][j][2],
                       bias[c]),
        pool4<kSelect>(acc[0][j][1], acc[0][j][3], acc[1][j][1], acc[1][j][3],
                       bias[c + 1]));
  }
  __syncwarp();
  const int px = lane >> 2, jj = lane & 3;
  if (jj < nj && ox0 + px < wo)
    store8(out, (row_base + ox0 + px) * cout + ch0 + 8 * jj,
           so_warp + px * kOutPitch + 8 * jj, store);
  __syncwarp();
}

// ---------------------------------------------------------------------
// Kernel K9 at precision "default" on the tensor cores (see the K9 note
// below for the function). A persistent grid of 256-thread blocks, each
// fixed on one slice of `slice` output channels whose bf16 weights it
// copies once into shared memory, walks 8x8 tiles of pooled pixels with
// a stride of the grid. Per tile: the 18x18 float32 input halo is rounded
// to bf16 as it lands in shared memory (two 16-byte loads per 8
// channels); then each warp computes one pooled row as an implicit GEMM
// (M = its 2 x 16 conv positions, N = the slice, K = 9 taps x Cin padded
// to 16), 4 n-tiles at a time, with the bias, leaky, pool and store
// rounding in registers and 16-byte stores. Warps whose pooled row lies
// past the map skip the products (26 px maps fill a third of their last
// tile row).
__host__ __device__ inline size_t stage_tc_smem_bytes(int cin, int slice) {
  const int units = pow2_at_least(2 * cdiv(cin, 16));
  return frag_bytes(cin, slice) + 4 * slice + 16 * kMid * kMid * units
         + 4 * kWarps * 8 * kOutPitch;
}

__global__ void __launch_bounds__(kThreads, 2)
stem_stage_tc_kernel(const float* __restrict__ x,
                     const uint2* __restrict__ wf,  // frag order, all cout
                     const float* __restrict__ bias, void* __restrict__ out,
                     int n, int h, int w, int cin, int cout, int slice,
                     int store) {
  extern __shared__ __align__(16) unsigned char ssm[];
  const int cs = cdiv(cin, 16), units = pow2_at_least(2 * cs);
  const int nt = cout / 8, nts = slice / 8, nsl = cdiv(nt, nts);
  uint2* s_w = reinterpret_cast<uint2*>(ssm);            // [9*cs][nts][32]
  float* s_b = reinterpret_cast<float*>(s_w + 9 * cs * nts * 32);
  unsigned char* s_in = reinterpret_cast<unsigned char*>(s_b + slice);
  float* s_out = reinterpret_cast<float*>(s_in + 16 * kMid * kMid * units);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int ho = h / 2, wo = w / 2;
  const int tiles_x = cdiv(wo, kTile), per_img = tiles_x * cdiv(ho, kTile);
  const int n_items = n * per_img * nsl;
  // the grid is a multiple of nsl, so a block keeps its slice
  const int j_base = (blockIdx.x % nsl) * nts, nj = min(nts, nt - j_base);
  for (int e = tid; e < 9 * cs * nj * 16; e += kThreads) {
    const int row = e / (nj * 16), q = e % (nj * 16);
    cp_async16(reinterpret_cast<unsigned char*>(s_w + row * nts * 32) + 16 * q,
               reinterpret_cast<const unsigned char*>(
                   wf + (static_cast<size_t>(row) * nt + j_base) * 32)
                   + 16 * q);
  }
  cp_async_commit();
  for (int i = tid; i < 8 * nj; i += kThreads) s_b[i] = bias[8 * j_base + i];
  cp_async_wait0();

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int tile = item / nsl, img = tile / per_img, r = tile % per_img;
    const int ty = r / tiles_x, tx = r % tiles_x;
    __syncthreads();                 // the previous tile's halo is consumed
    load_halo_bf16(s_in, x, img, h, w, cin, 2 * kTile * ty - 1,
                   2 * kTile * tx - 1, kMid, kMid, units);
    __syncthreads();
    const int oy = kTile * ty + warp;
    if (oy >= ho) continue;
    const size_t row_base = (static_cast<size_t>(img) * ho + oy) * wo;
    for (int j0 = 0; j0 < nj; j0 += 4) {
      float acc[2][4][4] = {};
      conv_row_mma(acc, s_in, units, warp, cs, 0, 9, s_w, nts, j0, nj - j0);
      pool_store_row<false>(acc, s_b + 8 * j0, s_out + warp * 8 * kOutPitch,
                            out, row_base, kTile * tx, wo, cout,
                            8 * (j_base + j0), nj - j0, store);
    }
  }
}

// ---------------------------------------------------------------------
// The deep pair at precision "default" on the tensor cores (see the deep
// pair's note below for the function). A persistent grid, one 512-thread
// block an SM (16 warps: mma.sync needs that many in flight to hide its
// operand latency), each walking 8x8 tiles of output pixels. Per tile:
//  - the 38x38 float32 input halo is rounded to bf16 into shared memory;
//  - stage 0, an implicit GEMM with M = the conv positions of the 18x18
//    intermediate (one halo pixel each side), N = Cmid, K = 9 taps x Cin
//    (w0 resident in shared memory, fragment order): a warp takes 8
//    intermediate pixels x 4 n-tiles at a time, the pixels in two m16
//    tiles (dy) whose rows gid and gid + 8 are dx 0 and 1, so the pool,
//    bias, leaky, K8's select and the bf16 rounding are a register
//    epilogue into the bf16 intermediate (zero outside the H/2 x W/2 map:
//    stage 1's padding). Groups of 8 pixels wholly outside the map only
//    write their zeros;
//  - stage 1, an implicit GEMM with M = the 16x16 conv positions, N =
//    Cout, K = 9 taps x Cmid, a warp taking one pooled row x 4 n-tiles,
//    A by ldmatrix from the intermediate. w1 (147 KB in bf16 at
//    64 -> 128) does not fit beside the rest, so it streams through two
//    shared buffers one (group of 64 output channels, tap) step at a
//    time, the next step's 16-byte cp.async copies in flight while this
//    one computes.
// 8x8 output tiles rather than 4x4: a warp's m16 tiles take one pooled
// row of 8 pixels, so a 4-pixel row would leave half of each product
// empty, and stage 0 would recompute 1.56x its halo.
constexpr int kDeepThreads = 512;
constexpr int kDeepWarps = kDeepThreads / 32;
constexpr int kDeepIn = 4 * kTile + 6;          // 38 input pixels a side
constexpr int kDeepNj = 8;                      // n-tiles per w1 step

__host__ __device__ inline size_t deep_tc_smem_bytes(int cin, int cmid,
                                                     int cout) {
  const int cs1 = cdiv(cmid, 16);
  return frag_bytes(cin, cmid) + 2 * 256 * static_cast<size_t>(cs1) * kDeepNj
         + 4 * (align4(cmid) + align4(cout))
         + 16 * kDeepIn * kDeepIn * pow2_at_least(2 * cdiv(cin, 16))
         + 16 * kMid * kMid * pow2_at_least(2 * cs1)
         + 4 * kDeepWarps * 8 * kOutPitch;
}

template <bool kSelect>
__global__ void __launch_bounds__(kDeepThreads, 1)
stem_pair_deep_tc_kernel(const float* __restrict__ x,
                         const uint2* __restrict__ wf0,  // frag, cin -> cmid
                         const float* __restrict__ b0,
                         const uint2* __restrict__ wf1,  // frag, cmid -> cout
                         const float* __restrict__ b1, void* __restrict__ out,
                         int n, int h, int w, int cin, int cmid, int cout,
                         int store) {
  extern __shared__ __align__(16) unsigned char dsm[];
  const int cs0 = cdiv(cin, 16), cs1 = cdiv(cmid, 16);
  const int u0 = pow2_at_least(2 * cs0), u1 = pow2_at_least(2 * cs1);
  const int nt0 = cmid / 8, nt1 = cout / 8;
  const int step_words = cs1 * kDeepNj * 32;     // uint2 per w1 buffer
  uint2* s_w0 = reinterpret_cast<uint2*>(dsm);   // [9*cs0][nt0][32]
  uint2* s_w1 = s_w0 + 9 * cs0 * nt0 * 32;        // [2][cs1][kDeepNj][32]
  float* s_b0 = reinterpret_cast<float*>(s_w1 + 2 * step_words);
  float* s_b1 = s_b0 + align4(cmid);
  unsigned char* s_in = reinterpret_cast<unsigned char*>(s_b1 + align4(cout));
  unsigned char* s_mid = s_in + 16 * kDeepIn * kDeepIn * u0;
  float* s_out = reinterpret_cast<float*>(s_mid + 16 * kMid * kMid * u1);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t4 = lane & 3;
  const int mrow = lane & 7, mdx = (lane >> 3) & 1, mhalf = lane >> 4;
  const int hm = h / 2, wm = w / 2, ho = h / 4, wo = w / 4;
  const int tiles_x = cdiv(wo, kTile), per_img = tiles_x * cdiv(ho, kTile);
  const int n_tiles = n * per_img;
  const int groups1 = cdiv(nt1, kDeepNj), steps = 9 * groups1;
  const int passes0 = cdiv(nt0, 4);

  // w1 step s = (group of kDeepNj n-tiles, tap) into buffer s & 1
  auto fetch_w1 = [&](int s) {
    const int grp = s / 9, tap = s % 9;
    const int jn = min(kDeepNj, nt1 - grp * kDeepNj);
    uint2* dst = s_w1 + (s & 1) * step_words;
    for (int e = tid; e < cs1 * jn * 16; e += kDeepThreads) {
      const int sl = e / (jn * 16), q = e % (jn * 16);
      cp_async16(reinterpret_cast<unsigned char*>(dst + sl * kDeepNj * 32)
                     + 16 * q,
                 reinterpret_cast<const unsigned char*>(
                     wf1 + ((static_cast<size_t>(tap) * cs1 + sl) * nt1
                            + grp * kDeepNj) * 32) + 16 * q);
    }
  };

  // once per block: w0 in fragment order, the biases, and the
  // intermediate zeroed (channels past cmid stay zero)
  for (int e = tid; e < 9 * cs0 * nt0 * 16; e += kDeepThreads)
    cp_async16(reinterpret_cast<unsigned char*>(s_w0) + 16 * e,
               reinterpret_cast<const unsigned char*>(wf0) + 16 * e);
  cp_async_commit();
  for (int i = tid; i < cmid; i += kDeepThreads) s_b0[i] = b0[i];
  for (int i = tid; i < cout; i += kDeepThreads) s_b1[i] = b1[i];
  for (int i = tid; i < kMid * kMid * u1; i += kDeepThreads)
    reinterpret_cast<uint4*>(s_mid)[i] = make_uint4(0, 0, 0, 0);
  cp_async_wait0();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int img = tile / per_img, r = tile % per_img;
    const int ty = r / tiles_x, tx = r % tiles_x;
    const int my0 = 2 * kTile * ty - 1, mx0 = 2 * kTile * tx - 1;
    __syncthreads();            // the previous tile is done with every buffer
    fetch_w1(0);                // lands while stage 0 computes
    cp_async_commit();
    load_halo_bf16(s_in, x, img, h, w, cin, 4 * kTile * ty - 3,
                   4 * kTile * tx - 3, kDeepIn, kDeepIn, u0);
    __syncthreads();

    // stage 0: item it = (group g of 8 intermediate pixels, pass of 4
    // n-tiles)
    for (int it = warp; it < cdiv(kMid * kMid, 8) * passes0;
         it += kDeepWarps) {
      const int g = it / passes0, j0 = 4 * (it % passes0);
      const bool live = 8 * g + gid < kMid * kMid;
      const int p = live ? 8 * g + gid : kMid * kMid - 1;
      const int ly = p / kMid, lx = p % kMid;
      const bool inside = live && my0 + ly >= 0 && my0 + ly < hm
                          && mx0 + lx >= 0 && mx0 + lx < wm;
      const int pa = min(8 * g + mrow, kMid * kMid - 1);   // ldmatrix row
      const int ay = pa / kMid, ax = pa % kMid;
      float acc[2][4][4] = {};
      if (__any_sync(0xffffffffu, inside))
        for (int tap = 0; tap < 9; ++tap) {
          const int u = tap / 3, v = tap % 3;
          for (int sl = 0; sl < cs0; ++sl) {
            const int ks = tap * cs0 + sl;
            unsigned a[2][4];
#pragma unroll
            for (int dy = 0; dy < 2; ++dy)
              ldmatrix_x4(a[dy], s_in + tile_offset(2 * ay + dy + u,
                                                    2 * ax + mdx + v,
                                                    2 * sl + mhalf,
                                                    kDeepIn / 2, u0));
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j0 + j < nt0) {
                const uint2 bw = s_w0[(ks * nt0 + j0 + j) * 32 + lane];
                mma_bf16(acc[0][j], a[0], bw);
                mma_bf16(acc[1][j], a[1], bw);
              }
          }
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j0 + j >= nt0) continue;
        const int ch = 8 * (j0 + j) + 2 * t4;
        float m[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          m[e] = inside ? pool4<kSelect>(acc[0][j][e], acc[0][j][2 + e],
                                         acc[1][j][e], acc[1][j][2 + e],
                                         s_b0[ch + e])
                        : 0.0f;
        if (live)
          *reinterpret_cast<unsigned*>(
              s_mid + tile_offset(ly, lx, ch >> 3, kMidHalf, u1)
              + 2 * (ch & 7)) = pack_bf16(m[0], m[1]);   // stage 1's operand
      }
    }

    // stage 1: w1 streams by (group, tap) steps through two buffers; warp
    // w takes pooled row w % 8 and n-tiles 4 (w / 8) .. + 3 of the group
    const int py = warp % kTile, jq = 4 * (warp / kTile);
    const int oy = kTile * ty + py;
    const size_t row_base = (static_cast<size_t>(img) * ho + oy) * wo;
    float acc[2][4][4];
    for (int s = 0; s < steps; ++s) {
      if (s + 1 < steps) fetch_w1(s + 1);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();          // step s's weights (and, at s = 0, the
                                // intermediate) are in shared memory
      const int grp = s / 9, tap = s % 9;
      const int jn = min(kDeepNj, nt1 - grp * kDeepNj) - jq;
      if (tap == 0)
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[dy][j][e] = 0.0f;
      if (oy < ho && jn > 0) {
        conv_row_mma(acc, s_mid, u1, py, cs1, tap, 1,
                     s_w1 + (s & 1) * step_words, kDeepNj, jq, jn);
        if (tap == 8) {
          const int ch0 = (grp * kDeepNj + jq) * 8;
          pool_store_row<kSelect>(acc, s_b1 + ch0,
                                  s_out + warp * 8 * kOutPitch, out, row_base,
                                  kTile * tx, wo, cout, ch0, jn, store);
        }
      }
      __syncthreads();          // buffer s & 1 is free for step s + 2
    }
  }
}

// ---------------------------------------------------------------------
// The deep pair (kernel K12 at stages 4+6 of the network): the pair's
// function at 104 px, 32 -> 64 -> 128 channels, bf16 store.
//
// Replaces: millieye_tpu/ops/stem_pallas_rejected.py:fused_stem2_s2d with
// groups0=2, as models/darknet.py runs it for the second pair of
// pallas_stem_pairs="all" (the pallas_pair2 preset), and the pair wrappers
// (K4, K8, K11, K12) at channel counts whose weights and halos do not fit
// the stem pair's shared memory. Numerics as the stem pair above, at
// either precision, K8's select included; the sums run over (c, u, v), c
// slowest, as in K9, so the CUDA-core kernels are bit-equal to the plain
// version.
//
// Bound on an H100, per image: 0.80 GFLOP of products (2 x 398.7 MFLOP;
// 0.81 us at the bf16 989 TFLOP/s, 11.9 us on the 67 TFLOP/s float32
// cores) against 1.38 MB of float32 input and 0.17 MB of bf16 output
// (0.46 us at 3.35 TB/s): operations. At "default" the tensor-core kernel
// above runs it (stem_pair_deep_tc_kernel), and where its halos and
// weights do not fit shared memory (Cin above 32 at Cmid 64) the
// CUDA-core kernel stem_pair_deep_kernel below.
//
// At "highest", two launches of deep_stage_kernel: stage 0 writes its
// pooled float32 intermediate [n, h/2, w/2, cmid] to device scratch (0.69
// MB an image at 104 px, 22 MB at batch 32: it stays in the 50 MB L2),
// stage 1 reads it. Nothing is recomputed, and each launch has enough
// blocks to cover the 132 SMs at batch 1 (182 and 112). Each product is
// rounded before its add (__fmul_rn, __fadd_rn: two issue slots), so the
// ceiling is 797 M float32 instructions an image, 0.76-0.86 ms at batch
// 32 (132 SMs x 128 lanes x 1.755-1.98 GHz). FMAs would halve it, but
// would leave the plain version's order of roundings: 16-bit outputs
// would then differ by an ulp in a few per thousand, more near zero.
//
// deep_stage_kernel: out = maxpool2(leaky(conv3x3(x, w) + b)), NHWC
// float32 x, [cin, 3, 3, cout] w. A 128-thread block takes a tile of 4x8
// pooled pixels and a slice of 32 output channels; input channels go
// through shared memory in chunks of 16 (the 10x18 halo of the chunk,
// planar with an even row pitch, and the slice's weights [c][u][v][co]:
// 30 KB, several blocks an SM). A thread owns 4 channels of 2
// horizontally adjacent pixels at all four pool positions (32 sums);
// lanes run the 4-channel groups fastest, so a weight load is one float4
// read side by side by 8 lanes, and the 4 pixel pairs of a warp read one
// halo row. Per input channel a thread loads its 4x6 patch (12 float2
// loads) once for the 9 taps and 9 float4 weight loads: 288 products.
// The (image, slice, tile) items lie on a 1-D grid, so the batch has no
// grid dimension's cap (a grid z of images x slices refused n >= 16384
// at Cout 128).
//
// The same kernel takes K9 where K9's persistent kernel below does not
// hold its weights and halo in shared memory, at "highest" and, where
// not even the tensor-core kernel's narrowest weight slice fits (Cin
// above 256), at "default": there x and w are rounded to bf16 as they
// land in shared memory and each product is exact, so an FMA rounds like
// the plain version's multiply-then-add.
constexpr int kFRows = 4;                 // pooled pixels per tile: rows
constexpr int kFCols = 8;                 //   and columns
constexpr int kFInRows = 2 * kFRows + 2;  // 10 input rows
constexpr int kFInCols = 2 * kFCols + 2;  // 18 input columns
constexpr int kFCo = 32;                  // output channels per block
constexpr int kFCk = 16;                  // input channels per chunk
constexpr int kFThreads = 128;

// One input channel's share of two horizontally adjacent pooled pixels x
// 4 output channels at the four pool positions (acc[q][d][k]: pixel q,
// pool position d = 2 dy + dx, channel k): the pair's 4x6 patch at ps
// (planar, row pitch `pitch`, 8-byte aligned) read once as 12 float2,
// then per tap (u, v), u slowest, a float4 of weights at sw + (u * 3 + v)
// * nco and 32 products. At "highest" each product is rounded before its
// add; else the operands are bf16 values and an FMA rounds alike.
template <bool kHighest>
__device__ __forceinline__ void conv_chan_cuv(float (&acc)[2][4][4],
                                              const float* ps, int pitch,
                                              const float* sw, int nco) {
  float patch[4][6];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const float2 a =
          *reinterpret_cast<const float2*>(ps + r * pitch + 2 * t);
      patch[r][2 * t] = a.x;
      patch[r][2 * t + 1] = a.y;
    }
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const float4 wv =
          *reinterpret_cast<const float4*>(sw + (u * 3 + v) * nco);
      const float wk[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const float xv = patch[(d >> 1) + u][2 * q + (d & 1) + v];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[q][d][k] = kHighest
                ? __fadd_rn(acc[q][d][k], __fmul_rn(xv, wk[k]))
                : fmaf(xv, wk[k], acc[q][d][k]);
        }
    }
}

template <bool kHighest>
__global__ void __launch_bounds__(kFThreads)
deep_stage_kernel(const float* __restrict__ x,
                  const float* __restrict__ wgt,   // [cin, 3, 3, cout]
                  const float* __restrict__ bias, void* __restrict__ out,
                  int n_img, int h, int w, int cin, int cout, int store) {
  __shared__ __align__(16) float s_in[kFCk * kFInRows * kFInCols];
  __shared__ __align__(16) float s_w[kFCk * 9 * kFCo];

  const int tid = threadIdx.x;
  const int slices = cdiv(cout, kFCo);
  const int ho = h / 2, wo = w / 2;
  const int tiles_x = cdiv(wo, kFCols), tiles_y = cdiv(ho, kFRows);
  const long long n_items =
      static_cast<long long>(n_img) * slices * tiles_y * tiles_x;
  const int g = tid % (kFCo / 4), pp = tid / (kFCo / 4);
  const int py = pp / (kFCols / 2), px = 2 * (pp % (kFCols / 2));
  const bool vec = (cin & 3) == 0;

  // items (image, slice, tile row, tile column), the column fastest: the
  // order of the blocks of a (columns, rows, images x slices) grid
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int tx = static_cast<int>(item % tiles_x);
    const int ty = static_cast<int>(item / tiles_x % tiles_y);
    const long long z = item / (static_cast<long long>(tiles_x) * tiles_y);
    const int n = static_cast<int>(z / slices);
    const int co0 = static_cast<int>(z % slices) * kFCo;
    const int co_n = min(kFCo, cout - co0);       // a multiple of 8
    const int oy = kFRows * ty + py, ox = kFCols * tx + px;
    const bool active = 4 * g < co_n;
    // input halo: local (ly, lx) <-> global (2*kFRows*ty - 1 + ly, ...)
    const int iy0 = 2 * kFRows * ty - 1;
    const int ix0 = 2 * kFCols * tx - 1;
    const float* xn = x + static_cast<size_t>(n) * h * w * cin;

    float acc[2][4][4] = {};
    for (int c0 = 0; c0 < cin; c0 += kFCk) {
      const int cn = min(kFCk, cin - c0);
      __syncthreads();                     // the previous chunk is consumed
      // the halo: 4 channels an item, a float4 where cin allows
      for (int e = tid; e < kFInRows * kFInCols * (kFCk / 4); e += kFThreads) {
        const int q = e % (kFCk / 4), p = e / (kFCk / 4);
        const int ly = p / kFInCols, lx = p % kFInCols;
        const int gy = iy0 + ly, gx = ix0 + lx, c = 4 * q;
        if (c >= cn) continue;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
          const float* src = xn + (static_cast<size_t>(gy) * w + gx) * cin + c0
                             + c;
          if (vec) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(src));
            v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) v[k] = c + k < cn ? src[k] : 0.0f;
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          s_in[((c + k) * kFInRows + ly) * kFInCols + lx] =
              kHighest ? v[k] : bf16_round(v[k]);
      }
      // the slice's weights, zero past co_n
      for (int e = tid; e < cn * 9 * (kFCo / 4); e += kFThreads) {
        // row = c * 9 + tap
        const int q = e % (kFCo / 4), row = e / (kFCo / 4);
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (4 * q < co_n)
          v = __ldg(reinterpret_cast<const float4*>(
              wgt + (static_cast<size_t>(c0) * 9 + row) * cout + co0 + 4 * q));
        if (!kHighest)
          v = make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z),
                          bf16_round(v.w));
        *reinterpret_cast<float4*>(s_w + row * kFCo + 4 * q) = v;
      }
      __syncthreads();
      if (!active) continue;
      // the pair's 4x6 patch: rows 2 py + (0..3), columns 2 px + (0..5)
      for (int c = 0; c < cn; ++c)
        conv_chan_cuv<kHighest>(
            acc, s_in + (c * kFInRows + 2 * py) * kFInCols + 2 * px, kFInCols,
            s_w + c * 9 * kFCo + 4 * g, kFCo);
    }
    if (!active || oy >= ho) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (ox + q >= wo) continue;
      float m[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        m[k] = pool4<false>(acc[q][0][k], acc[q][1][k], acc[q][2][k],
                            acc[q][3][k], bias[co0 + 4 * g + k]);
      store4(out, ((static_cast<size_t>(n) * ho + oy) * wo + ox + q) * cout
                      + co0 + 4 * g, m, store);
    }
  }
}

// One block an item up to the largest 1-D grid; past it each block walks
// the items with a stride of the grid (any batch that fits in memory).
int launch_deep_stage(const float* x, const float* wgt, const float* bias,
                      void* out, int n, int h, int w, int cin, int cout,
                      int highest, int store, cudaStream_t st) {
  const long long items = static_cast<long long>(n) * cdiv(cout, kFCo)
                          * cdiv(h / 2, kFRows) * cdiv(w / 2, kFCols);
  const unsigned grid = static_cast<unsigned>(
      items < 0x7fffffffLL ? items : 0x7fffffffLL);
  auto kernel = highest ? deep_stage_kernel<true> : deep_stage_kernel<false>;
  kernel<<<grid, kFThreads, 0, st>>>(x, wgt, bias, out, n, h, w, cin, cout,
                                     store);
  return static_cast<int>(cudaGetLastError());
}

// The CUDA-core kernel at "default", for the widths the tensor-core
// kernel's shared memory does not hold. The stem pair's layout does not
// fit them: w0 and w1 hold 92,160 weights at 32 -> 64 -> 128 (184 KB in
// bf16), and the 38x38x32 input halo of an 8x8 output tile is another
// 92 KB, against 227 KB a block may have. So, as deep_stage_kernel does,
// channels go through shared memory in chunks, here of 8: the 22x22
// input halo of the chunk (planar, a padded row pitch) with its w0 slice,
// then, for stage 1, the w1 slice. Only the stage-0 intermediate of the tile
// stays whole (10x10xCmid float32, 28 KB at Cmid 64). The output tile is
// 4x4 pooled pixels, at the cost of recomputing the stage-0 halo (a 10x10
// intermediate for 8x8 stage-1 positions, 1.56x the stage-0 work). A
// thread owns 8 channels of one pixel at all four pool positions (32
// accumulators); the sums run over (c, u, v), c slowest, as in K9, on
// bf16 operands (each product exact in float32, so the FMA rounds like
// the plain version's add). The (image, tile) items lie on a 1-D grid, so
// the batch has no grid dimension's cap.
constexpr int kDTile = 4;                 // output pixels per tile side
constexpr int kDMid = 2 * kDTile + 2;     // 10 intermediate pixels
constexpr int kDIn = 4 * kDTile + 6;      // 22 input pixels
constexpr int kDMidPitch = kDMid + 1;
constexpr int kDInPitch = kDIn + 1;
constexpr int kDCk = 8;                   // channels per chunk

__host__ __device__ inline size_t deep_smem_floats(int cmid, int cout) {
  const int chunk0 = align4(kDCk * kDIn * kDInPitch) + kDCk * 9 * cmid;
  const int chunk1 = kDCk * 9 * cout;
  return align4(cmid * kDMid * kDMidPitch)
         + (chunk0 > chunk1 ? chunk0 : chunk1);
}

__global__ void __launch_bounds__(kThreads)
stem_pair_deep_kernel(const float* __restrict__ x,
                      const float* __restrict__ w0,   // [cin, 3, 3, cmid]
                      const float* __restrict__ b0,
                      const float* __restrict__ w1,   // [cmid, 3, 3, cout]
                      const float* __restrict__ b1, void* __restrict__ out,
                      int n_img, int h, int w, int cin, int cmid, int cout,
                      int store, int select) {
  extern __shared__ __align__(16) float dsmem[];
  float* s_mid = dsmem;                     // [cmid][kDMid][kDMidPitch]
  float* s_chunk = s_mid + align4(cmid * kDMid * kDMidPitch);
  float* s_in = s_chunk;                    // [kDCk][kDIn][kDInPitch]
  float* s_w0 = s_in + align4(kDCk * kDIn * kDInPitch);  // [kDCk*9][cmid]
  float* s_w1 = s_chunk;                    // [kDCk*9][cout]

  const int tid = threadIdx.x;
  const int hm = h / 2, wm = w / 2, ho = h / 4, wo = w / 4;
  const int tiles_x = cdiv(wo, kDTile), tiles_y = cdiv(ho, kDTile);
  const long long n_tiles =
      static_cast<long long>(n_img) * tiles_y * tiles_x;

  // tiles (image, row, column), the column fastest: the order of the
  // blocks of a (columns, rows, images) grid
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int tx = static_cast<int>(tile % tiles_x);
    const int ty = static_cast<int>(tile / tiles_x % tiles_y);
    const int n = static_cast<int>(tile / (static_cast<long long>(tiles_x)
                                          * tiles_y));
    const float* xn = x + static_cast<size_t>(n) * h * w * cin;
    // input local (ly, lx) <-> global (4*kDTile*ty - 3 + ly, ...);
    // intermediate local <-> global (2*kDTile*ty - 1 + ly, ...)
    const int iy0 = 4 * kDTile * ty - 3, ix0 = 4 * kDTile * tx - 3;
    const int my0 = 2 * kDTile * ty - 1, mx0 = 2 * kDTile * tx - 1;

    // stage 0, in rounds of kThreads (pixel, channel group) items
    const int items0 = kDMid * kDMid * (cmid / kGroup);
    for (int base = 0; base < items0; base += kThreads) {
      const int e = base + tid;
      const bool active = e < items0;
      const int pix = e % (kDMid * kDMid), g = e / (kDMid * kDMid);
      const int ly = pix / kDMid, lx = pix % kDMid;
      float acc[4][kGroup] = {};
      for (int c0 = 0; c0 < cin; c0 += kDCk) {
        const int cn = min(kDCk, cin - c0);
        __syncthreads();                   // the previous chunk is consumed
        for (int i = tid; i < kDIn * kDIn * cn; i += kThreads) {
          const int c = i % cn, p = i / cn;
          const int gy = iy0 + p / kDIn, gx = ix0 + p % kDIn;
          float v = 0.0f;
          if (gy >= 0 && gy < h && gx >= 0 && gx < w)
            v = xn[(static_cast<size_t>(gy) * w + gx) * cin + c0 + c];
          v = bf16_round(v);
          s_in[(c * kDIn + p / kDIn) * kDInPitch + p % kDIn] = v;
        }
        const float* wsrc = w0 + static_cast<size_t>(c0) * 9 * cmid;
        for (int i = tid; i < cn * 9 * cmid; i += kThreads)
          s_w0[i] = bf16_round(wsrc[i]);
        __syncthreads();
        if (!active) continue;
        for (int c = 0; c < cn; ++c) {
          float patch[4][4];
          for (int r = 0; r < 4; ++r)
            for (int q = 0; q < 4; ++q)
              patch[r][q] = s_in[(c * kDIn + 2 * ly + r) * kDInPitch + 2 * lx
                                 + q];
          for (int u = 0; u < 3; ++u)
            for (int v = 0; v < 3; ++v) {
              const float4* wr = reinterpret_cast<const float4*>(
                  s_w0 + (c * 9 + u * 3 + v) * cmid + g * kGroup);
              const float4 wa = wr[0], wb = wr[1];
              const float wv[kGroup] = {wa.x, wa.y, wa.z, wa.w,
                                        wb.x, wb.y, wb.z, wb.w};
              for (int d = 0; d < 4; ++d) {
                const float xv = patch[(d >> 1) + u][(d & 1) + v];
                for (int k = 0; k < kGroup; ++k)
                  acc[d][k] = fmaf(xv, wv[k], acc[d][k]);
              }
            }
        }
      }
      if (!active) continue;
      const int gy = my0 + ly, gx = mx0 + lx;
      const bool inside = gy >= 0 && gy < hm && gx >= 0 && gx < wm;
      for (int k = 0; k < kGroup; ++k) {
        const float bias = b0[g * kGroup + k];
        float m = leaky(__fadd_rn(acc[0][k], bias));
        for (int d = 1; d < 4; ++d)
          m = fmaxf(m, leaky(__fadd_rn(acc[d][k], bias)));
        if (select) m = pool_select(m);
        // stage 1's operand; zero outside the map (stage 1's padding)
        s_mid[((g * kGroup + k) * kDMid + ly) * kDMidPitch + lx] =
            inside ? bf16_round(m) : 0.0f;
      }
    }

    // stage 1: output local (py, px) <-> global (kDTile*ty + py, ...); its
    // conv outputs read intermediate local rows 2*py + dy + u
    const int items1 = kDTile * kDTile * (cout / kGroup);
    for (int base = 0; base < items1; base += kThreads) {
      const int e = base + tid;
      const bool active = e < items1;
      const int pix = e % (kDTile * kDTile), g = e / (kDTile * kDTile);
      const int py = pix / kDTile, px = pix % kDTile;
      float acc[4][kGroup] = {};
      for (int c0 = 0; c0 < cmid; c0 += kDCk) {
        const int cn = min(kDCk, cmid - c0);
        __syncthreads();    // s_mid is written, the previous chunk consumed
        const float* wsrc = w1 + static_cast<size_t>(c0) * 9 * cout;
        for (int i = tid; i < cn * 9 * cout; i += kThreads)
          s_w1[i] = bf16_round(wsrc[i]);
        __syncthreads();
        if (!active) continue;
        for (int c = 0; c < cn; ++c) {
          float patch[4][4];
          for (int r = 0; r < 4; ++r)
            for (int q = 0; q < 4; ++q)
              patch[r][q] = s_mid[((c0 + c) * kDMid + 2 * py + r) * kDMidPitch
                                  + 2 * px + q];
          for (int u = 0; u < 3; ++u)
            for (int v = 0; v < 3; ++v) {
              const float4* wr = reinterpret_cast<const float4*>(
                  s_w1 + (c * 9 + u * 3 + v) * cout + g * kGroup);
              const float4 wa = wr[0], wb = wr[1];
              const float wv[kGroup] = {wa.x, wa.y, wa.z, wa.w,
                                        wb.x, wb.y, wb.z, wb.w};
              for (int d = 0; d < 4; ++d) {
                const float mv = patch[(d >> 1) + u][(d & 1) + v];
                for (int k = 0; k < kGroup; ++k)
                  acc[d][k] = fmaf(mv, wv[k], acc[d][k]);
              }
            }
        }
      }
      const int oy = kDTile * ty + py, ox = kDTile * tx + px;
      if (!active || oy >= ho || ox >= wo) continue;
      const size_t o = ((static_cast<size_t>(n) * ho + oy) * wo + ox) * cout
                       + g * kGroup;
      for (int k = 0; k < kGroup; ++k) {
        const float bias = b1[g * kGroup + k];
        float m = leaky(__fadd_rn(acc[0][k], bias));
        for (int d = 1; d < 4; ++d)
          m = fmaxf(m, leaky(__fadd_rn(acc[d][k], bias)));
        store_value(out, o + k, select ? pool_select(m) : m, store);
      }
    }
  }
}

// ---------------------------------------------------------------------
// Kernel K9: one fused stem stage,
//   out = maxpool2(leaky(conv3x3(x, w) + b))
// for NHWC float32 x [N, H, W, Cin] -> NHWC [N, H/2, W/2, Cout] stored as
// float32, bf16 or float16; zero padding 1, leaky slope 0.1.
//
// Replaces: millieye_tpu/ops/stem_pallas.py:fused_stem_planar (variants
// "batched" and "rowdot" compute the same function). Its numerics:
// precision="default" rounds x and w to bf16 and accumulates the products
// in float32; "highest" is float32 throughout. Bias, leaky and the 2x2
// max follow in float32, then one rounding to the store type.
//
// Bound on an H100: bytes at stages 0 and 2 (416 px: 2.08 MB in, 1.38 MB
// float16 out per image, 1.0 us at 3.35 TB/s, against 0.30 GFLOP), and
// operations from stage 4 on when counted at the float32 rate the CUDA
// cores run (104 px, 32 -> 64: 0.40 GFLOP per image, 6 us at 67 TFLOP/s;
// 0.4 us at the bf16 tensor-core rate "default" allows). At "default"
// the tensor-core kernel above runs it (stem_stage_tc_kernel); the
// kernel below takes "highest"; deep_stage_kernel takes "highest" where
// this one's weights and halo do not fit shared memory, and "default"
// where not even 8 output channels' tensor-core weights do (Cin above
// 256).
//
// At "highest" each product is rounded before its add (__fmul_rn, then
// __fadd_rn: two issue slots a product), summed over (c, u, v), c
// slowest, as ops/stem.py:fused_stem_stage_plain sums, so the kernel is
// bit-equal to it. That caps it at half the FMA rate: 132 SMs x 128
// lanes x 1.755-1.98 GHz give 0.143-0.161 ms at b32 for stage 0 (416 px,
// 3 -> 16: 74.8 M products an image) and 0.381-0.430 ms for stage 2
// (208 px, 16 -> 32: 199 M). The design keeps loads and idle threads off
// that path (stem_pair_kernel's design, fitted to one stage):
//  - a persistent grid of 256-thread blocks walks tiles of tr x tc pooled
//    pixels (below) with a stride of the grid; the whole weight set
//    [cin, 3, 3, cout] and the biases arrive once a block, the weights by
//    16-byte cp.async;
//  - the tile's (2tr+2 x 2tc+2) x Cin input halo lands planar ([c][row]
//    [col], zero outside the frame: the conv's padding) by 4-byte
//    cp.async, into a second buffer while the previous tile computes
//    where two fit shared memory (both P3 stages: 56 KB at stage 0, 60 KB
//    at stage 2), else into one;
//  - each thread owns 4 output channels of 2 horizontally adjacent pooled
//    pixels at all four pool positions (32 sums), lanes over the
//    4-channel groups fastest, and per input channel loads the pair's 4x6
//    patch once (12 float2) and 9 float4 weights for 288 products
//    (conv_chan_cuv, shared with deep_stage_kernel);
//  - the tile grows from 8 x 8 pooled pixels, columns first, until its
//    (pixel pair, channel group) items cover the 256 threads four times
//    where Cin < 8 and once elsewhere, as long as the batch keeps
//    kSMinTilesPerSm tiles an SM (stage 0: 16 x 32 at b32, four items a
//    thread, and 8 x 16 at b1; stage 2: 8 x 8), so that no thread idles
//    (the first K9 kernel left half of them idle at Cout = 16) and a thin
//    input's tile has work enough between its two barriers. Timed on an
//    H100: stage 0 at b32 took 0.30 ms at 16 x 16 and 0.28 at 16 x 32,
//    though 208 pooled columns leave the last 16 x 32 tile half empty; at
//    b1 its device time was 0.0139 ms at 16 x 32 (91 tiles for 132 SMs),
//    0.0151 at 16 x 16, 0.0123 at 8 x 16 and 0.0129 at 8 x 8;
//  - three blocks an SM (80 registers, 8 bytes of spill; 112 registers
//    and two blocks without the bound: 2-3% slower at stage 0);
//  - each pixel's 4 channels go out as one 16-byte (float32) or 8-byte
//    store.
constexpr int kSMaxPixels = 1024;      // pooled pixels per tile, at most
constexpr int kSMinTilesPerSm = 2;     // tiles an SM the tile leaves, at least

// K9's tile at "highest": tr rows x tc columns of pooled pixels, for n
// images of ho x wo pooled pixels on a card of sms SMs
__host__ __device__ inline void stage_hi_tile(int cin, int cout, int n,
                                              int ho, int wo, int sms,
                                              int* tr, int* tc) {
  const int want = kThreads * (cin < 8 ? 4 : 1);
  *tr = *tc = kTile;
  while (*tr * *tc / 2 * (cout / 4) < want && *tr * *tc < kSMaxPixels) {
    const int r = *tc <= *tr ? *tr : 2 * *tr, c = *tc <= *tr ? 2 * *tc : *tc;
    if (static_cast<long long>(n) * cdiv(ho, r) * cdiv(wo, c)
        < static_cast<long long>(kSMinTilesPerSm) * sms)
      break;
    *tr = r;
    *tc = c;
  }
}

// bytes of shared memory: the weights, the biases and `bufs` input halos
__host__ __device__ inline size_t stage_hi_smem_bytes(int cin, int cout,
                                                      int tr, int tc,
                                                      int bufs) {
  return sizeof(float)
         * (9 * static_cast<size_t>(cin) * cout + align4(cout)
            + bufs * static_cast<size_t>(align4((2 * tr + 2) * (2 * tc + 2)
                                                * cin)));
}

__global__ void __launch_bounds__(kThreads, 3)
stem_stage_kernel(const float* __restrict__ x,
                  const float* __restrict__ wgt,   // [cin, 3, 3, cout]
                  const float* __restrict__ bias, void* __restrict__ out,
                  int n, int h, int w, int cin, int cout, int tr, int tc,
                  int store, int bufs) {
  extern __shared__ __align__(16) float smem[];
  const int hr = 2 * tr + 2, hc = 2 * tc + 2;       // halo rows, columns
  const int halo = align4(hr * hc * cin);
  float* s_w = smem;                                // [cin][3][3][cout]
  float* s_b = s_w + 9 * cin * cout;
  float* s_in = s_b + align4(cout);                 // [bufs][cin][hr][hc]

  const int tid = threadIdx.x;
  const int ho = h / 2, wo = w / 2;
  const int tiles_x = cdiv(wo, tc), per_img = tiles_x * cdiv(ho, tr);
  const int n_tiles = n * per_img;

  auto load_halo = [&](int tile, float* dst) {
    const int img = tile / per_img, r = tile % per_img;
    load_halo_planar(dst, x, img, h, w, cin, 2 * tr * (r / tiles_x) - 1,
                     2 * tc * (r % tiles_x) - 1, hr, hc);
  };

  // once per block: the weights and the biases
  for (int i = tid; i < 9 * cin * cout / 4; i += kThreads)
    cp_async16(s_w + 4 * i, wgt + 4 * i);
  for (int i = tid; i < cout; i += kThreads) s_b[i] = bias[i];
  int tile = blockIdx.x;
  if (bufs == 2 && tile < n_tiles) load_halo(tile, s_in);
  cp_async_commit();

  const int groups = cout / 4, items = tr * (tc / 2) * groups;
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const float* cur = s_in + (bufs == 2 ? (it & 1) * halo : 0);
    if (bufs == 2) {   // the next tile's halo loads while this one computes
      if (tile + gridDim.x < n_tiles)
        load_halo(tile + gridDim.x, s_in + ((it + 1) & 1) * halo);
      cp_async_commit();
      cp_async_wait1();
    } else {
      load_halo(tile, s_in);
      cp_async_commit();
      cp_async_wait0();
    }
    __syncthreads();
    const int img = tile / per_img, r = tile % per_img;
    const int oy0 = tr * (r / tiles_x), ox0 = tc * (r % tiles_x);
    // item = (pair of pooled pixels, 4-channel group); the pair's conv
    // outputs read halo rows 2 py + dy + u and columns 2 px + dx + v
    for (int e = tid; e < items; e += kThreads) {
      const int g = e % groups, p = e / groups;
      const int py = p / (tc / 2), px = 2 * (p % (tc / 2));
      const int oy = oy0 + py, ox = ox0 + px;
      if (oy >= ho || ox >= wo) continue;
      float acc[2][4][4] = {};
      for (int c = 0; c < cin; ++c)
        conv_chan_cuv<true>(acc, cur + (c * hr + 2 * py) * hc + 2 * px, hc,
                            s_w + c * 9 * cout + 4 * g, cout);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (ox + q >= wo) continue;
        float m[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          m[k] = pool4<false>(acc[q][0][k], acc[q][1][k], acc[q][2][k],
                              acc[q][3][k], s_b[4 * g + k]);
        store4(out, ((static_cast<size_t>(img) * ho + oy) * wo + ox + q)
                        * cout + 4 * g, m, store);
      }
    }
    __syncthreads();            // every buffer is free for the next tile
  }
}

// ---------------------------------------------------------------------
// Kernel K10: K9's function in NHWC with HWIO weights and float32
// products, summed in the tap order of the TPU kernel's patch build,
//   out = maxpool2(leaky(conv3x3(x, w) + b)).
//
// Replaces: millieye_tpu/ops/stem_pallas.py:fused_stem, whose variants
// "vconcat" and "vroll" sum three K = 3*cin dots over v (taps (v, u, c))
// and "im2col" one K = 9*cin dot (taps (u, v, c)), at HIGHEST precision
// with float32 accumulation; its row band th changes nothing in the
// result. The caller passes the HWIO weights [3, 3, cin, cout] as they
// are (the JAX wrapper's [9*cin, cout] matrix in the variant's tap order
// is a reordering of them: the kernels take tap (u, v)'s block where the
// order reaches it, and no copy is made); each product is rounded before
// its add (__fmul_rn, __fadd_rn), tap by tap and, within
// a tap, channel by channel in ascending order, so the plain version
// (ops/stem.py:fused_stem_plain) repeats every sum bit for bit. Any cin,
// any cout.
//
// Bound on an H100: operations (416 px, 3 -> 16: 74.8 M products an
// image; 208 px, 16 -> 32: 199 M), two issue slots a product, so the
// mul-then-add ceiling is K9's at "highest": 0.143-0.161 ms (stage 0)
// and 0.381-0.430 ms (stage 2) at b32 on 132 SMs x 128 lanes at
// 1.755-1.98 GHz.
//
// Two routes, chosen by (cin, cout) alone (nhwc_resident; the wrapper's
// ops/stem.py:nhwc_route mirrors it):
//
// stem_nhwc_kernel, where the whole weight set and one input halo of an
// 8 x 8 tile of pooled pixels fit shared memory (the stem's stages; cin
// 93 at cout 12; not cin 128 at cout 12): K9's persistent design
// (stem_stage_kernel) in K10's order. A persistent grid walks tiles of
// tr x tc pooled pixels (nhwc_tile: K9's rule, the tile also held to
// shared memory); the weights [3][3][cin][cout4] (cout4 = cout rounded up to
// 4, zero columns past cout) and the biases arrive once a block, by
// 16-byte cp.async where cout % 4 == 0; the next tile's planar halo (row
// pitch rounded up to 4 floats) loads by cp.async into a second buffer
// while this one computes, where two fit. A thread owns kG output
// channels of 2 horizontally adjacent pooled pixels at the four pool
// positions (8 kG sums); lanes run the channel groups fastest, so a
// weight load is a float4 read side by side by neighbouring lanes. kG is
// 8 where 8 divides cout and cin > 4 (stage 2), with 128 threads a block
// so that an 8 x 8 tile fills it at 32 outputs, else 4 with 256 threads.
// Per (tap, channel) a thread reads the 2 x 4 window its 8 kG products
// need (tap_chan: a float4 a row at v = 0, two at v = 1, two float2 at
// v = 2; the pitch and 2 px are multiples of 4) and kG / 4 float4 of
// weights. For cin <= 4 (stage 0) every channel's 4 x 6 patch is read
// once into registers (12 float2 a channel, as K9 reads it) and the nine
// taps run from there: the tap order constrains the sums, not the loads.
// A ragged last channel group is masked at the store (its weights are
// zero), and each pixel's channels go out as 16- or 8-byte stores where
// cout allows. At stage 2 (b32, 104 x 104 pooled pixels) 8 channels a
// thread on 256-thread blocks took 8 x 16 tiles, whose last column of
// tiles is half empty, and gained nothing on 4; 128-thread blocks on
// 8 x 8 tiles, then the float4 windows, each took a few percent off.
//
// stem_nhwc_wide_kernel, the rest (e.g. block 8, 26 px, 128 -> 256; cin
// 1024): a persistent grid of 256-thread blocks walks items of (8 x 8
// pooled pixels, 8 groups of kG output channels); each item's sum runs
// in steps of (tap, chunk of kWCk input channels), in the order of the
// sum, each step's weight chunk [kWCk][8 kG] (tap (u, v)'s rows of the
// HWIO weights) arriving by cp.async while the step before computes.
// Where the tile's halo of every input channel fits shared memory (cin up
// to ~155) it is loaded once an item and stays for the nine taps; else
// each step also loads its chunk of the halo (a second copy of both
// loads while the step before computes), so each tap walks cin through
// the halo in chunks. The halo's rows have a pitch of 20 floats, so the
// windows are read as in stem_nhwc_kernel. kG is 8 where 8 divides cout,
// cout > 32 and the items at 64 channels still fill the card (block 8 at
// b32: 1.45 -> 1.09 ms on an H100, chip_smoke.py), else 4 (block 8 at
// b1: its 32 items at 4 channels are too few for 132 SMs already).
// Threads whose channel group lies past cout sit out the sums but not
// the barriers.
constexpr int kNRegC = 4;        // cin up to which the patch sits in registers
constexpr int kNGroup = 8;       // channels a thread where they divide cout
constexpr int kWCk = 16;         // wide route: input channels a step
constexpr int kWHalo = 2 * kTile + 2;   // 18: its halo, a side,
constexpr int kWPitch = (kWHalo + 3) & ~3;   // at a row pitch of 20
constexpr int kWPlane = kWHalo * kWPitch;

// How a 2 x 4 window of a planar halo row is read (tap_chan), on a row
// pitch a multiple of 4 floats with 2 px a multiple of 4: kQuad0 one
// float4 (v = 0: xs 16-byte aligned), kQuad1 two float4 around it
// (v = 1), kPairs two float2 (v = 2: xs 8-byte aligned).
enum WindowLoad { kQuad0, kQuad1, kPairs };

// One (tap, channel) term of the sums of two horizontally adjacent pooled
// pixels x kG output channels at the four pool positions (acc[q][d][k]:
// pixel q, pool position d = 2 dy + dx, channel k): the 2 x 4 window at
// xs (row pitch `pitch`; xs = plane + (2 py + u) * pitch + 2 px + v)
// times the kG weights at ws (16-byte aligned), each product rounded
// before its add.
template <int kLoad, int kG>
__device__ __forceinline__ void tap_chan(float (&acc)[2][4][kG],
                                         const float* xs, int pitch,
                                         const float* ws) {
  float win[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* p = xs + r * pitch;
    if (kLoad == kQuad0) {
      const float4 a = *reinterpret_cast<const float4*>(p);
      win[r][0] = a.x; win[r][1] = a.y; win[r][2] = a.z; win[r][3] = a.w;
    } else if (kLoad == kQuad1) {
      const float4 a = *reinterpret_cast<const float4*>(p - 1);
      const float4 b = *reinterpret_cast<const float4*>(p + 3);
      win[r][0] = a.y; win[r][1] = a.z; win[r][2] = a.w; win[r][3] = b.x;
    } else {
      const float2 a = *reinterpret_cast<const float2*>(p);
      const float2 b = *reinterpret_cast<const float2*>(p + 2);
      win[r][0] = a.x; win[r][1] = a.y; win[r][2] = b.x; win[r][3] = b.y;
    }
  }
  float wk[kG];
#pragma unroll
  for (int j = 0; j < kG / 4; ++j) {
    const float4 wv = *reinterpret_cast<const float4*>(ws + 4 * j);
    wk[4 * j] = wv.x; wk[4 * j + 1] = wv.y;
    wk[4 * j + 2] = wv.z; wk[4 * j + 3] = wv.w;
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const float xv = win[d >> 1][2 * q + (d & 1)];
#pragma unroll
      for (int k = 0; k < kG; ++k)
        acc[q][d][k] = __fadd_rn(acc[q][d][k], __fmul_rn(xv, wk[k]));
    }
}

// tap t of the variant's order -> (u, v)
template <bool kVMajor>
__host__ __device__ constexpr int tap_u(int t) {
  return kVMajor ? t % 3 : t / 3;
}
template <bool kVMajor>
__host__ __device__ constexpr int tap_v(int t) {
  return kVMajor ? t / 3 : t % 3;
}

// +bias, leaky and the 2x2 max of a pair's kG channels (co0 on), then
// the store: 16-byte (or 8-byte) stores of 8 (or 4) channels where cout
// allows, else a value at a time up to cout
template <int kG>
__device__ __forceinline__ void nhwc_epilogue(const float (&acc)[2][4][kG],
                                              const float* bias, void* out,
                                              size_t o0, int co0, int cout,
                                              int wo, int ox, int store) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (ox + q >= wo) continue;
    float m[kG];
#pragma unroll
    for (int k = 0; k < kG; ++k)
      m[k] = pool4<false>(acc[q][0][k], acc[q][1][k], acc[q][2][k],
                          acc[q][3][k], bias[k]);
    const size_t o = o0 + static_cast<size_t>(q) * cout;
    if (kG == 8 && (cout & 7) == 0) {
      store8(out, o, m, store);
    } else if ((cout & 3) == 0) {
#pragma unroll
      for (int j = 0; j < kG / 4; ++j)
        if (co0 + 4 * j < cout) store4(out, o + 4 * j, m + 4 * j, store);
    } else {
#pragma unroll
      for (int k = 0; k < kG; ++k)
        if (co0 + k < cout) store_value(out, o + k, m[k], store);
    }
  }
}

// K10's weights [3, 3, cin, cout] into shared memory as [9 * cin][cout4],
// zero past cout: 16-byte cp.async where every row is 16-byte aligned,
// else one value at a time (seen by the first barrier after it)
__device__ __forceinline__ void load_nhwc_weights(float* s_w,
                                                  const float* __restrict__ wm,
                                                  int rows, int cout) {
  const int cout4 = align4(cout);
  if ((cout & 3) == 0 && reinterpret_cast<uintptr_t>(wm) % 16 == 0) {
    for (int i = threadIdx.x; i < rows * cout / 4; i += blockDim.x)
      cp_async16(s_w + 4 * i, wm + 4 * i);
    return;
  }
  for (int i = threadIdx.x; i < rows * cout4; i += blockDim.x) {
    const int r = i / cout4, co = i % cout4;
    s_w[i] = co < cout ? wm[static_cast<size_t>(r) * cout + co] : 0.0f;
  }
}

// bytes of shared memory of stem_nhwc_kernel: the weights, the biases and
// `bufs` input halos of tr x tc pooled pixels
__host__ __device__ inline size_t nhwc_smem_bytes(int cin, int cout, int tr,
                                                  int tc, int bufs) {
  return sizeof(float)
         * (9 * static_cast<size_t>(cin) * align4(cout) + align4(cout)
            + bufs * static_cast<size_t>(align4((2 * tr + 2)
                                                * align4(2 * tc + 2) * cin)));
}

// the route: stem_nhwc_kernel where its weights and one halo of the
// smallest tile fit shared memory, else stem_nhwc_wide_kernel
__host__ __device__ inline bool nhwc_resident(int cin, int cout) {
  return nhwc_smem_bytes(cin, cout, kTile, kTile, 1) <= kMaxSmem;
}

// the channels a thread of stem_nhwc_kernel sums: 8 where they divide
// cout and the patch is not in registers, else 4
__host__ __device__ inline int nhwc_group(int cin, int cout) {
  return cin > kNRegC && cout % kNGroup == 0 ? kNGroup : 4;
}

// its threads a block: 256 at 4 channels a thread, 128 at 8, so that an
// 8 x 8 tile's items fill the block at 32 output channels
__host__ __device__ constexpr int nhwc_threads(int group) {
  return kThreads * 4 / group;
}

// stem_nhwc_kernel's tile: stage_hi_tile's rule over its channel groups,
// growing only while one halo still fits beside the weights
__host__ __device__ inline void nhwc_tile(int cin, int cout, int n, int ho,
                                          int wo, int sms, int* tr,
                                          int* tc) {
  const int group = nhwc_group(cin, cout);
  const int want = nhwc_threads(group) * (cin < 8 ? 4 : 1);
  const int groups = align4(cout) / group;
  *tr = *tc = kTile;
  while (*tr * *tc / 2 * groups < want && *tr * *tc < kSMaxPixels) {
    const int r = *tc <= *tr ? *tr : 2 * *tr, c = *tc <= *tr ? 2 * *tc : *tc;
    if (static_cast<long long>(n) * cdiv(ho, r) * cdiv(wo, c)
            < static_cast<long long>(kSMinTilesPerSm) * sms
        || nhwc_smem_bytes(cin, cout, r, c, 1) > kMaxSmem)
      break;
    *tr = r;
    *tc = c;
  }
}

// kC > 0: cin == kC, each channel's 4 x 6 patch in registers; kG output
// channels a thread
template <bool kVMajor, int kC, int kG>
__global__ void __launch_bounds__(nhwc_threads(kG),
                                  kC > 0 ? 2 : kG > 4 ? 4 : 3)
stem_nhwc_kernel(const float* __restrict__ x,
                 const float* __restrict__ wm,   // [3, 3, cin, cout]
                 const float* __restrict__ bias, void* __restrict__ out,
                 int n, int h, int w, int cin, int cout, int tr, int tc,
                 int store, int bufs) {
  extern __shared__ __align__(16) float smem[];
  const int cout4 = align4(cout);
  const int hr = 2 * tr + 2, hc = align4(2 * tc + 2), plane = hr * hc;
  const int halo = align4(plane * cin);
  float* s_w = smem;                                // [3][3][cin][cout4]
  float* s_b = s_w + 9 * cin * cout4;               // [cout4]
  float* s_in = s_b + cout4;                        // [bufs][cin][hr][hc]

  const int tid = threadIdx.x;
  const int ho = h / 2, wo = w / 2;
  const int tiles_x = cdiv(wo, tc), per_img = tiles_x * cdiv(ho, tr);
  const int n_tiles = n * per_img;

  auto load_halo = [&](int tile, float* dst) {
    const int img = tile / per_img, r = tile % per_img;
    load_halo_planar(dst, x, img, h, w, cin, 2 * tr * (r / tiles_x) - 1,
                     2 * tc * (r % tiles_x) - 1, hr, 2 * tc + 2, hc);
  };

  // once per block: the weights and the biases
  load_nhwc_weights(s_w, wm, 9 * cin, cout);
  constexpr int threads = nhwc_threads(kG);
  for (int i = tid; i < cout4; i += threads)
    s_b[i] = i < cout ? bias[i] : 0.0f;
  int tile = blockIdx.x;
  if (bufs == 2 && tile < n_tiles) load_halo(tile, s_in);
  cp_async_commit();

  static_assert(kC == 0 || kG == 4, "a register patch takes 4 channels");
  const int groups = cout4 / kG, items = tr * (tc / 2) * groups;
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const float* cur = s_in + (bufs == 2 ? (it & 1) * halo : 0);
    if (bufs == 2) {   // the next tile's halo loads while this one computes
      if (tile + gridDim.x < n_tiles)
        load_halo(tile + gridDim.x, s_in + ((it + 1) & 1) * halo);
      cp_async_commit();
      cp_async_wait1();
    } else {
      load_halo(tile, s_in);
      cp_async_commit();
      cp_async_wait0();
    }
    __syncthreads();
    const int img = tile / per_img, r = tile % per_img;
    const int oy0 = tr * (r / tiles_x), ox0 = tc * (r % tiles_x);
    // item = (pair of pooled pixels, kG-channel group); the pair's conv
    // outputs read halo rows 2 py + dy + u and columns 2 px + dx + v
    for (int e = tid; e < items; e += threads) {
      const int g = e % groups, p = e / groups;
      const int py = p / (tc / 2), px = 2 * (p % (tc / 2));
      const int oy = oy0 + py, ox = ox0 + px;
      if (oy >= ho || ox >= wo) continue;
      const float* xs = cur + 2 * py * hc + 2 * px;
      const float* ws = s_w + kG * g;
      float acc[2][4][kG] = {};
      if constexpr (kC > 0) {
        float patch[kC][4][6];
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int t = 0; t < 3; ++t) {
              const float2 a = *reinterpret_cast<const float2*>(
                  xs + c * plane + rr * hc + 2 * t);
              patch[c][rr][2 * t] = a.x;
              patch[c][rr][2 * t + 1] = a.y;
            }
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int u = tap_u<kVMajor>(t), v = tap_v<kVMajor>(t);
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const float4 wv = *reinterpret_cast<const float4*>(
                ws + ((3 * u + v) * kC + c) * cout4);
            const float wk[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
              for (int d = 0; d < 4; ++d) {
                const float xv = patch[c][(d >> 1) + u][2 * q + (d & 1) + v];
#pragma unroll
                for (int k = 0; k < 4; ++k)
                  acc[q][d][k] =
                      __fadd_rn(acc[q][d][k], __fmul_rn(xv, wk[k]));
              }
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int u = tap_u<kVMajor>(t), v = tap_v<kVMajor>(t);
          const float* xt = xs + u * hc + v;
          const float* wt = ws + (3 * u + v) * cin * cout4;
          for (int c = 0; c < cin; ++c) {
            if (v == 0)
              tap_chan<kQuad0, kG>(acc, xt + c * plane, hc, wt + c * cout4);
            else if (v == 1)
              tap_chan<kQuad1, kG>(acc, xt + c * plane, hc, wt + c * cout4);
            else
              tap_chan<kPairs, kG>(acc, xt + c * plane, hc, wt + c * cout4);
          }
        }
      }
      nhwc_epilogue<kG>(acc, s_b + kG * g, out,
                        ((static_cast<size_t>(img) * ho + oy) * wo + ox)
                                * cout + kG * g,
                        kG * g, cout, wo, ox, store);
    }
    __syncthreads();            // every buffer is free for the next tile
  }
}

// 16-byte asynchronous copy into shared memory; zero fill where !valid
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// the wide kernel's channels a thread (an item takes 8 such groups): 8
// where they divide cout, cout > 32 and the items still number
// kSMinTilesPerSm an SM, else 4 (items: n images of ho x wo pooled
// pixels in 8 x 8 tiles, times the slices)
__host__ __device__ inline int nhwc_wide_group(int n, int ho, int wo,
                                               int cout, int sms) {
  const long long items = static_cast<long long>(n) * cdiv(ho, kTile)
                          * cdiv(wo, kTile) * cdiv(cout, 64);
  return cout % 8 == 0 && cout > 32
                 && items >= static_cast<long long>(kSMinTilesPerSm) * sms
             ? 8 : 4;
}

// whether the wide kernel keeps every input channel of its tile's halo
__host__ __device__ inline bool nhwc_wide_halo_resident(int cin, int group) {
  return sizeof(float) * (static_cast<size_t>(kWPlane) * cin
                          + 2 * kWCk * 8 * group) <= kMaxSmem;
}

__host__ __device__ inline size_t nhwc_wide_smem_bytes(int cin, int group) {
  return nhwc_wide_halo_resident(cin, group)
      ? sizeof(float) * (static_cast<size_t>(kWPlane) * cin
                         + 2 * kWCk * 8 * group)
      : sizeof(float) * 2 * kWCk * (kWPlane + 8 * group);
}

template <bool kVMajor, int kG>
__global__ void __launch_bounds__(kThreads, 2)
stem_nhwc_wide_kernel(const float* __restrict__ x,
                      const float* __restrict__ wm,   // [3, 3, cin, cout]
                      const float* __restrict__ bias, void* __restrict__ out,
                      int n, int h, int w, int cin, int cout, int store,
                      int resident) {
  extern __shared__ __align__(16) float smem[];
  constexpr int plane = kWPlane, kWCo = 8 * kG;
  // the halo: [cin][18][20] (resident) or [2][kWCk][18][20]; then the
  // weight chunks [2][kWCk][kWCo]
  float* s_in = smem;
  float* s_w = s_in + (resident ? cin * plane : 2 * kWCk * plane);

  const int tid = threadIdx.x;
  const int ho = h / 2, wo = w / 2;
  const int tiles_x = cdiv(wo, kTile), per_img = tiles_x * cdiv(ho, kTile);
  const int slices = cdiv(cout, kWCo);
  const long long n_items = static_cast<long long>(n) * per_img * slices;
  const int nck = cdiv(cin, kWCk), steps = 9 * nck;
  const bool vec =
      (cout & 3) == 0 && reinterpret_cast<uintptr_t>(wm) % 16 == 0;
  // this thread's (pair, channel group): the slice's 8 groups fastest
  const int g = tid % 8, p = tid / 8;
  const int py = p / (kTile / 2), px = 2 * (p % (kTile / 2));

  // the loads of step s of item `item`: the halo (all of it at a resident
  // item's step 0, else the step's chunk) and the step's weights
  auto issue = [&](long long item, int s, int buf) {
    const int slice = static_cast<int>(item % slices);
    const int tile = static_cast<int>(item / slices);
    const int img = tile / per_img, r = tile % per_img;
    const int iy0 = 2 * kTile * (r / tiles_x) - 1;
    const int ix0 = 2 * kTile * (r % tiles_x) - 1;
    const int t = s / nck, c0 = (s % nck) * kWCk;
    const int cn = min(kWCk, cin - c0);
    if (!resident || s == 0) {
      const int hc0 = resident ? 0 : c0, hcn = resident ? cin : cn;
      float* dst = s_in + (resident ? 0 : buf * kWCk * plane);
      const float* xi = x + static_cast<size_t>(img) * h * w * cin + hc0;
      for (int e = tid; e < kWHalo * kWHalo * hcn; e += kThreads) {
        const int c = e % hcn, pix = e / hcn;
        const int row = pix / kWHalo, col = pix % kWHalo;
        const int gy = iy0 + row, gx = ix0 + col;
        const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < w;
        cp_async4(dst + c * plane + row * kWPitch + col,
                  ok ? xi + (static_cast<size_t>(gy) * w + gx) * cin + c : x,
                  ok);
      }
    }
    float* dw = s_w + buf * kWCk * kWCo;
    const int co0 = slice * kWCo;
    const float* src = wm
        + (static_cast<size_t>(3 * tap_u<kVMajor>(t) + tap_v<kVMajor>(t))
               * cin + c0) * cout;
    for (int e = tid; e < cn * (kWCo / 4); e += kThreads) {
      const int c = e / (kWCo / 4), q = e % (kWCo / 4), co = co0 + 4 * q;
      if (vec) {
        const bool ok = co < cout;
        cp_async16z(dw + c * kWCo + 4 * q,
                    ok ? src + static_cast<size_t>(c) * cout + co : wm, ok);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool ok = co + k < cout;
          cp_async4(dw + c * kWCo + 4 * q + k,
                    ok ? src + static_cast<size_t>(c) * cout + co + k : wm,
                    ok);
        }
      }
    }
  };

  long long item = blockIdx.x;
  if (item < n_items) issue(item, 0, 0);
  cp_async_commit();
  int it = 0;                          // steps so far: the buffers' parity
  for (; item < n_items; item += gridDim.x) {
    const int slice = static_cast<int>(item % slices);
    const int tile = static_cast<int>(item / slices);
    const int img = tile / per_img, r = tile % per_img;
    const int oy = kTile * (r / tiles_x) + py, ox = kTile * (r % tiles_x) + px;
    const int co0 = slice * kWCo + kG * g;
    const bool active = co0 < cout;
    float acc[2][4][kG] = {};
    for (int s = 0; s < steps; ++s, ++it) {
      // a resident halo is loaded at an item's first step, once the item
      // before is done with it (the first item's in the prologue)
      if (resident && s == 0 && item != blockIdx.x) {
        issue(item, 0, it & 1);
        cp_async_commit();
      }
      const bool last = s + 1 == steps;
      const long long next = last ? item + gridDim.x : item;
      if (next < n_items && !(resident && last))
        issue(next, last ? 0 : s + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();
      const int t = s / nck, c0 = (s % nck) * kWCk;
      const int cn = min(kWCk, cin - c0);
      if (active) {
        const int u = tap_u<kVMajor>(t), v = tap_v<kVMajor>(t);
        const float* xs = s_in
            + (resident ? c0 * plane : (it & 1) * kWCk * plane)
            + (2 * py + u) * kWPitch + 2 * px + v;
        const float* ws = s_w + (it & 1) * kWCk * kWCo + kG * g;
        if (v == 0) {
          for (int c = 0; c < cn; ++c)
            tap_chan<kQuad0, kG>(acc, xs + c * plane, kWPitch,
                                 ws + c * kWCo);
        } else if (v == 1) {
          for (int c = 0; c < cn; ++c)
            tap_chan<kQuad1, kG>(acc, xs + c * plane, kWPitch,
                                 ws + c * kWCo);
        } else {
          for (int c = 0; c < cn; ++c)
            tap_chan<kPairs, kG>(acc, xs + c * plane, kWPitch,
                                 ws + c * kWCo);
        }
      }
      __syncthreads();               // both buffers free for the next loads
    }
    if (!active || oy >= ho || ox >= wo) continue;
    float bk[kG];
#pragma unroll
    for (int k = 0; k < kG; ++k) bk[k] = co0 + k < cout ? bias[co0 + k] : 0.0f;
    nhwc_epilogue<kG>(acc, bk, out,
                      ((static_cast<size_t>(img) * ho + oy) * wo + ox)
                              * cout + co0,
                      co0, cout, wo, ox, store);
  }
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st,
           Args... args) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// A persistent grid for `kernel` at `smem` bytes: as many blocks as fit on
// the card at once (a multiple of `multiple`), at most `items`; each
// block walks the items with a stride of the grid. The attribute and
// occupancy calls cost microseconds of host time, which a call at batch 1
// feels, so each host thread keeps the last answer for its kernel, device
// and shared memory.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, long long items,
                            int multiple, int* grid,
                            int threads = kThreads) {
  thread_local Kernel c_kernel = nullptr;
  thread_local int c_dev = -1, c_threads = 0, c_blocks = 0;
  thread_local size_t c_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (kernel != c_kernel || dev != c_dev || smem != c_smem
      || threads != c_threads) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    c_kernel = kernel;
    c_dev = dev;
    c_smem = smem;
    c_threads = threads;
    c_blocks = per_sm * sms;
  }
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  long long cap = c_blocks;
  cap = cap < multiple ? multiple : cap - cap % multiple;
  *grid = static_cast<int>(items < cap ? items : cap);
  return cudaSuccess;
}

bool bad_pair_shape(int n, int h, int w, int cin, int cmid, int cout,
                    int store) {
  return n <= 0 || h <= 0 || w <= 0 || h % 4 || w % 4 || cin <= 0
         || cmid <= 0 || cout <= 0 || cmid % kGroup || cout % kGroup
         || store < 0 || store > 2;
}

}  // namespace

extern "C" {

const char* millieye_cuda_error_name(int code) {
  return cudaGetErrorName(static_cast<cudaError_t>(code));
}

// x [n, h, w, cin] f32, b0 [cmid] f32, b1 [cout] f32, w0 and w1 f32:
// OIHW ([cmid, cin, 3, 3], [cout, cmid, 3, 3]) at highest == 0, read once
// per block; [cin, 3, 3, cmid] and [cmid, 3, 3, cout] at highest, copied
// as they are -> out [n, h/4, w/4, cout] in the store type (0 float32,
// 1 bf16, 2 float16). highest: float32
// products on the CUDA cores, else bf16 operands (rounded in the kernel)
// on the tensor cores; select: K8's hi/lo pool (only with highest == 0).
int millieye_stem_pair(const void* x, const void* w0, const void* b0,
                       const void* w1, const void* b1, void* out, int n,
                       int h, int w, int cin, int cmid, int cout,
                       int highest, int select, int store, void* stream) {
  if (bad_pair_shape(n, h, w, cin, cmid, cout, store) || (highest && select))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = static_cast<long long>(n)
      * cdiv(w / 4, kTile) * cdiv(h / 4, kTile);
  int grid = 0;
  if (highest) {
    // two halo buffers where they fit, else one
    const int bufs = pair_smem_bytes(cin, cmid, cout, 2) <= kMaxSmem ? 2 : 1;
    const size_t smem = pair_smem_bytes(cin, cmid, cout, bufs);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    const cudaError_t err = persistent_grid(stem_pair_kernel, smem, tiles, 1,
                                            &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    stem_pair_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w0),
        static_cast<const float*>(b0), static_cast<const float*>(w1),
        static_cast<const float*>(b1), out, n, h, w, cin, cmid, cout, store,
        bufs);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = pair_tc_smem_bytes(cin, cmid, cout);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = select ? stem_pair_tc_kernel<true> : stem_pair_tc_kernel<false>;
  const cudaError_t err = persistent_grid(kernel, smem, tiles, 1, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w0),
      static_cast<const float*>(b0), static_cast<const float*>(w1),
      static_cast<const float*>(b1), out, n, h, w, cin, cmid, cout, store);
  return static_cast<int>(cudaGetLastError());
}

// The deep pair: x [n, h, w, cin] f32, w0 [cin, 3, 3, cmid] f32, b0,
// w1 [cmid, 3, 3, cout] f32, b1 -> out [n, h/4, w/4, cout] in the store
// type; select: K8's hi/lo pool (only with highest == 0). At "highest"
// two launches of deep_stage_kernel through the float32 intermediate
// [n, h/2, w/2, cmid] in `scratch`. At "default" the tensor-core kernel,
// where its tile fits shared memory, with both weight sets in fragment
// order in `scratch` (written here by a first launch); else the CUDA-core
// kernel, which rounds the weights to bf16 itself and leaves `scratch`
// alone. millieye_stem_pair_deep_scratch_bytes gives the bytes of
// `scratch` a call with the same arguments needs.
size_t millieye_stem_pair_deep_scratch_bytes(int n, int h, int w, int cin,
                                             int cmid, int cout,
                                             int highest) {
  if (highest)
    return sizeof(float) * static_cast<size_t>(n) * (h / 2) * (w / 2) * cmid;
  return frag_bytes(cin, cmid) + frag_bytes(cmid, cout);
}

int millieye_stem_pair_deep(const void* x, const void* w0, const void* b0,
                            const void* w1, const void* b1, void* out,
                            void* scratch, int n, int h, int w, int cin,
                            int cmid, int cout, int highest, int select,
                            int store, void* stream) {
  if (bad_pair_shape(n, h, w, cin, cmid, cout, store) || (highest && select))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x),
              *b0f = static_cast<const float*>(b0),
              *b1f = static_cast<const float*>(b1);
  if (highest) {
    float* mid = static_cast<float*>(scratch);
    const int rc = launch_deep_stage(xf, static_cast<const float*>(w0), b0f,
                                     mid, n, h, w, cin, cmid, 1, kStoreF32,
                                     st);
    if (rc != 0) return rc;
    return launch_deep_stage(mid, static_cast<const float*>(w1), b1f, out, n,
                             h / 2, w / 2, cmid, cout, 1, store, st);
  }
  const size_t tc_smem = deep_tc_smem_bytes(cin, cmid, cout);
  if (tc_smem <= kMaxSmem) {
    uint2* wf0 = static_cast<uint2*>(scratch);
    uint2* wf1 = reinterpret_cast<uint2*>(
        static_cast<unsigned char*>(scratch) + frag_bytes(cin, cmid));
    int rc = launch_frag_weights(w0, wf0, cin, cmid, st);
    if (rc == 0) rc = launch_frag_weights(w1, wf1, cmid, cout, st);
    if (rc != 0) return rc;
    auto kernel = select ? stem_pair_deep_tc_kernel<true>
                         : stem_pair_deep_tc_kernel<false>;
    const long long tiles = static_cast<long long>(n)
        * cdiv(w / 4, kTile) * cdiv(h / 4, kTile);
    int grid = 0;
    const cudaError_t err = persistent_grid(kernel, tc_smem, tiles, 1, &grid,
                                            kDeepThreads);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kDeepThreads, tc_smem, st>>>(xf, wf0, b0f, wf1, b1f, out,
                                               n, h, w, cin, cmid, cout,
                                               store);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * deep_smem_floats(cmid, cout);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // one block a tile up to the largest 1-D grid, then a stride of the grid
  const long long tiles = static_cast<long long>(n) * cdiv(w / 4, kDTile)
                          * cdiv(h / 4, kDTile);
  const dim3 grid(static_cast<unsigned>(
      tiles < 0x7fffffffLL ? tiles : 0x7fffffffLL));
  return launch(stem_pair_deep_kernel, grid, smem, st, xf,
                static_cast<const float*>(w0), b0f,
                static_cast<const float*>(w1), b1f, out, n, h, w, cin, cmid,
                cout, store, select);
}

// x [n, h, w, cin] f32, wgt [cin, 3, 3, cout] f32 (rounded to bf16 in
// the kernel when highest == 0), bias [cout] f32 -> out [n, h/2, w/2, cout] in the
// store type (0 float32, 1 bf16, 2 float16). Kernel K9. At "default" the
// tensor-core kernel with the weights in fragment order in `scratch`
// (millieye_stem_stage_scratch_bytes; written here by a first launch),
// each block on a slice of output channels: the widest of cout, 64, 32,
// 16 and 8 that lets two blocks share an SM, else the widest that fits
// one (timed on an H100 at stage 6, 64 -> 128: slices of 32 and 128
// about even at batch 32, 32 the faster at batch 1). At "highest" the
// persistent CUDA-core kernel where its weights and halo fit shared
// memory; there and where not even 8 channels of tensor-core weights fit,
// deep_stage_kernel. Neither touches `scratch`.
size_t millieye_stem_stage_scratch_bytes(int cin, int cout) {
  return frag_bytes(cin, cout);
}

int millieye_stem_stage(const void* x, const void* wgt, const void* bias,
                        void* out, void* scratch, int n, int h, int w,
                        int cin, int cout, int highest, int store,
                        void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || h % 2 || w % 2 || cin <= 0 || cout <= 0
      || cout % kGroup || store < 0 || store > 2)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x),
              *bf = static_cast<const float*>(bias);
  int slice = 0;
  if (!highest) {
    // two blocks an SM: 228 KB less 1 KB reserved for each block
    const size_t two = (233472 - 2 * 1024) / 2;
    const int cands[] = {cout, 64, 32, 16, 8};
    const size_t caps[] = {two, kMaxSmem};
    for (size_t cap : caps) {
      for (int c : cands)
        if (c <= cout && stage_tc_smem_bytes(cin, c) <= cap) {
          slice = c;
          break;
        }
      if (slice) break;
    }
  }
  if (!highest && slice > 0) {
    const size_t smem = stage_tc_smem_bytes(cin, slice);
    const int rc = launch_frag_weights(wgt, scratch, cin, cout, st);
    if (rc != 0) return rc;
    const int nsl = cdiv(cout / 8, slice / 8);
    const long long items = static_cast<long long>(n) * cdiv(w / 2, kTile)
                            * cdiv(h / 2, kTile) * nsl;
    int grid = 0;
    const cudaError_t err = persistent_grid(stem_stage_tc_kernel, smem, items,
                                            nsl, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    stem_stage_tc_kernel<<<grid, kThreads, smem, st>>>(
        xf, static_cast<const uint2*>(scratch), bf, out, n, h, w, cin, cout,
        slice, store);
    return static_cast<int>(cudaGetLastError());
  }
  if (highest) {
    // the persistent kernel, two halo buffers where they fit, else one
    int dev = 0, sms = 0, tr = 0, tc = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    stage_hi_tile(cin, cout, n, h / 2, w / 2, sms, &tr, &tc);
    const int bufs =
        stage_hi_smem_bytes(cin, cout, tr, tc, 2) <= kMaxSmem ? 2 : 1;
    const size_t smem = stage_hi_smem_bytes(cin, cout, tr, tc, bufs);
    if (smem <= kMaxSmem && reinterpret_cast<uintptr_t>(wgt) % 16 == 0) {
      const long long tiles = static_cast<long long>(n) * cdiv(w / 2, tc)
                              * cdiv(h / 2, tr);
      int grid = 0;
      err = persistent_grid(stem_stage_kernel, smem, tiles, 1, &grid);
      if (err != cudaSuccess) return static_cast<int>(err);
      stem_stage_kernel<<<grid, kThreads, smem, st>>>(
          xf, static_cast<const float*>(wgt), bf, out, n, h, w, cin, cout, tr,
          tc, store, bufs);
      return static_cast<int>(cudaGetLastError());
    }
  }
  return launch_deep_stage(xf, static_cast<const float*>(wgt), bf, out, n, h,
                           w, cin, cout, highest, store, st);
}

// Kernel K10: x [n, h, w, cin] f32, wm [3, 3, cin, cout] f32 (HWIO), the
// taps summed (v, u) when vmajor else (u, v), bias [cout] f32 -> out
// [n, h/2, w/2, cout] in the store type (0 float32, 1 bf16, 2 float16).
// Any cin and cout; millieye_stem_nhwc_route gives the kernel a shape
// takes: 0 stem_nhwc_kernel (weights and halo resident), 1
// stem_nhwc_wide_kernel (weights streamed a tap and a chunk at a time).
int millieye_stem_nhwc_route(int cin, int cout) {
  return nhwc_resident(cin, cout) ? 0 : 1;
}

int millieye_stem_nhwc(const void* x, const void* wm, const void* bias,
                       void* out, int n, int h, int w, int cin, int cout,
                       int vmajor, int store, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || h % 2 || w % 2 || cin <= 0 || cout <= 0
      || store < 0 || store > 2)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x),
              *wf = static_cast<const float*>(wm),
              *bf = static_cast<const float*>(bias);
  int grid = 0, dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!nhwc_resident(cin, cout)) {
    const int group = nhwc_wide_group(n, h / 2, w / 2, cout, sms);
    const bool resident = nhwc_wide_halo_resident(cin, group);
    const size_t smem = nhwc_wide_smem_bytes(cin, group);
    const long long items = static_cast<long long>(n)
        * cdiv(w / 2, kTile) * cdiv(h / 2, kTile) * cdiv(cout, 8 * group);
    auto kernel = group == 8
        ? (vmajor ? stem_nhwc_wide_kernel<true, 8>
                  : stem_nhwc_wide_kernel<false, 8>)
        : (vmajor ? stem_nhwc_wide_kernel<true, 4>
                  : stem_nhwc_wide_kernel<false, 4>);
    err = persistent_grid(kernel, smem, items, 1, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, st>>>(xf, wf, bf, out, n, h, w, cin, cout,
                                         store, resident ? 1 : 0);
    return static_cast<int>(cudaGetLastError());
  }
  int tr = 0, tc = 0;
  nhwc_tile(cin, cout, n, h / 2, w / 2, sms, &tr, &tc);
  const int bufs = nhwc_smem_bytes(cin, cout, tr, tc, 2) <= kMaxSmem ? 2 : 1;
  const size_t smem = nhwc_smem_bytes(cin, cout, tr, tc, bufs);
  const long long tiles = static_cast<long long>(n) * cdiv(w / 2, tc)
                          * cdiv(h / 2, tr);
  // the instance for this cin (its patch in registers up to kNRegC; the
  // last column: any cin, kNGroup channels a thread)
  using Kernel = decltype(&stem_nhwc_kernel<true, 0, 4>);
  static const Kernel kernels[2][kNRegC + 2] = {
      {stem_nhwc_kernel<false, 0, 4>, stem_nhwc_kernel<false, 1, 4>,
       stem_nhwc_kernel<false, 2, 4>, stem_nhwc_kernel<false, 3, 4>,
       stem_nhwc_kernel<false, 4, 4>, stem_nhwc_kernel<false, 0, kNGroup>},
      {stem_nhwc_kernel<true, 0, 4>, stem_nhwc_kernel<true, 1, 4>,
       stem_nhwc_kernel<true, 2, 4>, stem_nhwc_kernel<true, 3, 4>,
       stem_nhwc_kernel<true, 4, 4>, stem_nhwc_kernel<true, 0, kNGroup>}};
  const int group = nhwc_group(cin, cout), threads = nhwc_threads(group);
  const Kernel kernel = kernels[vmajor ? 1 : 0][
      cin <= kNRegC ? cin : group == 4 ? 0 : kNRegC + 1];
  err = persistent_grid(kernel, smem, tiles, 1, &grid, threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, st>>>(xf, wf, bf, out, n, h, w, cin, cout,
                                       tr, tc, store, bufs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
