// Fused stem kernels: the two-stage pair K4 (below) and the single stage
// K9 (second half of this file).
//
// Fused stem pair (kernel K4):
//   out = maxpool2(leaky(conv3x3(maxpool2(leaky(conv3x3(x, w0) + b0)), w1)
//                  + b1))
// for NHWC float32 x [N, H, W, Cin] -> NHWC float16 [N, H/4, W/4, Cout],
// convolutions with zero padding 1, leaky slope 0.1, 2x2/2 max pools.
//
// Replaces: millieye_tpu/ops/stem_pallas.py:fused_stem2_phase with
// bf16_only="s0s1", precision="default" (the pallas_max_s01 stem). Its
// numerics: the input and w0 are rounded to bf16, products accumulate in
// float32, then +b0, leaky and the pool; the 2x-down intermediate stays
// float32 and is rounded to bf16 as stage 1's operand, with w1 in bf16;
// stage 1 accumulates in float32, then +b1, leaky, the pool, and one
// float16 store.
//
// Bound on an H100 at 416 px: bytes. Per image it must read the 2.08 MB
// float32 input and write the 0.69 MB float16 output (0.8 us at
// 3.35 TB/s), against 0.55 GFLOP of bf16 products (0.6 us at
// 989 TFLOP/s on the tensor cores). This first kernel runs the products
// on the CUDA cores in float32 FMAs, so arithmetic, not either bound,
// sets its time; moving them to mma/wgmma is later work.
//
// Design: one thread block per 8x8 tile of output pixels. The block
// stages a 38x38xCin input halo (bf16) and both weight sets (bf16) in
// shared memory, computes the 18x18xCmid stage-0 intermediate it needs
// (one halo pixel on each side) into shared memory, zeroed where it falls
// outside the H/2 x W/2 map because stage 1 pads with zeros, then
// computes its 8x8xCout outputs. The 2x-down intermediate (H/2 x W/2 x
// Cmid, 1.4 MB float32 per 416 px image) never reaches device memory,
// which is what the Pallas kernel kept in VMEM. Each thread owns 8
// channels of one pixel at all four pool positions, so a warp reads the
// same weights (broadcast) and neighbouring pixels.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;               // output pixels per tile side
constexpr int kMid = 2 * kTile + 2;    // intermediate pixels, with halo
constexpr int kIn = 4 * kTile + 6;     // input pixels, with halo
constexpr int kThreads = 256;
constexpr int kGroup = 8;              // channels per thread
constexpr size_t kMaxSmem = 48 * 1024;

__device__ __forceinline__ float leaky(float v) {
  return v > 0.0f ? v : 0.1f * v;
}

__host__ __device__ inline size_t smem_bytes(int cin, int cmid, int cout) {
  return sizeof(float) * (cmid + cout)
         + sizeof(__nv_bfloat16) * (9 * cin * cmid + 9 * cmid * cout
                                    + kIn * kIn * cin + kMid * kMid * cmid);
}

__global__ void __launch_bounds__(kThreads)
stem_pair_kernel(const float* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w0,  // [3, 3, cin, cmid]
                 const float* __restrict__ b0,
                 const __nv_bfloat16* __restrict__ w1,  // [3, 3, cmid, cout]
                 const float* __restrict__ b1, __half* __restrict__ out,
                 int h, int w, int cin, int cmid, int cout) {
  extern __shared__ float smem[];
  float* s_b0 = smem;
  float* s_b1 = s_b0 + cmid;
  __nv_bfloat16* s_w0 = reinterpret_cast<__nv_bfloat16*>(s_b1 + cout);
  __nv_bfloat16* s_w1 = s_w0 + 9 * cin * cmid;
  __nv_bfloat16* s_in = s_w1 + 9 * cmid * cout;   // [kIn, kIn, cin]
  __nv_bfloat16* s_mid = s_in + kIn * kIn * cin;  // [kMid, kMid, cmid]

  const int tid = threadIdx.x;
  const int n = blockIdx.z, ty = blockIdx.y, tx = blockIdx.x;
  const int hm = h / 2, wm = w / 2, ho = h / 4, wo = w / 4;

  for (int i = tid; i < cmid; i += kThreads) s_b0[i] = b0[i];
  for (int i = tid; i < cout; i += kThreads) s_b1[i] = b1[i];
  for (int i = tid; i < 9 * cin * cmid; i += kThreads) s_w0[i] = w0[i];
  for (int i = tid; i < 9 * cmid * cout; i += kThreads) s_w1[i] = w1[i];

  // input halo: local (ly, lx) <-> global (4*kTile*ty - 3 + ly, ...)
  const int iy0 = 4 * kTile * ty - 3, ix0 = 4 * kTile * tx - 3;
  const float* xn = x + static_cast<size_t>(n) * h * w * cin;
  for (int e = tid; e < kIn * kIn * cin; e += kThreads) {
    const int c = e % cin, pix = e / cin;
    const int gy = iy0 + pix / kIn, gx = ix0 + pix % kIn;
    float v = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      v = xn[(static_cast<size_t>(gy) * w + gx) * cin + c];
    s_in[e] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  // stage 0: intermediate local (ly, lx) <-> global (2*kTile*ty - 1 + ly,
  // ...); its conv outputs (2*gy + dy, ...) read input local rows
  // 2*ly + dy + u and columns 2*lx + dx + v
  const int my0 = 2 * kTile * ty - 1, mx0 = 2 * kTile * tx - 1;
  const int groups0 = cmid / kGroup;
  for (int e = tid; e < kMid * kMid * groups0; e += kThreads) {
    const int pix = e % (kMid * kMid), g = e / (kMid * kMid);
    const int ly = pix / kMid, lx = pix % kMid;
    const int gy = my0 + ly, gx = mx0 + lx;
    __nv_bfloat16* dst = s_mid + pix * cmid + g * kGroup;
    if (gy < 0 || gy >= hm || gx < 0 || gx >= wm) {
      for (int k = 0; k < kGroup; ++k) dst[k] = __float2bfloat16_rn(0.0f);
      continue;
    }
    float acc[4][kGroup] = {};
    for (int u = 0; u < 3; ++u)
      for (int v = 0; v < 3; ++v)
        for (int c = 0; c < cin; ++c) {
          const __nv_bfloat16* wr = s_w0 + ((u * 3 + v) * cin + c) * cmid
                                    + g * kGroup;
          float wv[kGroup];
          for (int k = 0; k < kGroup; ++k) wv[k] = __bfloat162float(wr[k]);
          for (int d = 0; d < 4; ++d) {
            const int r = 2 * ly + (d >> 1) + u, s = 2 * lx + (d & 1) + v;
            const float xv = __bfloat162float(s_in[(r * kIn + s) * cin + c]);
            for (int k = 0; k < kGroup; ++k)
              acc[d][k] = fmaf(xv, wv[k], acc[d][k]);
          }
        }
    for (int k = 0; k < kGroup; ++k) {
      const float bias = s_b0[g * kGroup + k];
      float m = leaky(acc[0][k] + bias);
      for (int d = 1; d < 4; ++d) m = fmaxf(m, leaky(acc[d][k] + bias));
      dst[k] = __float2bfloat16_rn(m);  // stage 1's bf16 operand
    }
  }
  __syncthreads();

  // stage 1: output local (py, px) <-> global (kTile*ty + py, ...); its
  // conv outputs read intermediate local rows 2*py + dy + u
  const int groups1 = cout / kGroup;
  for (int e = tid; e < kTile * kTile * groups1; e += kThreads) {
    const int pix = e % (kTile * kTile), g = e / (kTile * kTile);
    const int py = pix / kTile, px = pix % kTile;
    const int oy = kTile * ty + py, ox = kTile * tx + px;
    if (oy >= ho || ox >= wo) continue;
    float acc[4][kGroup] = {};
    for (int u = 0; u < 3; ++u)
      for (int v = 0; v < 3; ++v)
        for (int c = 0; c < cmid; ++c) {
          const __nv_bfloat16* wr = s_w1 + ((u * 3 + v) * cmid + c) * cout
                                    + g * kGroup;
          float wv[kGroup];
          for (int k = 0; k < kGroup; ++k) wv[k] = __bfloat162float(wr[k]);
          for (int d = 0; d < 4; ++d) {
            const int r = 2 * py + (d >> 1) + u, s = 2 * px + (d & 1) + v;
            const float mv = __bfloat162float(s_mid[(r * kMid + s) * cmid + c]);
            for (int k = 0; k < kGroup; ++k)
              acc[d][k] = fmaf(mv, wv[k], acc[d][k]);
          }
        }
    __half* o = out + ((static_cast<size_t>(n) * ho + oy) * wo + ox) * cout
                + g * kGroup;
    for (int k = 0; k < kGroup; ++k) {
      const float bias = s_b1[g * kGroup + k];
      float m = leaky(acc[0][k] + bias);
      for (int d = 1; d < 4; ++d) m = fmaxf(m, leaky(acc[d][k] + bias));
      o[k] = __float2half_rn(m);
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
// 0.4 us at the bf16 tensor-core rate "default" would allow). This first
// kernel runs all products on the CUDA cores.
//
// Design: one thread block per 8x8 tile of pooled pixels and per slice
// of up to 32 output channels. Input channels go through shared memory
// in chunks of 16: the 18x18 input halo of the chunk, planar
// [c][row][col] (so the pixels of a warp read different banks), and the
// chunk's weights [c][u][v][co]. That keeps shared memory at 40 KB for
// any Cin and Cout (stage 6's full weights alone are 288 KB). A thread
// owns one pooled pixel and 8 output channels at all four pool
// positions: per input channel it loads its 4x4 input patch once and
// the 9 x 8 weights as broadcast float4 reads, for 288 multiply-adds.
// The sum runs over (c, u, v), c slowest, one add at a time: with bf16
// operands each product is exact in float32, so the FMA rounds like
// multiply-then-add; at "highest" the product is rounded first
// (__fmul_rn, __fadd_rn), so the plain version can repeat it bit for bit.
constexpr int kCk = 16;                 // input channels per chunk
constexpr int kCo = 32;                 // output channels per block
constexpr int kHalo = 2 * kTile + 2;    // 18 input pixels per tile side
constexpr int kPitch = kHalo + 1;       // row pitch of the planar halo

enum StoreType { kStoreF32 = 0, kStoreBf16 = 1, kStoreF16 = 2 };

template <bool kHighest>
__global__ void __launch_bounds__(kThreads)
stem_stage_kernel(const float* __restrict__ x,
                  const float* __restrict__ wgt,   // [cin, 3, 3, cout]
                  const float* __restrict__ bias, void* __restrict__ out,
                  int h, int w, int cin, int cout, int store) {
  __shared__ float s_in[kCk * kHalo * kPitch];
  __shared__ __align__(16) float s_w[kCk * 9 * kCo];

  const int tid = threadIdx.x;
  const int slices = (cout + kCo - 1) / kCo;
  const int n = blockIdx.z / slices, slice = blockIdx.z % slices;
  const int co0 = slice * kCo;
  const int co_n = min(kCo, cout - co0);       // a multiple of kGroup
  const int ho = h / 2, wo = w / 2;
  const int pix = tid % (kTile * kTile), g = tid / (kTile * kTile);
  const int py = pix / kTile, px = pix % kTile;
  const int oy = kTile * blockIdx.y + py, ox = kTile * blockIdx.x + px;
  const bool active = g * kGroup < co_n;
  // input halo: local (ly, lx) <-> global (2*kTile*ty - 1 + ly, ...)
  const int iy0 = 2 * kTile * blockIdx.y - 1, ix0 = 2 * kTile * blockIdx.x - 1;
  const float* xn = x + static_cast<size_t>(n) * h * w * cin;

  float acc[4][kGroup] = {};
  for (int c0 = 0; c0 < cin; c0 += kCk) {
    const int cn = min(kCk, cin - c0);
    __syncthreads();                     // the previous chunk is consumed
    for (int e = tid; e < kHalo * kHalo * cn; e += kThreads) {
      const int c = e % cn, p = e / cn;
      const int ly = p / kHalo, lx = p % kHalo;
      const int gy = iy0 + ly, gx = ix0 + lx;
      float v = 0.0f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = xn[(static_cast<size_t>(gy) * w + gx) * cin + c0 + c];
      if (!kHighest) v = __bfloat162float(__float2bfloat16_rn(v));
      s_in[(c * kHalo + ly) * kPitch + lx] = v;
    }
    for (int e = tid; e < cn * 9 * kCo; e += kThreads) {
      const int co = e % kCo, ct = e / kCo;     // ct = c * 9 + u * 3 + v
      float v = 0.0f;
      if (co < co_n)
        v = wgt[(static_cast<size_t>(c0) * 9 + ct) * cout + co0 + co];
      if (!kHighest) v = __bfloat162float(__float2bfloat16_rn(v));
      s_w[e] = v;
    }
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < cn; ++c) {
      float patch[4][4];
      for (int r = 0; r < 4; ++r)
        for (int q = 0; q < 4; ++q)
          patch[r][q] = s_in[(c * kHalo + 2 * py + r) * kPitch + 2 * px + q];
      for (int u = 0; u < 3; ++u)
        for (int v = 0; v < 3; ++v) {
          const float4* wr = reinterpret_cast<const float4*>(
              s_w + (c * 9 + u * 3 + v) * kCo + g * kGroup);
          const float4 wa = wr[0], wb = wr[1];
          const float wv[kGroup] = {wa.x, wa.y, wa.z, wa.w,
                                    wb.x, wb.y, wb.z, wb.w};
          for (int d = 0; d < 4; ++d) {
            const float xv = patch[(d >> 1) + u][(d & 1) + v];
            for (int k = 0; k < kGroup; ++k)
              acc[d][k] = kHighest
                  ? __fadd_rn(acc[d][k], __fmul_rn(xv, wv[k]))
                  : fmaf(xv, wv[k], acc[d][k]);
          }
        }
    }
  }
  if (!active || oy >= ho || ox >= wo) return;
  const size_t o = ((static_cast<size_t>(n) * ho + oy) * wo + ox) * cout
                   + co0 + g * kGroup;
  for (int k = 0; k < kGroup; ++k) {
    const float bv = bias[co0 + g * kGroup + k];
    float m = leaky(__fadd_rn(acc[0][k], bv));
    for (int d = 1; d < 4; ++d) m = fmaxf(m, leaky(__fadd_rn(acc[d][k], bv)));
    if (store == kStoreF32)
      static_cast<float*>(out)[o + k] = m;
    else if (store == kStoreBf16)
      static_cast<__nv_bfloat16*>(out)[o + k] = __float2bfloat16_rn(m);
    else
      static_cast<__half*>(out)[o + k] = __float2half_rn(m);
  }
}

}  // namespace

extern "C" {

const char* millieye_cuda_error_name(int code) {
  return cudaGetErrorName(static_cast<cudaError_t>(code));
}

// x [n, h, w, cin] f32, w0 [3, 3, cin, cmid] bf16, b0 [cmid] f32,
// w1 [3, 3, cmid, cout] bf16, b1 [cout] f32 -> out [n, h/4, w/4, cout] f16.
int millieye_stem_pair(const void* x, const void* w0, const void* b0,
                       const void* w1, const void* b1, void* out, int n,
                       int h, int w, int cin, int cmid, int cout,
                       void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || h % 4 || w % 4 || cin <= 0
      || cmid % kGroup || cout % kGroup || cmid <= 0 || cout <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(cin, cmid, cout);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid((w / 4 + kTile - 1) / kTile, (h / 4 + kTile - 1) / kTile,
                  n);
  stem_pair_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(w0),
      static_cast<const float*>(b0), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<__half*>(out), h, w, cin,
      cmid, cout);
  return static_cast<int>(cudaGetLastError());
}

// x [n, h, w, cin] f32, wgt [cin, 3, 3, cout] f32 (rounded to bf16 in
// the kernel when highest == 0), bias [cout] f32 -> out [n, h/2, w/2, cout] in the
// store type (0 float32, 1 bf16, 2 float16). Kernel K9.
int millieye_stem_stage(const void* x, const void* wgt, const void* bias,
                        void* out, int n, int h, int w, int cin, int cout,
                        int highest, int store, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || h % 2 || w % 2 || cin <= 0 || cout <= 0
      || cout % kGroup || store < 0 || store > 2)
    return cudaErrorInvalidValue;
  const int slices = (cout + kCo - 1) / kCo;
  const dim3 grid((w / 2 + kTile - 1) / kTile, (h / 2 + kTile - 1) / kTile,
                  n * slices);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (highest)
    stem_stage_kernel<true><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wgt),
        static_cast<const float*>(bias), out, h, w, cin, cout, store);
  else
    stem_stage_kernel<false><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wgt),
        static_cast<const float*>(bias), out, h, w, cin, cout, store);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
