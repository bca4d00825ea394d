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

}  // extern "C"
