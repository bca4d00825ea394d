// RoI crops of the fusion networks: PS-RoIAlign over the padded score map
// (kernel K2) and RoIAlign over the radar score map (kernel K3) with bf16
// operands, and, in the second half of this file, the float32-operand
// kernels with the precision ladder: PS-RoIAlign over the unpadded map
// (K6), over the padded map (K7), and K3's float32-operand mode.
//
// Replaces: millieye_tpu/ops/roi_pallas.py:ps_roi_align_pallas_padded_g1
// (K2, reduce="dot", precision="default") and
// millieye_tpu/ops/roi_pallas.py:roi_align_pallas with pack_p=True (K3).
//
// Both crops are separable (ops/roi_align.py): for RoI n of image b,
//   t[p, w, c]      = sum_h by[b, n, p, h] * F[b, h, w, c(p, ...)]
//   out[p, q, c]    = sum_w bf16(t[p, w, c] * bx[b, n, q, w])
// with the interpolation matrices by [B, N, P, H] and bx [B, N, Q, W]
// built outside the kernel (ops/roi_align.py:_batched_prep), as the JAX
// wrapper builds them in XLA. Operands are bf16, products accumulate in
// float32, and each t*bx product is rounded to bf16 before the float32
// sum over w: the TPU kernel's rounding under precision="default".
//
// Bound on an H100: bytes. At the serving point (B=1, N=96, 26x26 map)
// K2's useful work is 2*N*P*(H*W + W)*C_out*Q = 66 MFLOP (0.07 us at
// 989 TFLOP/s) against 0.92 MB it must move (0.27 us at 3.35 TB/s): the
// C_out*Q = 70 live lanes of each 128-lane block of the bf16 map
// (0.66 MB), by, bx and the float32 output. K3's map is 49x smaller.
// Both bounds are below a microsecond, so launch latency dominates at
// batch 1.
//
// K2's design: one thread block per (image, RoI, bin row p), 672 blocks
// at B = 1, N = 96. Bilinear taps make by[p, :] zero outside the few map
// rows under bin row p, and bx[q, :] zero outside the RoI's columns, so
// the block first finds the nonzero span [y_lo, y_hi] of by[p, :] and the
// span [x_lo, x_hi] of the union of bx[q, :] over q, then sums only
// there, in ascending order as before. The skipped terms are exact
// zeros: on a finite map fmaf(0, f, acc) == acc and acc + bf16(+-0) ==
// acc for a sum that starts at +0, so the result is bit-equal to the
// full sum (the plain version takes the same spans, and the CPU tests
// hold it to the full sum). t for the x span sits in shared memory: one
// thread per (column, 8-lane group) reads each pixel's 70 live lanes as
// nine 16-byte loads (lanes 70-71, padding, are read and dropped). Each
// map element is read once per block, so the loads go straight from L2
// to registers; staging them in shared memory would add a copy and no
// reuse. A whole-frame RoI reads about 5 rows x 26 columns x 144 B =
// 19 KB per bin row, where the first design read the whole 26x26 map.
// K3 keeps the first design: one block per (image, RoI), t for all bin
// rows in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kRoiThreads = 128;

__global__ void __launch_bounds__(kRoiThreads)
ps_roi_align_kernel(const __nv_bfloat16* __restrict__ feat,
                    const __nv_bfloat16* __restrict__ by,
                    const __nv_bfloat16* __restrict__ bx,
                    float* __restrict__ out, int n_roi, int h, int w,
                    int c_pad, int ph, int pw, int c_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_span[4];        // y_lo, y_hi, x_lo, x_hi
  const int block = c_pad / ph;
  const int ol = c_out * pw;
  const int groups = (ol + 7) / 8; // 8-lane (16-byte) groups of a pixel
  const int tl = 8 * groups;       // t's row pitch, a multiple of 4
  float* s_by = smem;              // [h], bin row p
  float* s_bx = s_by + h;          // [pw, w]
  float* s_t = smem + ((h + pw * w + 3) & ~3);  // [x span, tl], 16-byte
                                                // aligned for float4

  const int p = blockIdx.x % ph;
  const int roi = blockIdx.x / ph; // b * n_roi + n
  const int b = roi / n_roi;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_span[0] = h;
    s_span[1] = -1;
    s_span[2] = w;
    s_span[3] = -1;
  }
  __syncthreads();
  const __nv_bfloat16* by_r = by + (static_cast<size_t>(roi) * ph + p) * h;
  const __nv_bfloat16* bx_r = bx + static_cast<size_t>(roi) * pw * w;
  for (int i = tid; i < h; i += blockDim.x) {
    const float v = __bfloat162float(by_r[i]);
    s_by[i] = v;
    if (v != 0.0f) {
      atomicMin(&s_span[0], i);
      atomicMax(&s_span[1], i);
    }
  }
  for (int i = tid; i < pw * w; i += blockDim.x) {
    const float v = __bfloat162float(bx_r[i]);
    s_bx[i] = v;
    if (v != 0.0f) {
      atomicMin(&s_span[2], i % w);
      atomicMax(&s_span[3], i % w);
    }
  }
  __syncthreads();
  const int y_lo = s_span[0], y_hi = s_span[1], x_lo = s_span[2];
  const int nx = s_span[3] - x_lo + 1;   // <= 0 for an empty span

  // t[x, j] = sum_{y in span} by[p, y] * F[y, x, p*block + j]
  const __nv_bfloat16* f_b = feat + static_cast<size_t>(b) * h * w * c_pad
                             + p * block;
  for (int e = tid; e < nx * groups; e += blockDim.x) {
    const int xi = e / groups, g = e % groups;
    const __nv_bfloat16* f = f_b + static_cast<size_t>(x_lo + xi) * c_pad
                             + 8 * g;
    float acc[8] = {};
    for (int y = y_lo; y <= y_hi; ++y) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          f + static_cast<size_t>(y) * w * c_pad);
      const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
      const float wy = s_by[y];
#pragma unroll
      for (int k = 0; k < 4; ++k) {   // a bf16 is the top half of a float
        acc[2 * k] = fmaf(wy, __uint_as_float(words[k] << 16), acc[2 * k]);
        acc[2 * k + 1] = fmaf(wy, __uint_as_float(words[k] & 0xffff0000u),
                              acc[2 * k + 1]);
      }
    }
    float4* dst = reinterpret_cast<float4*>(s_t + xi * tl + 8 * g);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncthreads();

  // out[q, u] = sum_{x in span} bf16(t[x, j] * bx[q, x]), lane j = u*pw + q
  float* out_r = out + (static_cast<size_t>(roi) * ph + p) * pw * c_out;
  for (int j = tid; j < ol; j += blockDim.x) {
    const int u = j / pw, q = j % pw;
    const float* bxq = s_bx + q * w + x_lo;
    float acc = 0.0f;
    for (int xi = 0; xi < nx; ++xi)
      acc += bf16_round(__fmul_rn(s_t[xi * tl + j], bxq[xi]));
    out_r[q * c_out + u] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
roi_align_kernel(const __nv_bfloat16* __restrict__ feat,
                 const __nv_bfloat16* __restrict__ by,
                 const __nv_bfloat16* __restrict__ bx,
                 float* __restrict__ out, int n_roi, int h, int w, int c,
                 int ph, int pw) {
  extern __shared__ float smem[];
  float* s_by = smem;              // [ph, h]
  float* s_bx = s_by + ph * h;     // [pw, w]
  float* s_t = s_bx + pw * w;      // [ph, w, c]

  const int roi = blockIdx.x;
  const int b = roi / n_roi;
  const __nv_bfloat16* by_r = by + static_cast<size_t>(roi) * ph * h;
  const __nv_bfloat16* bx_r = bx + static_cast<size_t>(roi) * pw * w;
  for (int i = threadIdx.x; i < ph * h; i += blockDim.x)
    s_by[i] = __bfloat162float(by_r[i]);
  for (int i = threadIdx.x; i < pw * w; i += blockDim.x)
    s_bx[i] = __bfloat162float(bx_r[i]);
  __syncthreads();

  const __nv_bfloat16* f_b = feat + static_cast<size_t>(b) * h * w * c;
  const size_t row_stride = static_cast<size_t>(w) * c;
  for (int e = threadIdx.x; e < ph * w * c; e += blockDim.x) {
    const int p = e / (w * c), r = e % (w * c);
    float acc = 0.0f;
    for (int y = 0; y < h; ++y)
      acc = fmaf(s_by[p * h + y], __bfloat162float(f_b[y * row_stride + r]),
                 acc);
    s_t[e] = acc;
  }
  __syncthreads();

  float* out_r = out + static_cast<size_t>(roi) * ph * pw * c;
  for (int e = threadIdx.x; e < ph * pw * c; e += blockDim.x) {
    const int ch = e % c, pq = e / c;
    const int p = pq / pw, q = pq % pw;
    float acc = 0.0f;
    for (int x = 0; x < w; ++x)
      acc += bf16_round(__fmul_rn(s_t[(p * w + x) * c + ch],
                                  s_bx[q * w + x]));
    out_r[e] = acc;
  }
}

// ---------------------------------------------------------------------
// Float32-operand crops with the precision ladder (kernels K6, K7 and
// K3's float32 mode).
//
// Replaces: millieye_tpu/ops/roi_pallas.py:_launch as reached from
// ps_roi_align_pallas (channel orders "upq" and "puq") and from
// roi_align_pallas(pack_p=False) (K6); ps_roi_align_pallas_padded, the
// padded map on a (batch, bin-row) grid (K7); and roi_align_pallas with
// float32 operands, precision "split" or "highest" (K3).
//
// The same separable crop as above on float32 features, by and bx, with
// the meaning the TPU gives each precision:
//   default  by and F are rounded to bf16, t accumulates in float32;
//            each t*bx product is rounded to bf16 before the float32
//            w-sum (bx enters as given);
//   split    by = ah + al and F = bh + bl with ah, bh the bf16 roundings
//            and al, bl the remainders rounded to bf16:
//            t = (sum ah*bh + sum al*bh) + sum ah*bl, three float32 sums;
//            out = sum hi(t*bx) + sum lo(t*bx), hi the bf16 rounding and
//            lo the remainder rounded to bf16;
//   highest  float32 throughout.
// Every product of two bf16 values is exact in float32, so an FMA rounds
// like multiply-then-add; at "highest" the product is rounded first
// (__fmul_rn, then __fadd_rn). The plain versions repeat these
// operations in this order and are bit-equal.
//
// Bound on an H100: bytes, as K2 (the map in float32 is twice K2's: at
// B = 1, N = 232 the 490 live channels are 1.3 MB, by and bx 0.34 MB,
// the output 0.45 MB: 0.6 us at 3.35 TB/s, against 0.16 GFLOP: 2.4 us at
// the 67 TFLOP/s float32 rate for "highest"). Launch latency and the L2
// reads of the map dominate.
//
// Design: as K2, one thread block per (image, RoI), t for one bin row in
// shared memory. The feature channel of lane (u, q) in bin row p is
// p*sp + u*su + q*sq: "upq" (u*ph + p)*pw + q, "puq" (p*c_out + u)*pw + q,
// the padded map p*block + u*pw + q, and a map without bin channels
// (RoIAlign) u, where sq = 0 and t is formed once per channel, not once
// per (channel, q).
enum Precision { kDefault = 0, kSplit = 1, kHighest = 2 };

template <int kMode>
__device__ __forceinline__ void load_by(const float* __restrict__ src,
                                        float* hi, float* lo, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = src[i];
    if (kMode == kHighest) {
      hi[i] = v;
    } else {
      const float hv = bf16_round(v);
      hi[i] = hv;
      if (kMode == kSplit) lo[i] = bf16_round(__fsub_rn(v, hv));
    }
  }
}

// t = sum_y by[y] * f[y * stride] under the ladder.
template <int kMode>
__device__ __forceinline__ float sum_h(const float* by_hi,
                                       const float* by_lo,
                                       const float* __restrict__ f,
                                       size_t stride, int h) {
  if (kMode == kSplit) {
    float a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    for (int y = 0; y < h; ++y) {
      const float v = f[y * stride];
      const float fh = bf16_round(v);
      const float fl = bf16_round(__fsub_rn(v, fh));
      a1 = fmaf(by_hi[y], fh, a1);
      a2 = fmaf(by_lo[y], fh, a2);
      a3 = fmaf(by_hi[y], fl, a3);
    }
    return __fadd_rn(__fadd_rn(a1, a2), a3);
  }
  float acc = 0.0f;
  for (int y = 0; y < h; ++y) {
    const float v = f[y * stride];
    acc = kMode == kHighest ? __fadd_rn(acc, __fmul_rn(by_hi[y], v))
                            : fmaf(by_hi[y], bf16_round(v), acc);
  }
  return acc;
}

// out = sum_x g(t[x * stride] * bx[x]) under the ladder.
template <int kMode>
__device__ __forceinline__ float sum_w(const float* t, int stride,
                                       const float* bx, int w) {
  float a1 = 0.0f, a2 = 0.0f;
  for (int x = 0; x < w; ++x) {
    const float prod = __fmul_rn(t[x * stride], bx[x]);
    if (kMode == kHighest) {
      a1 = __fadd_rn(a1, prod);
    } else {
      const float hv = bf16_round(prod);
      a1 = __fadd_rn(a1, hv);
      if (kMode == kSplit) a2 = __fadd_rn(a2, bf16_round(__fsub_rn(prod, hv)));
    }
  }
  return kMode == kSplit ? __fadd_rn(a1, a2) : a1;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
ps_roi_align_f32_kernel(const float* __restrict__ feat,
                        const float* __restrict__ by,
                        const float* __restrict__ bx,
                        float* __restrict__ out, int n_roi, int h, int w,
                        int c_feat, int ph, int pw, int c_out, int sp, int su,
                        int sq) {
  extern __shared__ float smem[];
  const int ol = c_out * pw;
  const int tl = sq ? ol : c_out;  // distinct lanes of t
  float* s_by = smem;              // [ph, h] (hi part under "split")
  float* s_byl = s_by + ph * h;    // [ph, h] lo part, "split" only
  float* s_bx = s_byl + (kMode == kSplit ? ph * h : 0);  // [pw, w]
  float* s_t = s_bx + pw * w;      // [w, tl] for the current bin row

  const int roi = blockIdx.x;      // b * n_roi + n
  const int b = roi / n_roi;
  load_by<kMode>(by + static_cast<size_t>(roi) * ph * h, s_by, s_byl, ph * h);
  const float* bx_r = bx + static_cast<size_t>(roi) * pw * w;
  for (int i = threadIdx.x; i < pw * w; i += blockDim.x) s_bx[i] = bx_r[i];
  __syncthreads();

  const float* f_b = feat + static_cast<size_t>(b) * h * w * c_feat;
  float* out_r = out + static_cast<size_t>(roi) * ph * pw * c_out;
  const size_t row_stride = static_cast<size_t>(w) * c_feat;
  for (int p = 0; p < ph; ++p) {
    for (int e = threadIdx.x; e < w * tl; e += blockDim.x) {
      const int x = e / tl, j = e % tl;
      const int chan = sq ? p * sp + (j / pw) * su + (j % pw) * sq
                          : p * sp + j * su;
      s_t[e] = sum_h<kMode>(s_by + p * h, s_byl + p * h,
                            f_b + static_cast<size_t>(x) * c_feat + chan,
                            row_stride, h);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < ol; j += blockDim.x) {
      const int u = j / pw, q = j % pw;
      out_r[(p * pw + q) * c_out + u] =
          sum_w<kMode>(s_t + (sq ? j : u), tl, s_bx + q * w, w);
    }
    __syncthreads();
  }
}

// K3 with float32 operands: all bin rows of t in shared memory at once.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
roi_align_f32_kernel(const float* __restrict__ feat,
                     const float* __restrict__ by,
                     const float* __restrict__ bx, float* __restrict__ out,
                     int n_roi, int h, int w, int c, int ph, int pw) {
  extern __shared__ float smem[];
  float* s_by = smem;              // [ph, h]
  float* s_byl = s_by + ph * h;    // [ph, h], "split" only
  float* s_bx = s_byl + (kMode == kSplit ? ph * h : 0);  // [pw, w]
  float* s_t = s_bx + pw * w;      // [ph, w, c]

  const int roi = blockIdx.x;
  const int b = roi / n_roi;
  load_by<kMode>(by + static_cast<size_t>(roi) * ph * h, s_by, s_byl, ph * h);
  const float* bx_r = bx + static_cast<size_t>(roi) * pw * w;
  for (int i = threadIdx.x; i < pw * w; i += blockDim.x) s_bx[i] = bx_r[i];
  __syncthreads();

  const float* f_b = feat + static_cast<size_t>(b) * h * w * c;
  const size_t row_stride = static_cast<size_t>(w) * c;
  for (int e = threadIdx.x; e < ph * w * c; e += blockDim.x) {
    const int p = e / (w * c), r = e % (w * c);
    s_t[e] = sum_h<kMode>(s_by + p * h, s_byl + p * h, f_b + r, row_stride, h);
  }
  __syncthreads();

  float* out_r = out + static_cast<size_t>(roi) * ph * pw * c;
  for (int e = threadIdx.x; e < ph * pw * c; e += blockDim.x) {
    const int ch = e % c, pq = e / c;
    const int p = pq / pw, q = pq % pw;
    out_r[e] = sum_w<kMode>(s_t + p * w * c + ch, c, s_bx + q * w, w);
  }
}

constexpr size_t kMaxSmem = 48 * 1024;  // no opt-in above the default

int launch_ps_f32(const void* feat, const void* by, const void* bx, void* out,
                  int batch, int n_roi, int h, int w, int c_feat, int ph,
                  int pw, int c_out, int sp, int su, int sq, int mode,
                  void* stream) {
  if (batch <= 0 || n_roi <= 0 || ph <= 0 || pw <= 0 || c_out <= 0
      || mode < kDefault || mode > kHighest
      || (ph - 1) * sp + (c_out - 1) * su + (pw - 1) * sq >= c_feat)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float)
      * ((mode == kSplit ? 2 : 1) * ph * h + pw * w
         + w * (sq ? c_out * pw : c_out));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(feat);
  const float* y = static_cast<const float*>(by);
  const float* x = static_cast<const float*>(bx);
  float* o = static_cast<float*>(out);
  const int grid = batch * n_roi;
  if (mode == kDefault)
    ps_roi_align_f32_kernel<kDefault><<<grid, kThreads, smem, st>>>(
        f, y, x, o, n_roi, h, w, c_feat, ph, pw, c_out, sp, su, sq);
  else if (mode == kSplit)
    ps_roi_align_f32_kernel<kSplit><<<grid, kThreads, smem, st>>>(
        f, y, x, o, n_roi, h, w, c_feat, ph, pw, c_out, sp, su, sq);
  else
    ps_roi_align_f32_kernel<kHighest><<<grid, kThreads, smem, st>>>(
        f, y, x, o, n_roi, h, w, c_feat, ph, pw, c_out, sp, su, sq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* millieye_cuda_error_name(int code) {
  return cudaGetErrorName(static_cast<cudaError_t>(code));
}

// feat [B, H, W, c_pad] bf16 (c_pad = ph * block, 16-byte aligned, block
// a multiple of 8 lanes), by [B, N, ph, H] bf16, bx [B, N, pw, W] bf16
// -> out [B, N, ph, pw, c_out] f32.
int millieye_ps_roi_align(const void* feat, const void* by, const void* bx,
                          void* out, int batch, int n_roi, int h, int w,
                          int c_pad, int ph, int pw, int c_out,
                          void* stream) {
  if (batch <= 0 || n_roi <= 0 || ph <= 0 || c_pad % ph != 0
      || (c_pad / ph) % 8 != 0 || 8 * ((c_out * pw + 7) / 8) > c_pad / ph
      || reinterpret_cast<uintptr_t>(feat) % 16 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float)
      * (((h + pw * w + 3) & ~3) + w * 8 * ((c_out * pw + 7) / 8));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  ps_roi_align_kernel<<<batch * n_roi * ph, kRoiThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(feat),
      static_cast<const __nv_bfloat16*>(by),
      static_cast<const __nv_bfloat16*>(bx), static_cast<float*>(out), n_roi,
      h, w, c_pad, ph, pw, c_out);
  return static_cast<int>(cudaGetLastError());
}

// feat [B, H, W, C] bf16, by [B, N, ph, H] bf16, bx [B, N, pw, W] bf16
// -> out [B, N, ph, pw, C] f32.
int millieye_roi_align(const void* feat, const void* by, const void* bx,
                       void* out, int batch, int n_roi, int h, int w, int c,
                       int ph, int pw, void* stream) {
  if (batch <= 0 || n_roi <= 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (ph * h + pw * w + ph * w * c);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  roi_align_kernel<<<batch * n_roi, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(feat),
      static_cast<const __nv_bfloat16*>(by),
      static_cast<const __nv_bfloat16*>(bx), static_cast<float*>(out), n_roi,
      h, w, c, ph, pw);
  return static_cast<int>(cudaGetLastError());
}

// Kernel K6. feat [B, H, W, c_feat] f32, by [B, N, ph, H] f32, bx
// [B, N, pw, W] f32 -> out [B, N, ph, pw, c_out] f32; the channel of
// (p, u, q) is p*sp + u*su + q*sq; mode 0 default, 1 split, 2 highest.
int millieye_ps_roi_align_f32(const void* feat, const void* by,
                              const void* bx, void* out, int batch, int n_roi,
                              int h, int w, int c_feat, int ph, int pw,
                              int c_out, int sp, int su, int sq, int mode,
                              void* stream) {
  return launch_ps_f32(feat, by, bx, out, batch, n_roi, h, w, c_feat, ph, pw,
                       c_out, sp, su, sq, mode, stream);
}

// Kernel K7. feat [B, H, W, c_pad] f32 with c_pad = ph * block and
// channel p*block + u*pw + q; the rest as K6.
int millieye_ps_roi_align_padded_f32(const void* feat, const void* by,
                                     const void* bx, void* out, int batch,
                                     int n_roi, int h, int w, int c_pad,
                                     int ph, int pw, int c_out, int mode,
                                     void* stream) {
  if (ph <= 0 || c_pad % ph != 0 || c_out * pw > c_pad / ph)
    return cudaErrorInvalidValue;
  return launch_ps_f32(feat, by, bx, out, batch, n_roi, h, w, c_pad, ph, pw,
                       c_out, c_pad / ph, pw, 1, mode, stream);
}

// Kernel K3 with float32 operands; mode 1 split or 2 highest ("default"
// runs on bf16 operands, millieye_roi_align above).
int millieye_roi_align_f32(const void* feat, const void* by, const void* bx,
                           void* out, int batch, int n_roi, int h, int w,
                           int c, int ph, int pw, int mode, void* stream) {
  if (batch <= 0 || n_roi <= 0 || (mode != kSplit && mode != kHighest))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float)
      * ((mode == kSplit ? 2 : 1) * ph * h + pw * w + ph * w * c);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(feat);
  const float* y = static_cast<const float*>(by);
  const float* x = static_cast<const float*>(bx);
  float* o = static_cast<float*>(out);
  const int grid = batch * n_roi;
  if (mode == kSplit)
    roi_align_f32_kernel<kSplit><<<grid, kThreads, smem, st>>>(
        f, y, x, o, n_roi, h, w, c, ph, pw);
  else
    roi_align_f32_kernel<kHighest><<<grid, kThreads, smem, st>>>(
        f, y, x, o, n_roi, h, w, c, ph, pw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
