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
// Bound on an H100: bytes. At b32 the function must move the 490 live
// channels of the float32 map (42 MB), by, bx and the output: 0.019 ms
// for K6 (N = 200) and 0.020 ms for K7 (N = 232) at 3.35 TB/s. Its
// products on the nonzero support take less at the float32 rate. What
// the card pays in practice is the L2 traffic of the map windows: every
// (RoI, bin row) reads its own window of the map again.
//
// K6 and K7's design (K2's, above): one thread block per (image, RoI,
// bin row p). The block finds the span [y_lo, y_hi] of nonzero by[p, :]
// and the span [x_lo, x_hi] of the union of nonzero bx[q, :] over q, on
// the float32 values as given, then sums only there, in ascending order:
//   t[x, j]  = sum_{y in span} by[p, y] * F[y, x, chan(p, j)]
//   out[q,u] = sum_{x in span} g(t[x, j] * bx[q, x])
// with t for the x span in shared memory. The skipped terms are exact
// zeros, and each sum starts at +0 and never holds -0 (x + -x is +0 in
// round-to-nearest), so on a finite map the span sum is the full sum bit
// for bit at every rung: "default" fmaf(0, f, acc) == acc; "highest"
// acc + (0 * v) adds +-0; "split" a zero by has zero hi and lo parts, and
// a zero bx makes prod, hi(prod) and lo(prod) +-0. A rounded operand is
// zero where the given one is, so the spans cover every nonzero rounded
// term. The channel of lane j = u*pw + q in bin row p is p*sp + u*su +
// q*sq: "upq" (u*ph + p)*pw + q, "puq" (p*c_out + u)*pw + q, the padded
// map p*block + u*pw + q, and a map without bin channels (RoIAlign) u,
// where sq = 0 and t is formed once per channel, not per (channel, q).
// One thread per (column, group of kVec lanes) loads each map element of
// the span once and forms its hi/lo pair there; neighbouring threads
// read neighbouring lanes. Where a bin row's lanes are contiguous and
// aligned ("puq", the padded map, "c") a group is a float2 or float4
// load (K7 reads 72 lanes from p*128 as 18 float4 and drops lanes
// 70-71); "upq"'s bin row is 10 runs of 7 lanes 49 apart, read one float
// a thread, a run by neighbouring threads. The output sum runs one thread
// per output element, in the output's order, so the stores coalesce.
// Blocks of 64 threads: a bin row's t has 5-70 lane groups a column and
// its output 70 elements, so wider blocks idle, while an SM's 32
// resident 64-thread blocks still fill its 2,048 threads (picked on an
// H100 among 32, 64, 96 and 128).
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

// One term of t under the ladder: a1 (and a2, a3 under "split") +=
// by * v, by's parts wh (hi) and wl (lo).
template <int kMode>
__device__ __forceinline__ void add_h(float wh, float wl, float v,
                                      float& a1, float& a2, float& a3) {
  if (kMode == kHighest) {
    a1 = __fadd_rn(a1, __fmul_rn(wh, v));
  } else if (kMode == kDefault) {
    a1 = fmaf(wh, bf16_round(v), a1);
  } else {
    const float fh = bf16_round(v);
    const float fl = bf16_round(__fsub_rn(v, fh));
    a1 = fmaf(wh, fh, a1);
    a2 = fmaf(wl, fh, a2);
    a3 = fmaf(wh, fl, a3);
  }
}

template <int kMode>
__device__ __forceinline__ float end_h(float a1, float a2, float a3) {
  return kMode == kSplit ? __fadd_rn(__fadd_rn(a1, a2), a3) : a1;
}

// t = sum_y by[y] * f[y * stride] under the ladder.
template <int kMode>
__device__ __forceinline__ float sum_h(const float* by_hi,
                                       const float* by_lo,
                                       const float* __restrict__ f,
                                       size_t stride, int h) {
  float a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int y = 0; y < h; ++y)
    add_h<kMode>(by_hi[y], kMode == kSplit ? by_lo[y] : 0.0f, f[y * stride],
                 a1, a2, a3);
  return end_h<kMode>(a1, a2, a3);
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

// kVec consecutive floats, one load of 4 * kVec bytes.
template <int kVec>
__device__ __forceinline__ void load_lanes(const float* __restrict__ src,
                                           float* v) {
  if constexpr (kVec == 4) {
    const float4 r = *reinterpret_cast<const float4*>(src);
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  } else if constexpr (kVec == 2) {
    const float2 r = *reinterpret_cast<const float2*>(src);
    v[0] = r.x, v[1] = r.y;
  } else {
    v[0] = *src;
  }
}

template <int kVec>
__device__ __forceinline__ void store_lanes(float* dst, const float* v) {
  if constexpr (kVec == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (kVec == 2)
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  else
    *dst = v[0];
}

struct PsArgs {
  const float* feat;   // [B, H, W, c_feat]
  const float* by;     // [B, N, ph, H]
  const float* bx;     // [B, N, pw, W]
  float* out;          // [B, N, ph, pw, c_out]
  int n_roi, h, w, c_feat, ph, pw, c_out, sp, su, sq;
};

constexpr int kPsThreads = 64;

// Shared memory: by's row (hi and lo), bx, then t [x span, pitch] from a
// 16-byte boundary; pitch is the lanes of t rounded up to kVec.
__host__ __device__ inline int ps_t_offset(int h, int pw, int w) {
  return (2 * h + pw * w + 3) & ~3;
}

template <int kMode, int kVec>
__global__ void __launch_bounds__(kPsThreads)
ps_roi_align_f32_kernel(const PsArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_span[4];        // y_lo, y_hi, x_lo, x_hi
  const int h = a.h, w = a.w, pw = a.pw, c_out = a.c_out;
  const int ol = c_out * pw;
  const int tl = a.sq ? ol : c_out;          // distinct lanes of t
  const int groups = (tl + kVec - 1) / kVec;
  const int pitch = groups * kVec;
  float* s_by = smem;              // [h] bin row p (hi part under "split")
  float* s_byl = s_by + h;         // [h] lo part, "split" only
  float* s_bx = s_byl + h;         // [pw, w]
  float* s_t = smem + ps_t_offset(h, pw, w);

  const int p = blockIdx.x % a.ph;
  const int roi = blockIdx.x / a.ph;  // b * n_roi + n
  const int b = roi / a.n_roi;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_span[0] = h;
    s_span[1] = -1;
    s_span[2] = w;
    s_span[3] = -1;
  }
  __syncthreads();
  const float* by_r = a.by + (static_cast<size_t>(roi) * a.ph + p) * h;
  const float* bx_r = a.bx + static_cast<size_t>(roi) * pw * w;
  for (int i = tid; i < h; i += blockDim.x) {
    const float v = by_r[i];
    if (kMode == kHighest) {
      s_by[i] = v;
    } else {
      const float hv = bf16_round(v);
      s_by[i] = hv;
      if (kMode == kSplit) s_byl[i] = bf16_round(__fsub_rn(v, hv));
    }
    if (v != 0.0f) {
      atomicMin(&s_span[0], i);
      atomicMax(&s_span[1], i);
    }
  }
  for (int i = tid; i < pw * w; i += blockDim.x) {
    const float v = bx_r[i];
    s_bx[i] = v;
    if (v != 0.0f) {
      atomicMin(&s_span[2], i % w);
      atomicMax(&s_span[3], i % w);
    }
  }
  __syncthreads();
  const int y_lo = s_span[0], y_hi = s_span[1], x_lo = s_span[2];
  const int nx = s_span[3] - x_lo + 1;   // <= 0 for an empty span

  // t[x, j] over the y span; lanes j0 .. j0 + kVec - 1 of one column
  const float* f_b = a.feat + static_cast<size_t>(b) * h * w * a.c_feat;
  const size_t row_stride = static_cast<size_t>(w) * a.c_feat;
  for (int e = tid; e < nx * groups; e += blockDim.x) {
    const int xi = e / groups, j0 = (e % groups) * kVec;
    const int chan = a.sq ? p * a.sp + (j0 / pw) * a.su + (j0 % pw) * a.sq
                          : p * a.sp + j0 * a.su;
    const float* f = f_b + static_cast<size_t>(x_lo + xi) * a.c_feat + chan;
    float a1[kVec] = {}, a2[kVec] = {}, a3[kVec] = {};
    for (int y = y_lo; y <= y_hi; ++y) {
      float v[kVec];
      load_lanes<kVec>(f + y * row_stride, v);
      const float wh = s_by[y], wl = kMode == kSplit ? s_byl[y] : 0.0f;
#pragma unroll
      for (int k = 0; k < kVec; ++k) add_h<kMode>(wh, wl, v[k], a1[k], a2[k],
                                                  a3[k]);
    }
    float r[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) r[k] = end_h<kMode>(a1[k], a2[k], a3[k]);
    store_lanes<kVec>(s_t + xi * pitch + j0, r);
  }
  __syncthreads();

  // out[q, u] over the x span, element k = q*c_out + u of the bin row
  float* out_r = a.out + (static_cast<size_t>(roi) * a.ph + p) * ol;
  for (int k = tid; k < ol; k += blockDim.x) {
    const int q = k / c_out, u = k % c_out;
    out_r[k] = sum_w<kMode>(s_t + (a.sq ? u * pw + q : u), pitch,
                            s_bx + q * w + x_lo, nx);
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

constexpr size_t kMaxSmem = 48 * 1024;       // without an opt-in
constexpr size_t kMaxSmemOptIn = 232448;     // 227 KB, an H100 block's most

template <int kMode, int kVec>
int launch_ps_as(const PsArgs& a, int grid, size_t smem, cudaStream_t st) {
  const auto kernel = ps_roi_align_f32_kernel<kMode, kVec>;
  if (smem > kMaxSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kPsThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_ps_mode(const PsArgs& a, int vec, int grid, size_t smem,
                   cudaStream_t st) {
  if (vec == 4) return launch_ps_as<kMode, 4>(a, grid, smem, st);
  if (vec == 2) return launch_ps_as<kMode, 2>(a, grid, smem, st);
  return launch_ps_as<kMode, 1>(a, grid, smem, st);
}

int launch_ps_f32(const void* feat, const void* by, const void* bx, void* out,
                  int batch, int n_roi, int h, int w, int c_feat, int ph,
                  int pw, int c_out, int sp, int su, int sq, int mode,
                  void* stream) {
  if (batch <= 0 || n_roi <= 0 || ph <= 0 || pw <= 0 || c_out <= 0
      || mode < kDefault || mode > kHighest
      || (ph - 1) * sp + (c_out - 1) * su + (pw - 1) * sq >= c_feat
      || static_cast<long long>(batch) * n_roi * ph > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int tl = sq ? c_out * pw : c_out;
  // the widest load a lane group can take: its lanes contiguous from a
  // 4 * vec byte boundary, the last group's extra lanes inside the pixel
  const bool contiguous = (sq == 1 && su == pw) || (sq == 0 && su == 1);
  int vec = 1;
  for (int v = 4; v > 1 && vec == 1; v /= 2)
    if (contiguous && sp % v == 0 && c_feat % v == 0
        && reinterpret_cast<uintptr_t>(feat) % (4 * v) == 0
        && (ph - 1) * sp + (tl + v - 1) / v * v <= c_feat)
      vec = v;
  const int pitch = (tl + vec - 1) / vec * vec;
  const size_t smem = sizeof(float)
      * (ps_t_offset(h, pw, w) + static_cast<size_t>(w) * pitch);
  if (smem > kMaxSmemOptIn) return cudaErrorInvalidValue;
  const PsArgs a{static_cast<const float*>(feat),
                 static_cast<const float*>(by),
                 static_cast<const float*>(bx), static_cast<float*>(out),
                 n_roi, h, w, c_feat, ph, pw, c_out, sp, su, sq};
  const int grid = batch * n_roi * ph;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kDefault)
    return launch_ps_mode<kDefault>(a, vec, grid, smem, st);
  if (mode == kSplit) return launch_ps_mode<kSplit>(a, vec, grid, smem, st);
  return launch_ps_mode<kHighest>(a, vec, grid, smem, st);
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
