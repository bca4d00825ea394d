// RoI crops of the fusion networks: PS-RoIAlign over the padded score map
// (kernel K2) with bf16 operands, and, in the second half of this file,
// the float32-operand kernels with the precision ladder: PS-RoIAlign over
// the unpadded map (K6) and over the padded map (K7); then RoIAlign over
// the radar score map (kernel K3) on bf16 or float32 operands.
//
// Replaces: millieye_tpu/ops/roi_pallas.py:ps_roi_align_pallas_padded_g1
// (K2, reduce="dot", precision="default") and
// millieye_tpu/ops/roi_pallas.py:roi_align_pallas with pack_p=True (K3,
// at every precision).
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
// K3's design (both operand types) comes after the precision ladder.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

// ---------------------------------------------------------------------
// Float32-operand crops with the precision ladder (kernels K6 and K7;
// K3, below, sums under the same ladder).
//
// Replaces: millieye_tpu/ops/roi_pallas.py:_launch as reached from
// ps_roi_align_pallas (channel orders "upq" and "puq") and from
// roi_align_pallas(pack_p=False) (K6); ps_roi_align_pallas_padded, the
// padded map on a (batch, bin-row) grid (K7).
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// by's values under the ladder: hi (and lo under "split") parts
template <int kMode, typename T>
__device__ __forceinline__ void load_by(const T* __restrict__ src,
                                        float* hi, float* lo, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = to_f32(src[i]);
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

// kRoiChains outputs of the w-sum at once, one thread: out[q * ostride]
// for the rows q = q0, q0 + dq, ... (below nq) of bx [nq][w], each
// summed as sum_w sums it, over the span [span[2q], span[2q + 1]] of
// its row's nonzero entries (t holds the columns from x_lo on).
constexpr int kRoiChains = 3;

template <int kMode>
__device__ __forceinline__ void sum_w_chains(const float* t, int stride,
                                             const float* bx, int w,
                                             const int* span, int x_lo,
                                             int q0, int dq, int nq,
                                             float* out, int ostride) {
  float a1[kRoiChains] = {}, a2[kRoiChains] = {};
  const float* tq[kRoiChains];
  const float* bq[kRoiChains];
  int len[kRoiChains], n = 0;
#pragma unroll
  for (int j = 0; j < kRoiChains; ++j) {
    const int q = q0 + j * dq, qq = q < nq ? q : 0;
    const int lo = span[2 * qq], hi = span[2 * qq + 1];
    len[j] = q < nq && hi >= lo ? hi - lo + 1 : 0;
    tq[j] = t + (lo - x_lo) * stride;
    bq[j] = bx + qq * w + lo;
    n = max(n, len[j]);
  }
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j < kRoiChains; ++j) {
      if (i >= len[j]) continue;
      const float prod = __fmul_rn(tq[j][i * stride], bq[j][i]);
      if (kMode == kHighest) {
        a1[j] = __fadd_rn(a1[j], prod);
      } else {
        const float hv = bf16_round(prod);
        a1[j] = __fadd_rn(a1[j], hv);
        if (kMode == kSplit)
          a2[j] = __fadd_rn(a2[j], bf16_round(__fsub_rn(prod, hv)));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRoiChains; ++j)
    if (q0 + j * dq < nq)
      out[(q0 + j * dq) * ostride] =
          kMode == kSplit ? __fadd_rn(a1[j], a2[j]) : a1[j];
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

// ---------------------------------------------------------------------
// Kernel K3: RoIAlign of the radar score map,
//   out[b, n, p, q, c] = sum_x g(t[p, x, c] * bx[b, n, q, x]),
//   t[p, x, c]         = sum_y by[b, n, p, y] * F[b, y, x, c],
// features [B, H, W, C] -> [B, N, ph, pw, C] float32, on bf16 operands
// (millieye_roi_align: the ladder's "default" rung on values that are
// bf16 already, so its roundings of F and by are exact) or float32 ones
// at "split" and "highest" (millieye_roi_align_f32).
//
// Replaces: millieye_tpu/ops/roi_pallas.py:roi_align_pallas with
// pack_p=True (_roi_kernel_radar_packed), all bin rows in one pass.
//
// Bound on an H100: bytes. At the serving shape (26 x 26 x 10 map, 7x7
// bins) an image's map is 13.5 KB in bf16, by and bx 728 B a RoI and the
// output 1,960 B a RoI: at b32, N = 232 the function must move 20.4 MB
// (0.0061 ms at 3.35 TB/s) against some 0.1 GFLOP of products on the
// nonzero support.
//
// Design. The map is small enough for shared memory (13.5 KB in bf16,
// 27 KB in float32), so a block serves a group of RoIs of one image and
// copies that image's map once, by 16-byte cp.async, with the group's by
// and bx. A warp a row then finds the span of nonzero entries of every
// row of by and bx (one ballot per 32 entries) into shared memory. A
// warp takes one (RoI, bin row p) at a time and sums only over the
// spans, in ascending order, as K2, K6 and K7 do:
//  - t over the span of nonzero by[p, :], for the columns of the union
//    of the bin columns' spans: lane e of t is (column x_lo + e / C,
//    channel e % C), whose map reads are consecutive in shared memory,
//    kRoiChains lanes a thread at once; t goes to the warp's own slice
//    of shared memory;
//  - output (q, c) over the span of nonzero bx[q, :] alone, not the
//    union the other crop kernels take: a bin column's bilinear taps
//    cover 2-5 map columns, a whole-frame RoI's union all 26. A lane is
//    (channel, group of bin columns) and sums kRoiChains bin columns at
//    once (10 channels x 3 groups: 30 of 32 lanes at 7x7 bins); its
//    stores of a bin row are one contiguous run with the other lanes'.
// The terms left out are exact zeros, so the result is the full sum bit
// for bit (see K6's note); the bf16 plain version takes the same spans,
// the float32 one the union of the bin columns' spans. A block has
// kRoiWarpsPerRow warps per bin row (14 at 7x7 bins, at most 32), so a
// group's items split evenly, and the group makes the grid about
// kRoiBlocksPerSm blocks an SM (at least one RoI, at most kRoiMaxGroup):
// at b1 a RoI a block, at b32 29 RoIs (N = 232) or 12 (N = 96); a map
// too large for that block's shared memory gets one RoI and one warp a
// block. Picked on an H100 among (warps a bin row, blocks an SM) = (1,
// 16), (4, 1), (2, 2) and (4, 2): all within 6% of each other at b32
// (bf16, N = 232: 0.046-0.049 ms of device time), (2, 2) the fastest
// there and within 5% of the best at N = 96; at b1 all take 0.004-0.005
// ms. So the map copy a block is not what bounds K3: without its two
// sums the kernel took 0.015 ms, the w-sum 0.020 and t 0.010 of the rest
// (random RoIs, b32, N = 232, one warp a bin row).
constexpr int kRoiBlocksPerSm = 2;
constexpr int kRoiMaxGroup = 64;
constexpr int kRoiWarpsPerRow = 2;

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Shared memory of K3's block: the map, then by (hi, and lo under
// "split") and bx of the group, then t, one slice of w * c a warp, then
// the nonzero span of each row of by and bx.
__host__ __device__ inline size_t k3_smem_bytes(int h, int w, int c, int ph,
                                                int pw, int group, int warps,
                                                int mode, int elem) {
  return align16(static_cast<size_t>(h) * w * c * elem)
         + sizeof(float) * static_cast<size_t>(group)
               * ((mode == kSplit ? 2 : 1) * ph * h + pw * w)
         + sizeof(float) * static_cast<size_t>(warps) * w * c
         + 2 * sizeof(int) * static_cast<size_t>(group) * (ph + pw);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy into shared memory
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

// The span [lo, hi] of the indices i < n where v[i] is nonzero (lo = n,
// hi = -1 where none is), one ballot per 32 entries; every lane of the
// warp calls it and gets the answer.
__device__ __forceinline__ void warp_span(const float* v, int n, int& lo,
                                          int& hi) {
  const int lane = threadIdx.x & 31;
  lo = n;
  hi = -1;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const unsigned m = __ballot_sync(0xffffffffu,
                                     i0 + lane < n && v[i0 + lane] != 0.0f);
    if (m) {
      lo = min(lo, i0 + __ffs(m) - 1);
      hi = i0 + 31 - __clz(m);
    }
  }
}

template <int kMode, typename T>
__global__ void __launch_bounds__(1024)
roi_align_kernel(const T* __restrict__ feat, const T* __restrict__ by,
                 const T* __restrict__ bx, float* __restrict__ out,
                 int n_roi, int h, int w, int c, int ph, int pw, int group,
                 int vec) {
  extern __shared__ __align__(16) unsigned char rsmem[];
  const int hwc = h * w * c;
  const T* s_map = reinterpret_cast<const T*>(rsmem);       // [h][w][c]
  float* s_by = reinterpret_cast<float*>(
      rsmem + align16(static_cast<size_t>(hwc) * sizeof(T)));  // [g][ph][h]
  float* s_byl = s_by + group * ph * h;         // lo parts, "split" only
  float* s_bx = s_byl + (kMode == kSplit ? group * ph * h : 0);  // [g][pw][w]
  float* s_t = s_bx + group * pw * w;           // [warps][w * c]
  int* s_span = reinterpret_cast<int*>(
      s_t + (blockDim.x >> 5) * w * c);         // [g][ph + pw][2]

  const int per_img = (n_roi + group - 1) / group;
  const int b = blockIdx.x / per_img;
  const int r0 = (blockIdx.x % per_img) * group;
  const int nr = min(group, n_roi - r0);
  const size_t roi0 = static_cast<size_t>(b) * n_roi + r0;
  const T* f_b = feat + static_cast<size_t>(b) * hwc;
  if (vec) {
    const int chunks = static_cast<int>(hwc * sizeof(T) / 16);
    for (int i = threadIdx.x; i < chunks; i += blockDim.x)
      cp_async16(rsmem + 16 * i,
                 reinterpret_cast<const unsigned char*>(f_b) + 16 * i);
  } else {
    T* dst = reinterpret_cast<T*>(rsmem);
    for (int i = threadIdx.x; i < hwc; i += blockDim.x) dst[i] = f_b[i];
  }
  load_by<kMode>(by + roi0 * ph * h, s_by, s_byl, nr * ph * h);
  const T* bx_g = bx + roi0 * pw * w;
  for (int i = threadIdx.x; i < nr * pw * w; i += blockDim.x)
    s_bx[i] = to_f32(bx_g[i]);
  cp_async_wait_all();
  __syncthreads();

  // the nonzero span of each row: by rows (r, p) first, then bx rows
  // (r, q), a warp a row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5, rows_y = nr * ph;
  for (int row = warp; row < rows_y + nr * pw; row += warps) {
    int lo, hi;
    if (row < rows_y)
      warp_span(s_by + row * h, h, lo, hi);
    else
      warp_span(s_bx + (row - rows_y) * w, w, lo, hi);
    if (lane == 0) {
      s_span[2 * row] = lo;
      s_span[2 * row + 1] = hi;
    }
  }
  __syncthreads();

  float* t = s_t + warp * w * c;
  // the output's lanes: (channel ch, bin-column group qg), each summing
  // the bin columns qg, qg + nqg, ... kRoiChains at a time
  const int lc = c < 32 ? c : 32, nqg = 32 / lc;
  const int ch0 = lane % lc, qg = lane / lc;
  for (int item = warp; item < rows_y; item += warps) {
    const int r = item / ph, p = item % ph;
    const float* byh = s_by + item * h;
    const float* byl = s_byl + item * h;
    const float* bxr = s_bx + r * pw * w;
    const int* qspan = s_span + 2 * (rows_y + r * pw);
    const int y_lo = s_span[2 * item], y_hi = s_span[2 * item + 1];
    // t's columns: the union of the bin columns' spans
    int x_lo = w, x_hi = -1;
    for (int q = lane; q < pw; q += 32) {
      x_lo = min(x_lo, qspan[2 * q]);
      x_hi = max(x_hi, qspan[2 * q + 1]);
    }
    x_lo = __reduce_min_sync(0xffffffffu, x_lo);
    x_hi = __reduce_max_sync(0xffffffffu, x_hi);
    const int nx = x_hi - x_lo + 1;         // <= 0 for an empty span
    // t[x_lo + e / c, e % c] over the y span, kRoiChains lanes of t a
    // thread at once, each from +0 in ascending y
    const T* m0 = s_map + x_lo * c;
    for (int e0 = lane; e0 < nx * c; e0 += 32 * kRoiChains) {
      float a1[kRoiChains] = {}, a2[kRoiChains] = {}, a3[kRoiChains] = {};
      for (int y = y_lo; y <= y_hi; ++y) {
        const float wh = byh[y], wl = kMode == kSplit ? byl[y] : 0.0f;
        const T* my = m0 + y * w * c;
#pragma unroll
        for (int j = 0; j < kRoiChains; ++j) {
          const float v = to_f32(my[min(e0 + 32 * j, nx * c - 1)]);
          if (kMode == kDefault && sizeof(T) == 2)
            a1[j] = fmaf(wh, v, a1[j]);     // bf16 already: no rounding
          else
            add_h<kMode>(wh, wl, v, a1[j], a2[j], a3[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kRoiChains; ++j)
        if (e0 + 32 * j < nx * c)
          t[e0 + 32 * j] = end_h<kMode>(a1[j], a2[j], a3[j]);
    }
    __syncwarp();
    // out[q, ch] over the span of bx[q, :], at element q * c + ch
    float* o = out + ((roi0 + r) * ph + p) * pw * c;
    if (qg < nqg)
      for (int ch = ch0; ch < c; ch += lc)
        for (int q0 = qg; q0 < pw; q0 += kRoiChains * nqg)
          sum_w_chains<kMode>(t + ch, c, bxr, w, qspan, x_lo, q0, nqg, pw,
                              o + ch, c);
    __syncwarp();                           // t is free for the next item
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

// K3's RoIs a block: about kRoiBlocksPerSm blocks an SM over the card's
// SMs, at least 1 and at most kRoiMaxGroup (and n_roi); 0 on an error.
int k3_group(int batch, int n_roi) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess || sms <= 0)
    return 0;
  const long long rois = static_cast<long long>(batch) * n_roi;
  const long long want = static_cast<long long>(kRoiBlocksPerSm) * sms;
  long long g = (rois + want - 1) / want;
  g = g < 1 ? 1 : (g > kRoiMaxGroup ? kRoiMaxGroup : g);
  return static_cast<int>(g < n_roi ? g : n_roi);
}

template <int kMode, typename T>
int launch_k3(const void* feat, const void* by, const void* bx, void* out,
              int batch, int n_roi, int h, int w, int c, int ph, int pw,
              void* stream) {
  if (batch <= 0 || n_roi <= 0 || h <= 0 || w <= 0 || c <= 0 || ph <= 0
      || pw <= 0)
    return cudaErrorInvalidValue;
  int group = k3_group(batch, n_roi);
  if (group == 0) return cudaErrorInvalidDevice;
  int warps = ph * kRoiWarpsPerRow < 32 ? ph * kRoiWarpsPerRow : 32;
  size_t smem = k3_smem_bytes(h, w, c, ph, pw, group, warps, kMode,
                              sizeof(T));
  if (smem > kMaxSmemOptIn) {   // a map too large for that: the least block
    group = warps = 1;
    smem = k3_smem_bytes(h, w, c, ph, pw, 1, 1, kMode, sizeof(T));
  }
  const long long grid = static_cast<long long>(batch)
                         * ((n_roi + group - 1) / group);
  if (smem > kMaxSmemOptIn || grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const auto kernel = roi_align_kernel<kMode, T>;
  if (smem > kMaxSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // the map in 16-byte copies where each image's map is 16-byte aligned
  const int vec = reinterpret_cast<uintptr_t>(feat) % 16 == 0
                  && (static_cast<size_t>(h) * w * c * sizeof(T)) % 16 == 0;
  kernel<<<static_cast<int>(grid), 32 * warps, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feat), static_cast<const T*>(by),
      static_cast<const T*>(bx), static_cast<float*>(out), n_roi, h, w, c,
      ph, pw, group, vec);
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

// Kernel K3. feat [B, H, W, C] bf16, by [B, N, ph, H] bf16, bx
// [B, N, pw, W] bf16 -> out [B, N, ph, pw, C] f32.
int millieye_roi_align(const void* feat, const void* by, const void* bx,
                       void* out, int batch, int n_roi, int h, int w, int c,
                       int ph, int pw, void* stream) {
  return launch_k3<kDefault, __nv_bfloat16>(feat, by, bx, out, batch, n_roi,
                                            h, w, c, ph, pw, stream);
}

// The RoIs one block of K3 takes at this batch and RoI count on the
// current card; 0 on an error.
int millieye_roi_align_group(int batch, int n_roi) {
  return batch > 0 && n_roi > 0 ? k3_group(batch, n_roi) : 0;
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
  if (mode == kSplit)
    return launch_k3<kSplit, float>(feat, by, bx, out, batch, n_roi, h, w, c,
                                    ph, pw, stream);
  if (mode == kHighest)
    return launch_k3<kHighest, float>(feat, by, bx, out, batch, n_roi, h, w,
                                      c, ph, pw, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
