// RoI crops of the fusion network: PS-RoIAlign over the padded score map
// (kernel K2) and RoIAlign over the radar score map (kernel K3).
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
// Design: one thread block per (image, RoI). The RoI's by and bx rows
// sit in shared memory; t for one bin row p (K2) or all bin rows (K3)
// is formed in shared memory, so it never reaches device memory (the
// TPU kernel kept it in VMEM for the same reason); the feature map is
// read from L2, where all RoIs of an image share it. K2 reads the
// 896-wide padded NHWC map directly (channel p*128 + u*Q + q) and only
// the C_out*Q useful lanes of each 128-lane block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kThreads)
ps_roi_align_kernel(const __nv_bfloat16* __restrict__ feat,
                    const __nv_bfloat16* __restrict__ by,
                    const __nv_bfloat16* __restrict__ bx,
                    float* __restrict__ out, int n_roi, int h, int w,
                    int c_pad, int ph, int pw, int c_out) {
  extern __shared__ float smem[];
  const int block = c_pad / ph;
  const int ol = c_out * pw;
  float* s_by = smem;              // [ph, h]
  float* s_bx = s_by + ph * h;     // [pw, w]
  float* s_t = s_bx + pw * w;      // [w, ol] for the current bin row

  const int roi = blockIdx.x;      // b * n_roi + n
  const int b = roi / n_roi;
  const __nv_bfloat16* by_r = by + static_cast<size_t>(roi) * ph * h;
  const __nv_bfloat16* bx_r = bx + static_cast<size_t>(roi) * pw * w;
  for (int i = threadIdx.x; i < ph * h; i += blockDim.x)
    s_by[i] = __bfloat162float(by_r[i]);
  for (int i = threadIdx.x; i < pw * w; i += blockDim.x)
    s_bx[i] = __bfloat162float(bx_r[i]);
  __syncthreads();

  const __nv_bfloat16* f_b = feat + static_cast<size_t>(b) * h * w * c_pad;
  float* out_r = out + static_cast<size_t>(roi) * ph * pw * c_out;
  const size_t row_stride = static_cast<size_t>(w) * c_pad;
  for (int p = 0; p < ph; ++p) {
    for (int e = threadIdx.x; e < w * ol; e += blockDim.x) {
      const int x = e / ol, j = e % ol;
      const __nv_bfloat16* f = f_b + static_cast<size_t>(x) * c_pad
                               + p * block + j;
      float acc = 0.0f;
      for (int y = 0; y < h; ++y)
        acc = fmaf(s_by[p * h + y], __bfloat162float(f[y * row_stride]), acc);
      s_t[e] = acc;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < ol; j += blockDim.x) {
      const int u = j / pw, q = j % pw;
      float acc = 0.0f;
      for (int x = 0; x < w; ++x)
        acc += bf16_round(__fmul_rn(s_t[x * ol + j], s_bx[q * w + x]));
      out_r[(p * pw + q) * c_out + u] = acc;
    }
    __syncthreads();
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

constexpr size_t kMaxSmem = 48 * 1024;  // no opt-in above the default

}  // namespace

extern "C" {

const char* millieye_cuda_error_name(int code) {
  return cudaGetErrorName(static_cast<cudaError_t>(code));
}

// feat [B, H, W, c_pad] bf16 (c_pad = ph * block), by [B, N, ph, H] bf16,
// bx [B, N, pw, W] bf16 -> out [B, N, ph, pw, c_out] f32.
int millieye_ps_roi_align(const void* feat, const void* by, const void* bx,
                          void* out, int batch, int n_roi, int h, int w,
                          int c_pad, int ph, int pw, int c_out,
                          void* stream) {
  if (batch <= 0 || n_roi <= 0 || ph <= 0 || c_pad % ph != 0
      || c_out * pw > c_pad / ph)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (ph * h + pw * w + w * c_out * pw);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  ps_roi_align_kernel<<<batch * n_roi, kThreads, smem,
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

}  // extern "C"
