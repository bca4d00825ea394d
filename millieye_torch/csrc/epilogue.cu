// Kernel K14: the eval-mode tail of a convolution, in one pass over its
// output. Per element, with c the element's channel,
//   batch-norm form: t = x - mean[c]; t = t * inv[c]; t = t * gamma[c];
//                    t = t + beta[c]
//   bias form:       t = x + bias[c]
// then the activation: linear y = t; leaky y = t > 0 ? t : t * slope;
// mish y = t * tanh(softplus(t)), softplus(t) = t > 20 ? t :
// log1p(exp(t)) (darknet's threshold, and F.softplus's).
//
// Replaces no TPU kernel: on the TPU, XLA fused this tail into the
// convolution's consumer. In eager PyTorch it was seven full-size passes
// over the convolution's output (the four batch-norm operations, then
// leaky ReLU's compare, product and select), ~58 bytes of memory traffic
// for each float32 element where one pass needs 8. The plain version is
// that eager sequence (ops/epilogue.py:epilogue_eager), and the kernel
// repeats its order and its roundings: each operation is an IEEE float
// operation with no contraction into an FMA (__fsub_rn, __fmul_rn,
// __fadd_rn), and for float16 and bfloat16 storage it is computed in
// float and rounded to the storage type after each operation, as
// ATen's elementwise kernels do. Mish is the eager sequence's three
// operations (F.softplus, torch.tanh, the product), each rounded to the
// storage type, with the CUDA math library's accurate expf, log1pf and
// tanhf, the functions ATen's softplus and tanh kernels call (no
// fast-math intrinsics). Where the eager result's dtype is wider than
// x's (a bfloat16 convolution with a float32 bias gives float32), x is
// read in its own type and upcast, which is exact, and every
// operation rounds to the result's type, as ATen's promoting kernels do;
// the wrapper hands the vectors over in the result's type and refuses a
// mix whose operations would round in two types. `inv` (rsqrt(var +
// eps)) and the slope (0.1 in the result's type) come from the wrapper,
// computed as the eager sequence computes them, so kernel and plain
// version are bit-equal. The tail itself is tail.cuh's, which K15 also
// applies in its store to the float32 convolutions whose activation is
// leaky or linear; the Mish tails and 16-bit outputs run here.
//
// Bound on an H100: bytes. A float32 element is read and written once,
// 8 bytes (4 for 16-bit types); the per-channel vectors are a few KB
// and stay in the read-only cache. Darknet-53 at 416 px, batch 8: 306 M
// elements a step over 75 convolutions, 2.45 GB, 0.73 ms at 3.35 TB/s.
// The arithmetic (at most 6 operations an element) is far below that.
// Mish adds expf, log1pf and tanhf, some tens of instructions an
// element: YOLOv4 at 608 px, batch 8, writes 758 M Mish elements a step,
// 6.1 GB, 1.8 ms at 3.35 TB/s (0.42 G elements a millisecond), while the
// H100's 33 T float32 instructions a second would take 60 an element for
// 0.56 G: the bytes still bound it, by less.
//
// Design: one elementwise pass, no shared memory. x and y are dense
// with the same layout; the channel of flat index i is
// (i / inner) % channels, inner being the product of the sizes after
// the channel axis: 1 for NHWC (the channels_last output of a
// convolution), H * W for NCHW. A grid-stride loop takes four
// consecutive elements at a time (one 16-byte load and store for
// float32, 8 bytes for 16-bit types) where the four share a row of
// channels or a channel (channels % 4 == 0 with inner 1, or inner % 4
// == 0) and the pointers are aligned; in NHWC the four channels'
// vectors then load as one aligned group each where their pointers
// allow. Elsewhere (C = 255 in NHWC, 13 x 13 in NCHW, an unaligned
// pointer) one element at a time. The activation is a template
// argument, so the linear and leaky instances are the code they were
// before Mish. Indices are 32-bit where no index the grid-stride loop
// forms (up to n plus one stride) reaches 2^32.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "tail.cuh"

namespace {

using tail_ops::Chan;
using tail_ops::kLeaky;
using tail_ops::kLinear;
using tail_ops::kMish;
using tail_ops::Store;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;      // 2048 resident threads an SM

// four consecutive values of T as one aligned access
template <typename T> struct alignas(4 * sizeof(T)) Four {
  T v[4];
};

template <typename T>
__device__ __forceinline__ void load4(const T* p, float out[4]) {
  const Four<T> f = *reinterpret_cast<const Four<T>*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = Store<T>::in(f.v[k]);
}

template <> __device__ __forceinline__ void load4<float>(const float* p,
                                                        float out[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float in[4]) {
  Four<T> f;
#pragma unroll
  for (int k = 0; k < 4; ++k) f.v[k] = Store<T>::out(in[k]);
  *reinterpret_cast<Four<T>*>(p) = f;
}

struct Args {
  const void* x;
  void* y;
  const void* bias;     // beta in the batch-norm form
  const void* mean;     // null in the bias form
  const void* inv;
  const void* gamma;
  int channels;
  float slope;          // leaky's
};

// the eager sequence on one element (tail.cuh), each operation rounded
// to T
template <typename T, int Act>
__device__ __forceinline__ float tail(const Args& a, const Chan& k,
                                      float t) {
  return tail_ops::tail<T, Act>(a.mean != nullptr, a.slope, k, t);
}

template <typename T>
__device__ __forceinline__ Chan chan(const Args& a, int c) {
  Chan k;
  k.bias = Store<T>::in(static_cast<const T*>(a.bias)[c]);
  if (a.mean) {
    k.mean = Store<T>::in(static_cast<const T*>(a.mean)[c]);
    k.inv = Store<T>::in(static_cast<const T*>(a.inv)[c]);
    k.gamma = Store<T>::in(static_cast<const T*>(a.gamma)[c]);
  }
  return k;
}

// x in Tin; y and the vectors in Tout. vec: four elements at a time (see
// the header); vec_chan: in NHWC, the four channels' vectors as aligned
// groups too
template <typename Tin, typename Tout, int Act, typename Idx>
__global__ void __launch_bounds__(kThreads)
epilogue_kernel(Args a, Idx n, Idx inner, bool vec, bool vec_chan) {
  const Tin* __restrict__ x = static_cast<const Tin*>(a.x);
  Tout* __restrict__ y = static_cast<Tout*>(a.y);
  const Idx channels = static_cast<Idx>(a.channels);
  const Idx stride = static_cast<Idx>(gridDim.x) * kThreads;
  const Idx first = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x;
  if (vec) {
    for (Idx g = first; g < n / 4; g += stride) {
      const Idx i = 4 * g;
      float t[4];
      load4(x + i, t);
      if (inner == 1) {
        const int c = static_cast<int>(i % channels);
        if (vec_chan) {
          float b[4], m[4] = {}, v[4] = {}, s[4] = {};
          load4(static_cast<const Tout*>(a.bias) + c, b);
          if (a.mean) {
            load4(static_cast<const Tout*>(a.mean) + c, m);
            load4(static_cast<const Tout*>(a.inv) + c, v);
            load4(static_cast<const Tout*>(a.gamma) + c, s);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
            t[k] = tail<Tout, Act>(a, Chan{b[k], m[k], v[k], s[k]}, t[k]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            t[k] = tail<Tout, Act>(a, chan<Tout>(a, c + k), t[k]);
        }
      } else {
        const Chan k = chan<Tout>(a, static_cast<int>((i / inner) % channels));
#pragma unroll
        for (int j = 0; j < 4; ++j) t[j] = tail<Tout, Act>(a, k, t[j]);
      }
      store4(y + i, t);
    }
    return;
  }
  for (Idx i = first; i < n; i += stride) {
    const int c = static_cast<int>((inner == 1 ? i : i / inner) % channels);
    y[i] = Store<Tout>::out(tail<Tout, Act>(a, chan<Tout>(a, c),
                                            Store<Tin>::in(x[i])));
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename Tin, typename Tout, int Act>
int launch(const Args& a, long long n, long long inner, cudaStream_t st) {
  const size_t group = 4 * sizeof(Tout);
  const bool vec = aligned(a.x, 4 * sizeof(Tin)) && aligned(a.y, group)
                   && (inner == 1 ? a.channels % 4 == 0 : inner % 4 == 0);
  const bool vec_chan =
      vec && inner == 1 && aligned(a.bias, group)
      && (!a.mean || (aligned(a.mean, group) && aligned(a.inv, group)
                      && aligned(a.gamma, group)));
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long work = vec ? n / 4 : n;
  const int blocks = static_cast<int>(std::max<long long>(1, std::min<
      long long>((work + kThreads - 1) / kThreads,
                 static_cast<long long>(sms) * kBlocksPerSm)));
  // the loops form indices up to n plus one stride
  if (n + static_cast<long long>(blocks) * kThreads < (1LL << 32))
    epilogue_kernel<Tin, Tout, Act, uint32_t><<<blocks, kThreads, 0, st>>>(
        a, static_cast<uint32_t>(n), static_cast<uint32_t>(inner), vec,
        vec_chan);
  else
    epilogue_kernel<Tin, Tout, Act, unsigned long long>
        <<<blocks, kThreads, 0, st>>>(
            a, static_cast<unsigned long long>(n),
            static_cast<unsigned long long>(inner), vec, vec_chan);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tout>
int launch_act(const Args& a, int act, long long n, long long inner,
               cudaStream_t st) {
  switch (act) {
    case kLinear: return launch<Tin, Tout, kLinear>(a, n, inner, st);
    case kLeaky: return launch<Tin, Tout, kLeaky>(a, n, inner, st);
    case kMish: return launch<Tin, Tout, kMish>(a, n, inner, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* millieye_cuda_error_name(int code) {
  return cudaGetErrorName(static_cast<cudaError_t>(code));
}

// x: n elements of in_dtype (0 float32, 1 float16, 2 bfloat16), y: n
// elements of out_dtype (in_dtype, or float32), both dense, the channel
// of element i being (i / inner) % channels; bias, mean, inv, gamma:
// [channels] of out_dtype, mean (and with it inv and gamma) null in the
// bias form; act: the activation after the affine step, 0 linear, 1
// LeakyReLU with `slope` (out_dtype's value as a float), 2 Mish.
int millieye_conv_epilogue(const void* x, void* y, const void* bias,
                           const void* mean, const void* inv,
                           const void* gamma, long long n, int channels,
                           long long inner, int in_dtype, int out_dtype,
                           int act, float slope, void* stream) {
  if (n <= 0 || channels <= 0 || inner <= 0 || n % (channels * inner) != 0
      || !bias || (mean && (!inv || !gamma)))
    return cudaErrorInvalidValue;
  const Args a{x, y, bias, mean, inv, gamma, channels, slope};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == out_dtype) {
    switch (in_dtype) {
      case 0: return launch_act<float, float>(a, act, n, inner, st);
      case 1: return launch_act<__half, __half>(a, act, n, inner, st);
      case 2:
        return launch_act<__nv_bfloat16, __nv_bfloat16>(a, act, n, inner,
                                                        st);
    }
  } else if (out_dtype == 0) {
    switch (in_dtype) {
      case 1: return launch_act<__half, float>(a, act, n, inner, st);
      case 2: return launch_act<__nv_bfloat16, float>(a, act, n, inner, st);
    }
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
