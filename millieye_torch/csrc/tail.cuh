// The eval-mode tail of a convolution on one element, shared by kernel
// K14 (epilogue.cu: the tail as its own pass) and kernel K15 (conv.cu:
// the tail in the convolution's store). With c the element's channel,
//   batch-norm form: t = x - mean[c]; t = t * inv[c]; t = t * gamma[c];
//                    t = t + beta[c]
//   bias form:       t = x + bias[c]
// then the activation: linear y = t; leaky y = t > 0 ? t : t * slope;
// mish y = t * tanh(softplus(t)), softplus(t) = t > 20 ? t :
// log1p(exp(t)) (darknet's threshold, and F.softplus's).
//
// Each operation is an IEEE float operation with no contraction into an
// FMA (__fsub_rn, __fmul_rn, __fadd_rn), in the eager sequence's order
// (ops/epilogue.py:epilogue_eager), and for float16 and bfloat16 storage
// it is computed in float and rounded to the storage type after each
// operation, as ATen's elementwise kernels do; so the tail's bits are the
// eager sequence's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace tail_ops {

// storage type <-> float, and the rounding of a float result to the
// storage type (the identity for float32)
template <typename T> struct Store;

template <> struct Store<float> {
  static __device__ __forceinline__ float in(float v) { return v; }
  static __device__ __forceinline__ float out(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <> struct Store<__half> {
  static __device__ __forceinline__ float in(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half out(float v) {
    return __float2half_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __half2float(__float2half_rn(v));
  }
};

template <> struct Store<__nv_bfloat16> {
  static __device__ __forceinline__ float in(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 out(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// the activation codes (ops/epilogue.py:ACTS)
constexpr int kLinear = 0;
constexpr int kLeaky = 1;
constexpr int kMish = 2;

// the per-channel vectors of one channel, as floats
struct Chan {
  float bias, mean, inv, gamma;
};

// Mish as the eager sequence computes it: F.softplus (x itself above the
// threshold 20, else log1p(exp(x))), torch.tanh, then the product, each
// rounded to T
template <typename T>
__device__ __forceinline__ float mish(float t) {
  const float sp = Store<T>::round(t > 20.0f ? t : log1pf(expf(t)));
  const float th = Store<T>::round(tanhf(sp));
  return Store<T>::round(__fmul_rn(t, th));
}

// the eager sequence on one element, each operation rounded to T: the
// batch-norm form where `bn`, else the bias form; leaky's `slope` in T
template <typename T, int Act>
__device__ __forceinline__ float tail(bool bn, float slope, const Chan& k,
                                      float t) {
  if (bn) {
    t = Store<T>::round(__fsub_rn(t, k.mean));
    t = Store<T>::round(__fmul_rn(t, k.inv));
    t = Store<T>::round(__fmul_rn(t, k.gamma));
    t = Store<T>::round(__fadd_rn(t, k.bias));
  } else {
    t = Store<T>::round(__fadd_rn(t, k.bias));
  }
  if (Act == kLeaky && !(t > 0.0f))
    t = Store<T>::round(__fmul_rn(t, slope));
  if (Act == kMish) t = mish<T>(t);
  return t;
}

}  // namespace tail_ops
