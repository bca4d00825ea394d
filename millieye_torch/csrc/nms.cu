// Greedy class-aware NMS keep mask: kernels K1 and K5, one device routine.
//
// Replaces: millieye_tpu/ops/nms_pallas.py:nms_keep_mask_pallas_blocked
// (K1, the block-sequential Pallas kernel, K % 128 == 0) and
// nms_keep_mask_pallas (K5, the whole-matrix kernel that iterates the
// suppression operator to its fixpoint, any K <= 1024). One contract for
// both: boxes [B, K, 4] float32, score-sorted and class-offset; valid
// [B, K] bool -> keep [B, K] bool, bit-equal to
// ops/nms.py:nms_keep_mask_ref. They compute one function, so both entry
// points launch the same routine; each keeps its kernel name and its
// wrapper its own launch count.
//
// Bound on an H100: neither bytes (valid and keep, 2 a row, and the box,
// 16 a row up to the last valid one) nor the IoUs (~14 float32
// operations each: 1.8 M at K = 512, 27 ns at 67 TFLOP/s). The greedy
// order is a chain of dependent keep decisions, one for each live row,
// and that chain sets the floor.
//
// Design:
// 1. Live rows only. A row after the last valid one (n_b = 1 + its
//    index) can neither be kept nor suppress a row, so both phases run
//    over rows < n_b and skip the invalid rows below it; rows at n_b or
//    beyond are written keep = 0. Exact for any valid mask. The boxes are
//    read with the valid bytes, all K rows in one round trip to memory
//    (16 bytes a row), since n_b is known only after that read.
// 2. The overlap bits over a thread block cluster. Up to 8 CTAs for an
//    image (``cluster_size``: batch x cluster stays within the SM count;
//    each size is a kernel instance with ``__cluster_dims__``, launched
//    with ``<<<>>>``, which cost the host less per call than
//    ``cudaLaunchKernelEx`` with a cluster attribute; a cluster the card
//    cannot place fails the launch, and the wrapper
//    raises) share the valid rows i < n_b, a warp a row, dealt in snake
//    order (which evens out the rows' lengths). For each word w >= i / 32, lane
//    l decides whether j = 32 w + l > i and IoU(i, j) > t, a ballot gives
//    the word, and lane 0 stores it into the leader CTA's bit matrix
//    through distributed shared memory: one store a word, so no store is
//    bank-conflicted. The IoU is the golden's float32 expression,
//    operation by operation (__f*_rn, built with -fmad=false). Where
//    inter == 0 and t >= 0 the bit is 0 without the division: 0 / d is
//    never above a non-negative t, whatever d is (0, negative or NaN).
//    With a negative t the division runs.
// 3. The scan, by one warp of the leader, in 32-row tiles. Lane l holds
//    word l of the removed set. For tile t, lane r loads row 32 t + r's
//    diagonal word once, and the tile's keep bits are the fixpoint of
//    kept = alive & ~OR{diagonal word of r : r kept}, one warp OR
//    reduction a round, from kept = alive; the bits are strictly upper
//    triangular, so the fixpoint is unique, is the greedy answer, and is
//    reached after at most 33 rounds (one more than the tile's longest
//    suppression chain; a chain of 32 integer steps, one a row, measured
//    slower on the serving and knife-edge inputs alike). Then the lanes
//    past t OR the tile's kept rows into their words: independent loads
//    of consecutive words, which pipeline. The greedy answer is the
//    unique fixpoint of the suppression operator, so the keep set is
//    both Pallas kernels'.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 1024;
constexpr int kThreads = 512;
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;

// Whether IoU(a, b) > thresh, as the reference's iou_matrix(boxes,
// boxes)[i, j] with a = box i, b = box j.
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float area_b, float thresh) {
  const float ix1 = fmaxf(a.x, b.x);
  const float iy1 = fmaxf(a.y, b.y);
  const float ix2 = fminf(a.z, b.z);
  const float iy2 = fminf(a.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(ix2, ix1), 0.0f),
                                fmaxf(__fsub_rn(iy2, iy1), 0.0f));
  if (inter == 0.0f && thresh >= 0.0f) return false;
  const float denom =
      __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-16f);
  return __fdiv_rn(inter, denom) > thresh;
}

// One image per cluster of gridDim.x / batch CTAs.
__device__ __forceinline__ void keep_mask(const float* __restrict__ boxes,
                                          const uint8_t* __restrict__ valid,
                                          uint8_t* __restrict__ keep, int k,
                                          float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.x / csize;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int words = (k + 31) >> 5, kp = 32 * words;
  float4* s_box = reinterpret_cast<float4*>(smem);              // [kp]
  float* s_area = reinterpret_cast<float*>(s_box + kp);         // [kp]
  uint32_t* s_live = reinterpret_cast<uint32_t*>(s_area + kp);  // [32]
  uint32_t* s_removed = s_live + 32;                            // [32]
  uint32_t* s_mask = s_removed + 32;          // [kp, words], the leader's
  uint32_t* mask = cluster.map_shared_rank(s_mask, 0);
  boxes += static_cast<size_t>(b) * k * 4;
  valid += static_cast<size_t>(b) * k;
  keep += static_cast<size_t>(b) * k;

  // the valid rows as bits, loaded with the boxes (one round trip to
  // memory); rows past k are invalid zero boxes
  for (int j = tid; j < kp; j += blockDim.x) {
    float4 bx = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    bool v = false;
    if (j < k) {
      const float* r = boxes + 4 * j;
      bx = make_float4(r[0], r[1], r[2], r[3]);
      v = valid[j] != 0;
    }
    const uint32_t bits = __ballot_sync(kFull, v);
    if (lane == 0) s_live[j >> 5] = bits;
    s_box[j] = bx;
    s_area[j] = __fmul_rn(__fsub_rn(bx.z, bx.x), __fsub_rn(bx.w, bx.y));
  }
  // also: every CTA of the cluster has started before any store into the
  // leader's shared memory
  cluster.sync();
  int nb = 0;
  for (int w = words - 1; w >= 0; --w) {
    if (s_live[w]) {
      nb = 32 * w + 32 - __clz(s_live[w]);
      break;
    }
  }
  const int wl = (nb + 31) >> 5;

  // phase 1: a warp a valid row i < n_b, its words w >= i / 32 in turn;
  // rows go to the cluster's warps in snake order, which evens out the
  // rows' lengths
  const int cw = csize * nwarps, g = rank * nwarps + warp;
  for (int m = 0;; ++m) {
    const int i = m * cw + ((m & 1) ? cw - 1 - g : g);
    if (i >= nb) break;
    if (!((s_live[i >> 5] >> (i & 31)) & 1u)) continue;
    const float4 bi = s_box[i];
    const float ai = s_area[i];
    uint32_t* out = mask + i * words;
    int w = i >> 5;
    for (; w < wl; ++w) {
      const int j = 32 * w + lane;
      const bool hit = j > i && overlaps(bi, ai, s_box[j], s_area[j], thresh);
      const uint32_t bits = __ballot_sync(kFull, hit);
      if (lane == 0) out[w] = bits;
    }
  }
  cluster.sync();
  if (rank != 0) return;

  // phase 2: the greedy scan in 32-row tiles by warp 0 of the leader. A
  // row's words are read only where the row is alive: the words of
  // invalid rows and of rows past n_b were never written.
  if (warp == 0) {
    uint32_t removed = lane < wl ? ~s_live[lane] : kFull;
    for (int t = 0; t < wl; ++t) {
      const int r0 = 32 * t;
      const uint32_t alive = ~__shfl_sync(kFull, removed, t);
      const uint32_t d = s_mask[(r0 + lane) * words + t];
      uint32_t kept = alive;
      for (;;) {
        const uint32_t hit =
            __reduce_or_sync(kFull, ((kept >> lane) & 1u) ? d : 0u);
        const uint32_t next = alive & ~hit;
        if (next == kept) break;
        kept = next;
      }
      if (lane == t) removed = ~kept;
      if (lane > t && lane < wl) {
        uint32_t acc = 0;
#pragma unroll
        for (int r = 0; r < 32; ++r)
          acc |= s_mask[(r0 + r) * words + lane] & (0u - ((kept >> r) & 1u));
        removed |= acc;
      }
    }
    s_removed[lane] = removed;
  }
  __syncthreads();
  for (int j = tid; j < k; j += blockDim.x)
    keep[j] = static_cast<uint8_t>(!((s_removed[j >> 5] >> (j & 31)) & 1u));
}

// K1 and K5: one routine under two names, so that a profile tells them
// apart; one instance for each cluster size.
template <int C>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(kThreads)
nms_keep_kernel(const float* __restrict__ boxes,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int k, float thresh) {
  keep_mask(boxes, valid, keep, k, thresh);
}

template <int C>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(kThreads)
nms_full_kernel(const float* __restrict__ boxes,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int k, float thresh) {
  keep_mask(boxes, valid, keep, k, thresh);
}

using Kernel = void (*)(const float*, const uint8_t*, uint8_t*, int, float);

// [entry point][log2 of the cluster size]
constexpr Kernel kKernels[2][4] = {
    {nms_keep_kernel<1>, nms_keep_kernel<2>, nms_keep_kernel<4>,
     nms_keep_kernel<8>},
    {nms_full_kernel<1>, nms_full_kernel<2>, nms_full_kernel<4>,
     nms_full_kernel<8>}};

size_t smem_bytes(int k) {
  const size_t words = (k + 31) / 32, kp = 32 * words;
  return kp * (16 + 4) + 64 * sizeof(uint32_t)
         + kp * words * sizeof(uint32_t);
}

// The SM count of each device, read (and every kernel opted in to K's
// largest shared memory) at its first launch.
constexpr int kMaxDevices = 16;
int g_sms[kMaxDevices] = {};

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    for (const auto& row : kKernels)
      for (Kernel kernel : row) {
        rc = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem_bytes(kMaxK)));
        if (rc != cudaSuccess) return rc;
      }
    rc = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                dev);
    if (rc != cudaSuccess) return rc;
  }
  *sms = g_sms[dev];
  return cudaSuccess;
}

// CTAs an image: the largest power of two <= 8 with batch x it within the
// SM count (one CTA an image from 67 images on an H100's 132 SMs).
int cluster_size(int sms, int batch) {
  int c = kMaxCluster;
  while (c > 1 && static_cast<long long>(batch) * c > sms) c >>= 1;
  return c;
}

int launch(int entry, const void* boxes, const void* valid, void* keep,
           int batch, int k, float thresh, void* stream) {
  if (batch <= 0 || k <= 0 || k > kMaxK) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t rc = sm_count(&sms);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int c = cluster_size(sms, batch);
  const Kernel kernel = kKernels[entry][__builtin_ctz(c)];
  kernel<<<batch * c, kThreads, smem_bytes(k),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thresh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* millieye_cuda_error_name(int code) {
  return cudaGetErrorName(static_cast<cudaError_t>(code));
}

// boxes [batch, k, 4] f32, valid/keep [batch, k] one byte each (kernel
// K1; the wrapper asks k % 128 == 0).
int millieye_nms_keep_mask(const void* boxes, const void* valid, void* keep,
                           int batch, int k, float thresh, void* stream) {
  return launch(0, boxes, valid, keep, batch, k, thresh,
                stream);
}

// The same for any k <= 1024 (kernel K5).
int millieye_nms_keep_mask_full(const void* boxes, const void* valid,
                                void* keep, int batch, int k, float thresh,
                                void* stream) {
  return launch(1, boxes, valid, keep, batch, k, thresh,
                stream);
}

// The CTAs an image that a launch at (batch, k) takes; 0 on an error.
int millieye_nms_cluster_size(int batch, int k) {
  int sms = 0;
  if (batch <= 0 || k <= 0 || k > kMaxK || sm_count(&sms) != cudaSuccess)
    return 0;
  return cluster_size(sms, batch);
}

}  // extern "C"
