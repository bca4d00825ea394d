// Greedy class-aware NMS keep mask: the rank-ordered kernel K1 and the
// whole-matrix kernel K5 (second half of this file).
//
// Replaces: millieye_tpu/ops/nms_pallas.py:nms_keep_mask_pallas_blocked
// (the block-sequential Pallas kernel), with the same contract: boxes
// [B, K, 4] float32, score-sorted and class-offset; valid [B, K] bool ->
// keep [B, K] bool, bit-equal to ops/nms.py:nms_keep_mask_ref.
//
// Bound on an H100: at the serving point (K = 128) the inputs and
// outputs are a few KB, so neither bytes (16*K+2*K per image at
// 3.35 TB/s) nor operations (K^2/2 IoUs) bound it: it is bound by the
// K dependent steps of the greedy order, each a __syncthreads.
//
// Design: one thread block per image, one thread per candidate row. The
// boxes and a live flag sit in shared memory. For rank i in order, if
// row i is still alive, every thread j > i clears its own flag when
// IoU(i, j) > t; a barrier ends the step. Row i's flag is final when
// step i begins, since only rows < i can clear it. The IoU is computed
// elementwise in float32 in the reference's expression order, with
// explicitly rounded intrinsics (and the file built with -fmad=false),
// so no product is fused into an FMA and every keep bit matches.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 1024;

__global__ void nms_keep_kernel(const float* __restrict__ boxes,
                                const uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ keep, int k,
                                float thresh) {
  __shared__ float s_x1[kMaxK], s_y1[kMaxK], s_x2[kMaxK], s_y2[kMaxK];
  __shared__ float s_area[kMaxK];
  __shared__ int s_alive[kMaxK];

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const float* row = boxes + (static_cast<size_t>(b) * k + j) * 4;
  const float x1 = row[0], y1 = row[1], x2 = row[2], y2 = row[3];
  const float area = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
  s_x1[j] = x1;
  s_y1[j] = y1;
  s_x2[j] = x2;
  s_y2[j] = y2;
  s_area[j] = area;
  s_alive[j] = valid[static_cast<size_t>(b) * k + j] != 0;
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    if (s_alive[i] && j > i && s_alive[j]) {
      // iou(row i, row j): a = box i, b = box j, as the reference's
      // iou_matrix(boxes, boxes)[i, j]
      const float ix1 = fmaxf(s_x1[i], x1);
      const float iy1 = fmaxf(s_y1[i], y1);
      const float ix2 = fminf(s_x2[i], x2);
      const float iy2 = fminf(s_y2[i], y2);
      const float inter = __fmul_rn(fmaxf(__fsub_rn(ix2, ix1), 0.0f),
                                    fmaxf(__fsub_rn(iy2, iy1), 0.0f));
      const float denom = __fadd_rn(
          __fsub_rn(__fadd_rn(s_area[i], area), inter), 1e-16f);
      if (__fdiv_rn(inter, denom) > thresh) s_alive[j] = 0;
    }
    __syncthreads();
  }
  keep[static_cast<size_t>(b) * k + j] = static_cast<uint8_t>(s_alive[j]);
}

// ---------------------------------------------------------------------
// Kernel K5: the keep mask through the whole K x K overlap matrix.
//
// Replaces: millieye_tpu/ops/nms_pallas.py:nms_keep_mask_pallas (the
// one-shot Pallas kernel that holds the [K, K] IoU matrix on chip and
// iterates the suppression operator to its fixpoint), same contract as
// K1 but for any K <= 1024, no multiple of 128 needed.
//
// Bound on an H100: neither bytes (18 per row) nor the K^2/2 float32 IoUs
// (~14 operations each: 1.8 M at K = 512, 27 ns at 67 TFLOP/s); the
// rank-order dependency of the greedy scan sets the time.
//
// Design: one thread block per image, two phases. Phase 1 fills the
// overlap matrix as bits in shared memory: word (i, w) holds, for the 32
// rows j = 32 w .. 32 w + 31, whether j > i and IoU(i, j) > t. All
// threads share the (w, i) pairs, neighbouring threads on neighbouring
// i, so box j is a broadcast read; the IoU is the golden's float32
// expression, operation by operation (__f*_rn, -fmad=false). Phase 2 is
// the greedy scan by one warp without a barrier: lane l keeps word l of
// the `removed` set in a register; for each rank i in order the word
// that holds bit i is shuffled to all lanes, and if row i is alive its
// matrix row is OR-ed into `removed`. The unique fixpoint of the
// suppression operator is this greedy answer, so the keep set equals the
// Pallas kernel's. K = 512 needs 42 KB of shared memory, K = 1024 148 KB
// (dynamic shared memory, opted in above 48 KB).
constexpr int kFullThreads = 512;

__global__ void __launch_bounds__(kFullThreads)
nms_full_kernel(const float* __restrict__ boxes,
                const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep, int k, float thresh) {
  extern __shared__ float fsmem[];
  const int words = (k + 31) / 32;
  const int kp = words * 32;
  float* s_x1 = fsmem;
  float* s_y1 = s_x1 + kp;
  float* s_x2 = s_y1 + kp;
  float* s_y2 = s_x2 + kp;
  float* s_area = s_y2 + kp;
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(s_area + kp);  // [k, words]
  uint32_t* s_removed = s_mask + static_cast<size_t>(k) * words;  // [32]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int j = tid; j < kp; j += blockDim.x) {
    float x1 = 0.0f, y1 = 0.0f, x2 = 0.0f, y2 = 0.0f;
    if (j < k) {
      const float* row = boxes + (static_cast<size_t>(b) * k + j) * 4;
      x1 = row[0], y1 = row[1], x2 = row[2], y2 = row[3];
    }
    s_x1[j] = x1;
    s_y1[j] = y1;
    s_x2[j] = x2;
    s_y2[j] = y2;
    s_area[j] = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
  }
  __syncthreads();

  // phase 1: overlap bits; pair index = w * k + i
  for (int e = tid; e < words * k; e += blockDim.x) {
    const int w = e / k, i = e % k;
    uint32_t bits = 0;
    if (32 * w + 31 > i) {
      const float x1 = s_x1[i], y1 = s_y1[i], x2 = s_x2[i], y2 = s_y2[i];
      const float area = s_area[i];
      for (int l = 0; l < 32; ++l) {
        const int j = 32 * w + l;
        if (j <= i || j >= k) continue;
        // iou(row i, row j) as the reference's iou_matrix(boxes, boxes)[i, j]
        const float ix1 = fmaxf(x1, s_x1[j]);
        const float iy1 = fmaxf(y1, s_y1[j]);
        const float ix2 = fminf(x2, s_x2[j]);
        const float iy2 = fminf(y2, s_y2[j]);
        const float inter = __fmul_rn(fmaxf(__fsub_rn(ix2, ix1), 0.0f),
                                      fmaxf(__fsub_rn(iy2, iy1), 0.0f));
        const float denom = __fadd_rn(
            __fsub_rn(__fadd_rn(area, s_area[j]), inter), 1e-16f);
        if (__fdiv_rn(inter, denom) > thresh) bits |= 1u << l;
      }
    }
    s_mask[static_cast<size_t>(i) * words + w] = bits;
  }
  __syncthreads();

  // phase 2: greedy scan in rank order by warp 0
  if (tid < 32) {
    const int lane = tid;
    uint32_t removed = 0xffffffffu;      // rows past k and invalid rows
    if (lane < words) {
      removed = 0;
      for (int l = 0; l < 32; ++l) {
        const int j = 32 * lane + l;
        if (j >= k || valid[static_cast<size_t>(b) * k + j] == 0)
          removed |= 1u << l;
      }
    }
    for (int i = 0; i < k; ++i) {
      const uint32_t word = __shfl_sync(0xffffffffu, removed, i >> 5);
      if (!((word >> (i & 31)) & 1u) && lane < words)
        removed |= s_mask[static_cast<size_t>(i) * words + lane];
    }
    s_removed[lane] = removed;
  }
  __syncthreads();
  for (int j = tid; j < k; j += blockDim.x)
    keep[static_cast<size_t>(b) * k + j] =
        static_cast<uint8_t>(!((s_removed[j >> 5] >> (j & 31)) & 1u));
}

}  // namespace

extern "C" {

const char* millieye_cuda_error_name(int code) {
  return cudaGetErrorName(static_cast<cudaError_t>(code));
}

// boxes [batch, k, 4] f32, valid/keep [batch, k] one byte each.
int millieye_nms_keep_mask(const void* boxes, const void* valid, void* keep,
                           int batch, int k, float thresh, void* stream) {
  if (batch <= 0 || k <= 0 || k > kMaxK) return cudaErrorInvalidValue;
  nms_keep_kernel<<<batch, k, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thresh);
  return static_cast<int>(cudaGetLastError());
}

// boxes [batch, k, 4] f32, valid/keep [batch, k] one byte each; any
// k <= 1024 (kernel K5).
int millieye_nms_keep_mask_full(const void* boxes, const void* valid,
                                void* keep, int batch, int k, float thresh,
                                void* stream) {
  if (batch <= 0 || k <= 0 || k > kMaxK) return cudaErrorInvalidValue;
  const int words = (k + 31) / 32;
  const size_t smem = sizeof(float) * 5 * words * 32
                      + sizeof(uint32_t) * (static_cast<size_t>(k) * words
                                            + 32);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        nms_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  nms_full_kernel<<<batch, kFullThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thresh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
