// Greedy class-aware NMS keep mask (kernel K1).
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

}  // extern "C"
