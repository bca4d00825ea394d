"""Box math, NMS, RoIAlign, the heatmap rasterizer, letterboxing, the
YOLO target builder and quantization (port of ``millieye_tpu/ops``).
The kernel wrappers build nothing at import: each builds its library at
its first launch on the card."""
from millieye_torch.ops.boxes import (
    xywh_to_xyxy,
    xyxy_to_xywh,
    iou_pairwise,
    iou_matrix,
    wh_iou,
    rescale_boxes,
    box_regress,
    encode_boxes,
)
from millieye_torch.ops.nms import (
    batched_nms,
    nms_xyxy,
    nms_keep_mask,
    nms_keep_mask_ref,
)
from millieye_torch.ops.roi_align import roi_align, ps_roi_align
from millieye_torch.ops.rasterize import radar_heatmap, heatmap_bins
from millieye_torch.ops.letterbox import (
    letterbox_image,
    pad_to_square,
    resize_nearest,
    resize_bilinear_align_corners,
)
from millieye_torch.ops.targets import build_targets
from millieye_torch.ops.quantize import (
    quantize_int8,
    quantize_int8_stochastic,
    dequantize,
    quantize_darknet,
    dequantize_darknet,
    calibrate_act_scales,
)
