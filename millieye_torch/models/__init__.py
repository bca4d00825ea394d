"""The Darknet backbone, the YOLO head and the fusion networks (port of
``millieye_tpu/models``)."""
from millieye_torch.models.darknet import Darknet, decode_yolo
from millieye_torch.models.zoo import (tiny_yolov3_defs, yolov3_defs,
                                       TINY_ANCHORS, YOLOV3_ANCHORS)
from millieye_torch.models.fusion import (FusionConfig, FusionNetwork,
                                          RefineNetwork)
from millieye_torch.models.yolo_head import yolo_loss, yolo_scale_loss
