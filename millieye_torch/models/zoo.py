"""Model declarations (port of ``millieye_tpu/models/zoo.py``): block
dicts with the schema a darknet ``.cfg`` parser emits
(``io/config.py:parse_model_config``): tiny-YOLOv3, the fusion
detector's backbone, the full YOLOv3 on Darknet-53, and YOLOv4 on
CSPDarknet53 (the port's own)."""
from __future__ import annotations

# pjreddie tiny-yolov3 anchors; the reference's yolov3-tiny-12.cfg uses
# the same six with masks (3,4,5)/(1,2,3)
TINY_ANCHORS = ((10, 14), (23, 27), (37, 58), (81, 82), (135, 169),
                (344, 319))


def _conv(filters, size, stride=1, bn=True, act="leaky"):
    return {"type": "convolutional", "batch_normalize": "1" if bn else "0",
            "filters": str(filters), "size": str(size), "stride": str(stride),
            "pad": "1", "activation": act}


def _maxpool(size, stride):
    return {"type": "maxpool", "size": str(size), "stride": str(stride)}


def _yolo(mask, anchors, classes):
    return {"type": "yolo", "mask": ",".join(str(m) for m in mask),
            "anchors": ",".join(f"{a},{b}" for a, b in anchors),
            "classes": str(classes), "num": str(len(anchors)),
            "ignore_thresh": ".5"}


def tiny_yolov3_defs(num_classes=12, img_size=416, anchors=TINY_ANCHORS):
    """tiny-YOLOv3: two detection scales, stride-16 feature tap at
    block 8 for the fusion stage."""
    out_f = 3 * (num_classes + 5)
    net = {"type": "net", "channels": "3",
           "height": str(img_size), "width": str(img_size)}
    body = [
        _conv(16, 3), _maxpool(2, 2),            # 0, 1
        _conv(32, 3), _maxpool(2, 2),            # 2, 3
        _conv(64, 3), _maxpool(2, 2),            # 4, 5
        _conv(128, 3), _maxpool(2, 2),           # 6, 7
        _conv(256, 3),                           # 8  <- fusion feature tap
        _maxpool(2, 2),                          # 9
        _conv(512, 3), _maxpool(2, 1),           # 10, 11 (stride-1 pool)
        _conv(1024, 3),                          # 12
        _conv(256, 1),                           # 13
        _conv(512, 3),                           # 14
        _conv(out_f, 1, bn=False, act="linear"), # 15
        _yolo((3, 4, 5), anchors, num_classes),  # 16 (13x13 grid @416)
        {"type": "route", "layers": "-4"},       # 17
        _conv(128, 1),                           # 18
        {"type": "upsample", "stride": "2"},     # 19
        {"type": "route", "layers": "-1, 8"},    # 20
        _conv(256, 3),                           # 21
        _conv(out_f, 1, bn=False, act="linear"), # 22
        _yolo((1, 2, 3), anchors, num_classes),  # 23 (26x26 grid @416)
    ]
    return [net] + body


# pjreddie yolov3.cfg anchors
YOLOV3_ANCHORS = ((10, 13), (16, 30), (33, 23), (30, 61), (62, 45),
                  (59, 119), (116, 90), (156, 198), (373, 326))


def _shortcut(frm):
    return {"type": "shortcut", "from": str(frm), "activation": "linear"}


def _residual(filters):
    """Darknet-53 residual: 1x1 squeeze -> 3x3 expand -> add."""
    return [_conv(filters // 2, 1), _conv(filters, 3), _shortcut(-3)]


def yolov3_defs(num_classes=80, img_size=416, anchors=YOLOV3_ANCHORS):
    """Full YOLOv3: Darknet-53 and three detection scales, the 107 blocks
    of pjreddie's ``yolov3.cfg`` (yolo at 82, 94 and 106), so its
    ``.weights`` files load through ``io/darknet_weights.py``."""
    out_f = 3 * (num_classes + 5)
    net = {"type": "net", "channels": "3",
           "height": str(img_size), "width": str(img_size)}
    body = [_conv(32, 3)]
    # Darknet-53: a stride-2 downsample and n residuals per stage
    for filters, blocks in ((64, 1), (128, 2), (256, 8), (512, 8),
                            (1024, 4)):
        body.append(_conv(filters, 3, stride=2))
        for _ in range(blocks):
            body.extend(_residual(filters))
    # scale 1 (13x13 at 416)
    for _ in range(3):
        body.extend([_conv(512, 1), _conv(1024, 3)])
    body = body[:-1]                      # the 512-channel branch point
    body.extend([
        _conv(1024, 3),
        _conv(out_f, 1, bn=False, act="linear"),
        _yolo((6, 7, 8), anchors, num_classes),
        {"type": "route", "layers": "-4"},
        _conv(256, 1),
        {"type": "upsample", "stride": "2"},
        {"type": "route", "layers": "-1, 61"},
    ])
    # scale 2 (26x26)
    for _ in range(3):
        body.extend([_conv(256, 1), _conv(512, 3)])
    body = body[:-1]
    body.extend([
        _conv(512, 3),
        _conv(out_f, 1, bn=False, act="linear"),
        _yolo((3, 4, 5), anchors, num_classes),
        {"type": "route", "layers": "-4"},
        _conv(128, 1),
        {"type": "upsample", "stride": "2"},
        {"type": "route", "layers": "-1, 36"},
    ])
    # scale 3 (52x52)
    for _ in range(3):
        body.extend([_conv(128, 1), _conv(256, 3)])
    body.extend([
        _conv(out_f, 1, bn=False, act="linear"),
        _yolo((0, 1, 2), anchors, num_classes),
    ])
    return [net] + body


# AlexeyAB yolov4.cfg anchors
YOLOV4_ANCHORS = ((12, 16), (19, 36), (40, 28), (36, 75), (76, 55),
                  (72, 146), (142, 110), (192, 243), (459, 401))


def _yolov4_head(mask, anchors, classes, scale_x_y):
    """yolov4.cfg's ``[yolo]`` block: ``_yolo``'s keys with its own
    values, and its grid sensitivity ``scale_x_y`` and training keys."""
    return dict(_yolo(mask, anchors, classes), jitter=".3",
                ignore_thresh=".7", truth_thresh="1", scale_x_y=scale_x_y,
                iou_thresh="0.213", cls_normalizer="1.0",
                iou_normalizer="0.07", iou_loss="ciou", nms_kind="greedynms",
                beta_nms="0.6", max_delta="5")


def _csp_stage(filters, blocks):
    """One CSPDarknet53 stage: a stride-2 downsample, a 1x1 shortcut
    branch, and a 1x1 main branch (``route -2``) through ``blocks``
    residuals and a 1x1 transition, then the two branches joined and
    merged by a 1x1. The first stage keeps the full width in both
    branches, with a half-width squeeze in its residual."""
    first = blocks == 1
    half = filters if first else filters // 2
    body = [_conv(filters, 3, stride=2, act="mish"),
            _conv(half, 1, act="mish"),
            {"type": "route", "layers": "-2"},
            _conv(half, 1, act="mish")]
    for _ in range(blocks):
        body.extend([_conv(filters // 2 if first else half, 1, act="mish"),
                     _conv(half, 3, act="mish"), _shortcut(-3)])
    body.extend([_conv(half, 1, act="mish"),
                 {"type": "route", "layers": f"-1,-{3 * blocks + 4}"},
                 _conv(filters, 1, act="mish")])
    return body


def yolov4_defs(num_classes=80, img_size=608, anchors=YOLOV4_ANCHORS):
    """YOLOv4: the 162 blocks of AlexeyAB's ``yolov4.cfg``, in its order
    and with its keys. CSPDarknet53 (blocks 0-104, every convolution
    Mish), SPP (stride-1 max pools of 5, 9 and 13 on block 107, joined by
    block 113), then a PAN (leaky): top-down through two upsamples, then
    bottom-up through stride-2 convolutions, with YOLO heads at strides 8,
    16 and 32 (blocks 139, 150, 161; ``scale_x_y`` 1.2, 1.1, 1.05)."""
    out_f = 3 * (num_classes + 5)
    net = {"type": "net", "channels": "3",
           "height": str(img_size), "width": str(img_size)}
    body = [_conv(32, 3, act="mish")]
    for filters, blocks in ((64, 1), (128, 2), (256, 8), (512, 8),
                            (1024, 4)):
        body.extend(_csp_stage(filters, blocks))
    # SPP on the stride-32 map
    body.extend([_conv(512, 1), _conv(1024, 3), _conv(512, 1),
                 _maxpool(5, 1), {"type": "route", "layers": "-2"},
                 _maxpool(9, 1), {"type": "route", "layers": "-4"},
                 _maxpool(13, 1), {"type": "route", "layers": "-1,-3,-5,-6"},
                 _conv(512, 1), _conv(1024, 3), _conv(512, 1)])
    # top-down: to stride 16 (joined with block 85), then 8 (block 54)
    for filters, lateral in ((256, 85), (128, 54)):
        body.extend([_conv(filters, 1), {"type": "upsample", "stride": "2"},
                     {"type": "route", "layers": str(lateral)},
                     _conv(filters, 1), {"type": "route", "layers": "-1,-3"},
                     _conv(filters, 1), _conv(2 * filters, 3),
                     _conv(filters, 1), _conv(2 * filters, 3),
                     _conv(filters, 1)])
    # bottom-up: a head at each stride, then a stride-2 conv joined with
    # the top-down map of the next stride (blocks 126 and 116)
    heads = (((0, 1, 2), "1.2", 128, "-1,-16"),
             ((3, 4, 5), "1.1", 256, "-1,-37"),
             ((6, 7, 8), "1.05", 512, None))
    for mask, scale, filters, join in heads:
        body.extend([_conv(2 * filters, 3),
                     _conv(out_f, 1, bn=False, act="linear"),
                     _yolov4_head(mask, anchors, num_classes, scale)])
        if join is None:
            break
        body.extend([{"type": "route", "layers": "-4"},
                     _conv(2 * filters, 3, stride=2),
                     {"type": "route", "layers": join},
                     _conv(2 * filters, 1), _conv(4 * filters, 3),
                     _conv(2 * filters, 1), _conv(4 * filters, 3),
                     _conv(2 * filters, 1)])
    return [net] + body
