"""Model declarations (port of ``millieye_tpu/models/zoo.py``): block
dicts with the schema a darknet ``.cfg`` parser emits
(``io/config.py:parse_model_config``): tiny-YOLOv3, the fusion
detector's backbone, and the full YOLOv3 on Darknet-53."""
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
