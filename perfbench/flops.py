"""Model FLOPs a frame, counted from a configuration's layer list: 2 per
multiply-add of every convolution of the Darknet (pjreddie's count; a
batch norm, an activation, a pool or the decode adds none) and, for the
fusion detector at mode 0, of the heads' convolutions and products. The
arithmetic of ``benchmarks/flops.py`` (which walks the JAX model),
rewritten against the configuration file."""
from __future__ import annotations

from perfbench.reference.darknet import plan


def darknet_flops(blocks, img_size):
    """FLOPs of one frame through the Darknet's convolutions, with each
    block's output size followed through pools, upsamples and routes."""
    layers = plan(blocks)
    sizes = []
    total = 0
    for i, info in enumerate(layers):
        s = sizes[-1] if sizes else img_size
        t = info["type"]
        if t == "convolutional":
            s = -(-s // info["stride"])
            total += 2 * s * s * info["cout"] * info["cin"] * info["k"] ** 2
        elif t == "maxpool":
            s = s // info["stride"] if info["stride"] > 1 else s
        elif t == "upsample":
            s = s * info["factor"]
        elif t == "route":
            s = sizes[info["layers"][0]]
        sizes.append(s)
    return total


def head_flops(heads, img_size):
    """FLOPs of the fusion heads a frame at mode 0: the score-map and
    radar-encoder convolutions on the stride-16 map, and for every RoI
    slot (``max_det`` image rows and ``max_radar`` radar rows, valid or
    not, as the program computes them) the refinement head (its two
    products on the flattened crop, the radar branch's 7x7 and 1x1
    convolutions) and, for the image rows, the ensemble head."""
    g = img_size // 16
    conv = 0
    chans = heads["score_map"]
    conv += sum(g * g * a * b for a, b in zip(chans[:-1], chans[1:]))
    r = heads["radar_enc"]
    conv += sum(g * g * a * b * 9 for a, b in zip(r[:-2], r[1:-1]))
    conv += g * g * r[-2] * r[-1]
    hid = heads["refine_hidden"]
    c_out = chans[-1] // (heads["roi_bins"] ** 2)
    per_roi = (c_out * heads["roi_bins"] ** 2 * hid + hid * 4
               + hid * heads["net2_out"]
               + heads["roi_bins"] ** 2 * r[-1] * r[-1] + r[-1])
    rois = heads["max_det"] + heads["max_radar"]
    e = heads["ensemble_hidden"]
    c1 = heads["class_num"] + 1
    per_img_row = c1 * 2 * e + c1 * e * 2
    return 2 * (conv + rois * per_roi + heads["max_det"] * per_img_row)


def frame_flops(config, mode):
    """A configuration's FLOPs a frame: the Darknet, and at mode 0 the
    fusion heads."""
    total = darknet_flops(config["blocks"], config["img_size"])
    if mode == 0 and "heads" in config:
        total += head_flops(config["heads"], config["img_size"])
    return total
