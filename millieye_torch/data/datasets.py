"""Dataset readers for the three training stages: a copy of
``millieye_tpu/data/datasets.py``.

Each dataset's ``get(idx)`` returns a dict of numpy arrays with RAGGED
targets; fixed-shape padding happens once in ``loader.PaddedCollate`` so
every batch entering the device has static shapes.

* ``ImageListDataset``  — path-list datasets (COCO-style), the reference's
  ListDataset (module2_mixed/utils/datasets.py:75-167): YOLO-format labels
  found by images->labels path substitution, letterbox to square,
  normalized xywh targets.
* ``ExDarkDataset``     — the ExDark low-light set
  (module2_mixed/utils/datasets.py:170-334): ``imageclasslist.txt`` split
  file (set 1/2 train, 3 test), labels in (name, left, top, w, h) rows,
  names remapped ExDark -> COCO ids -> 12-class ids.
* ``RadarFusionDataset`` — the radar/camera recordings
  (module3_our_dataset/utils/datasets.py:109-330): per frame image + YOLO
  label + radar boxes (pkl, xyxy image-scale) + radar points (pkl, uvzV);
  5-fold scene split and H/L/D illumination filter. Radar points are
  returned raw — the heatmap is rasterized on the device (ops.rasterize).
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from millieye_torch.data.preprocessing import (
    horizontal_flip,
    load_image_rgb,
    np_pad_to_square,
)

# Standard 80-class COCO names (public ordering).
COCO_NAMES = [
    "person", "bicycle", "car", "motorbike", "aeroplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "sofa", "pottedplant", "bed", "diningtable", "toilet", "tvmonitor",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]

# ExDark's 12 annotation classes and their COCO ids
# (module2_mixed/utils/datasets.py:206-207, 279-280).
EXDARK_NAMES = ["Bicycle", "Boat", "Bottle", "Bus", "Car", "Cat", "Chair",
                "Cup", "Dog", "Motorbike", "People", "Table"]
EXDARK_CLASS_IN_COCO = [0, 1, 2, 3, 5, 8, 15, 16, 39, 41, 56, 60]
_EXDARK_TO_COCO_NAME = {"People": "person", "Table": "diningtable"}


def _letterbox_item(img, boxes_xyxy_abs, classes):
    """Pad image to square; convert absolute xyxy boxes to normalized
    (class, cx, cy, w, h) over the padded square."""
    h, w = img.shape[:2]
    img, pad = np_pad_to_square(img, 0.0)
    s = img.shape[0]
    if len(boxes_xyxy_abs) == 0:
        return img, np.zeros((0, 5), np.float32), pad
    # explicit copy: a float64 input would alias through np.asarray and the
    # in-place pad shift below would corrupt the caller's boxes
    b = np.array(boxes_xyxy_abs, np.float64)
    b[:, 0] += pad[0]
    b[:, 2] += pad[1]
    b[:, 1] += pad[2]
    b[:, 3] += pad[3]
    out = np.zeros((len(b), 5), np.float32)
    out[:, 0] = classes
    out[:, 1] = (b[:, 0] + b[:, 2]) / 2 / s
    out[:, 2] = (b[:, 1] + b[:, 3]) / 2 / s
    out[:, 3] = (b[:, 2] - b[:, 0]) / s
    out[:, 4] = (b[:, 3] - b[:, 1]) / s
    return img, out, pad


def _read_yolo_label(path, w, h, normalized=True):
    """YOLO-format rows (class, cx, cy, w, h) -> absolute xyxy + classes."""
    if not os.path.exists(path):
        return np.zeros((0, 4)), np.zeros((0,))
    rows = np.loadtxt(path).reshape(-1, 5)
    fw, fh = (w, h) if normalized else (1.0, 1.0)
    cx, cy = rows[:, 1] * fw, rows[:, 2] * fh
    bw, bh = rows[:, 3] * fw, rows[:, 4] * fh
    xyxy = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    return xyxy, rows[:, 0]


class ImageListDataset:
    def __init__(self, list_path, normalized_labels=True, augment=False):
        with open(list_path) as fh:
            self.img_files = [l.strip() for l in fh if l.strip()]
        self.label_files = [
            p.replace("images", "labels").replace(".png", ".txt")
            .replace(".jpg", ".txt") for p in self.img_files]
        self.normalized_labels = normalized_labels
        self.augment = augment
        self._aug_rng = np.random.default_rng(0)

    def __len__(self):
        return len(self.img_files)

    def get(self, idx):
        img = load_image_rgb(self.img_files[idx])
        h, w = img.shape[:2]
        xyxy, cls = _read_yolo_label(self.label_files[idx], w, h,
                                     self.normalized_labels)
        img, targets, pad = _letterbox_item(img, xyxy, cls)
        if self.augment and self._aug_rng.uniform() < 0.5:
            img, targets = horizontal_flip(img, targets)
        return {"path": self.img_files[idx], "image": img, "targets": targets}


class ExDarkDataset:
    def __init__(self, root, mode="train", coco_detector=False,
                 chosen_classes=None, augment=False):
        self.root = root
        self.mode = mode
        self.coco_detector = coco_detector
        self.chosen = chosen_classes or list(range(12))
        self.augment = augment
        self._aug_rng = np.random.default_rng(0)
        self.items = []
        with open(os.path.join(root, "imageclasslist.txt")) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                name, img_class, _light, _place, split = line.split(" ")
                cls = int(img_class) - 1
                if cls not in self.chosen:
                    continue
                want = {"train": ("1", "2"), "test": ("3",)}[mode]
                if split in want:
                    cdir = EXDARK_NAMES[cls]
                    self.items.append((
                        os.path.join(root, "Img", cdir, name),
                        os.path.join(root, "Label", cdir, name + ".txt")))

    def __len__(self):
        return len(self.items)

    @staticmethod
    def _parse_label(path):
        """ExDark rows: name left top width height [extras] (possibly with a
        % header line)."""
        names, ltwh = [], []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("%"):
                    continue
                parts = line.split(" ")
                names.append(parts[0])
                ltwh.append([float(v) for v in parts[1:5]])
        return names, np.asarray(ltwh, np.float64).reshape(-1, 4)

    def _map_class(self, name):
        coco_name = _EXDARK_TO_COCO_NAME.get(name, name).lower()
        coco_id = COCO_NAMES.index(coco_name)
        if self.coco_detector:
            return coco_id
        return EXDARK_CLASS_IN_COCO.index(coco_id)

    def get(self, idx):
        img_path, label_path = self.items[idx]
        img = load_image_rgb(img_path)
        names, ltwh = ([], np.zeros((0, 4)))
        if os.path.exists(label_path):
            names, ltwh = self._parse_label(label_path)
        classes = np.asarray([self._map_class(n) for n in names], np.float64)
        xyxy = np.stack([ltwh[:, 0], ltwh[:, 1],
                         ltwh[:, 0] + ltwh[:, 2],
                         ltwh[:, 1] + ltwh[:, 3]], -1) if len(ltwh) else ltwh
        img, targets, _ = _letterbox_item(img, xyxy, classes)
        if self.augment and self._aug_rng.uniform() < 0.5:
            img, targets = horizontal_flip(img, targets)
        return {"path": img_path, "image": img, "targets": targets}


# Scenes recorded in low light (module3 utils/datasets.py:168).
LOW_LIGHT_RECORDINGS = ["153937", "211008", "211738", "212944", "213410",
                        "213435"]


class RadarFusionDataset:
    FOLDS = ["0", "1", "2", "3", "4"]

    def __init__(self, root, mode="train", illumination=("H", "L"),
                 test_list=0, augment=False):
        self.root = root
        self.mode = mode
        self.items = []
        test_scenes = self.FOLDS[test_list:test_list + 1]
        train_scenes = [s for s in self.FOLDS if s not in test_scenes]
        wanted = train_scenes if mode == "train" else test_scenes
        with open(os.path.join(root, "dataset.txt")) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                light, scene = line.split("-")[0][0], line.split("-")[0][1]
                if light in illumination and scene in wanted:
                    self.items.append(line)

    def __len__(self):
        return len(self.items)

    def get(self, idx):
        stem = self.items[idx]
        img_path = os.path.join(self.root, "image", stem + ".jpg")
        img = load_image_rgb(img_path)
        h, w = img.shape[:2]
        xyxy, cls = _read_yolo_label(
            os.path.join(self.root, "label", stem + ".txt"), w, h)
        img, targets, pad = _letterbox_item(img, xyxy, cls)
        s = img.shape[0]

        with open(os.path.join(self.root, "radar_box", stem + ".pkl"), "rb") as fh:
            rbox = np.asarray(pickle.load(fh), np.float64).reshape(-1, 4)
        if len(rbox):
            rbox[:, 0] += pad[0]
            rbox[:, 2] += pad[1]
            rbox[:, 1] += pad[2]
            rbox[:, 3] += pad[3]
            rbox = np.clip(rbox / s, 0.0, 1.0)
            rbox = rbox[(rbox[:, 0] < rbox[:, 2]) & (rbox[:, 1] < rbox[:, 3])]

        with open(os.path.join(self.root, "radar_point", stem + ".pkl"), "rb") as fh:
            points = np.asarray(pickle.load(fh), np.float64).reshape(-1, 4)

        return {"path": img_path, "image": img, "targets": targets,
                "radar_boxes": rbox.astype(np.float32),
                "radar_points": points.astype(np.float32),
                "frame_size": (w, h)}


class ConcatDataset:
    """Concatenation of datasets with the same item schema — the reference's
    "mixed" stage-1/2 training joins COCO-subset and ExDark samples
    (README.md:25-27; the list files are concatenated offline there)."""

    def __init__(self, *datasets):
        self.datasets = datasets

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def get(self, idx):
        for d in self.datasets:
            if idx < len(d):
                return d.get(idx)
            idx -= len(d)
        raise IndexError(idx)
