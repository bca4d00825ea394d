"""Datasets, loaders and the device cache (port of
``millieye_tpu/data``)."""
from millieye_torch.data.preprocessing import (
    np_pad_to_square,
    np_resize_nearest,
    np_resize_bilinear_ac,
    horizontal_flip,
)
from millieye_torch.data.datasets import (
    ImageListDataset,
    ExDarkDataset,
    RadarFusionDataset,
    ConcatDataset,
    COCO_NAMES,
    EXDARK_NAMES,
)
from millieye_torch.data.loader import DataLoader, PaddedCollate
from millieye_torch.data.device_cache import DeviceCache
from millieye_torch.data.synthetic import SyntheticScenes
