"""Sensor I/O toolkit (port of ``millieye_tpu/collection``): the UART
radar parser, the two-process recorder, time sync and dataset
preparation; host code, numpy."""
from millieye_torch.collection.sync import (load_timestamps, load_pointcloud,
                                            match_frames)
from millieye_torch.collection.uart import RadarReader, parse_radar_cfg
from millieye_torch.collection.prepare import prepare_dataset
