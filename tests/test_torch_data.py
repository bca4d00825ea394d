"""The port's data package on the CPU against the JAX package's: the
numpy preprocessing, the dataset readers on files the tests write, the
synthetic scenes, the padded collate, the threaded loader and the device
cache (on the CPU here; the card holds it in chip_smoke.py P19).

The numpy modules are copies, so items, arrays and batches are held
equal bit for bit; the device cache's images pass through float16 in
both packages and are held equal after that round trip."""
import os
import pickle
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from millieye_torch.data import datasets as tdata
from millieye_torch.data import preprocessing as tpre
from millieye_torch.data.device_cache import DeviceCache
from millieye_torch.data.loader import DataLoader, PaddedCollate
from millieye_torch.data.synthetic import SyntheticScenes
from millieye_torch.train.recipes import fusion_device_batch
from millieye_tpu.data import datasets as jdata
from millieye_tpu.data import preprocessing as jpre
from millieye_tpu.data.device_cache import DeviceCache as JaxCache
from millieye_tpu.data.loader import DataLoader as JaxLoader
from millieye_tpu.data.loader import PaddedCollate as JaxCollate
from millieye_tpu.data.synthetic import SyntheticScenes as JaxScenes
from millieye_tpu.train.recipes import fusion_device_batch as jax_batch

torch.set_num_threads(1)


def _same_item(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _same_batch(a, b, skip=()):
    for k in set(a) - set(skip):
        if isinstance(a[k], (np.ndarray, torch.Tensor)):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
        else:
            assert a[k] == b[k], k


# ------------------------------------------------------------ preprocessing
@pytest.mark.parametrize("hw", [(48, 64), (64, 40), (32, 32)])
def test_preprocessing_equal(hw):
    rng = np.random.default_rng(0)
    img = rng.uniform(size=hw + (3,)).astype(np.float32)
    for fn, args in (("np_pad_to_square", (0.5,)),
                     ("np_resize_nearest", (37,)),
                     ("np_resize_bilinear_ac", (23,)),
                     ("np_resize_bilinear_ac", (1,))):
        got, want = getattr(tpre, fn)(img, *args), getattr(jpre, fn)(
            img, *args)
        if fn == "np_pad_to_square":
            assert got[1] == want[1]
            got, want = got[0], want[0]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    targets = rng.uniform(size=(3, 5)).astype(np.float32)
    for a, b in zip(tpre.horizontal_flip(img, targets),
                    jpre.horizontal_flip(img, targets)):
        np.testing.assert_array_equal(a, b)
    assert tpre.horizontal_flip(img, None)[1] is None


def test_load_image_rgb_equal(tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "a.png")
    Image.fromarray((rng.uniform(size=(20, 30, 3)) * 255).astype(
        np.uint8)).save(path)
    np.testing.assert_array_equal(tpre.load_image_rgb(path),
                                  jpre.load_image_rgb(path))


# ----------------------------------------------------------------- datasets
def _save_img(path, w=64, h=48, seed=0):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    Image.fromarray((rng.uniform(size=(h, w, 3)) * 255).astype(
        np.uint8)).save(path)


def test_image_list_dataset_equal(tmp_path):
    img_dir, lbl_dir = tmp_path / "images", tmp_path / "labels"
    os.makedirs(lbl_dir)
    paths = []
    for i, (w, h) in enumerate(((64, 48), (40, 56), (32, 32))):
        p = str(img_dir / f"a{i}.jpg")
        _save_img(p, w, h, seed=i)
        paths.append(p)
    (lbl_dir / "a0.txt").write_text("2 0.5 0.5 0.5 0.5\n1 0.2 0.3 0.1 0.2\n")
    (lbl_dir / "a1.txt").write_text("0 0.4 0.6 0.3 0.3\n")
    lst = tmp_path / "train.txt"
    lst.write_text("\n".join(paths) + "\n")
    for augment in (False, True):
        got = tdata.ImageListDataset(str(lst), augment=augment)
        want = jdata.ImageListDataset(str(lst), augment=augment)
        assert len(got) == len(want) == 3
        for i in range(3):
            _same_item(got.get(i), want.get(i))


def test_exdark_dataset_equal(tmp_path):
    root = tmp_path
    rows = []
    for k, cls in enumerate((0, 10, 11, 4)):     # Bicycle People Table Car
        cdir = tdata.EXDARK_NAMES[cls]
        name = f"x{k}.jpg"
        _save_img(str(root / "Img" / cdir / name), seed=k)
        os.makedirs(root / "Label" / cdir, exist_ok=True)
        (root / "Label" / cdir / (name + ".txt")).write_text(
            f"% bbGt version=3\n{cdir} 10 12 20 16 0 0 0 0 0 0 0\n"
            f"Cup 3 4 5 6 0 0 0 0 0 0 0\n")
        rows.append(f"{name} {cls + 1} 2 3 {3 if k % 2 else 1}")
    rows.append("# a comment line")
    (root / "imageclasslist.txt").write_text("\n".join(rows) + "\n")
    for mode in ("train", "test"):
        for coco in (False, True):
            got = tdata.ExDarkDataset(str(root), mode, coco_detector=coco)
            want = jdata.ExDarkDataset(str(root), mode, coco_detector=coco)
            assert got.items == want.items and len(got) == 2
            for i in range(len(got)):
                _same_item(got.get(i), want.get(i))
    # the trap: 12-class ids index the sorted COCO-id list (People -> 0)
    ds = tdata.ExDarkDataset(str(root), "test")
    assert ds._map_class("People") == 0
    assert tdata.EXDARK_CLASS_IN_COCO == jdata.EXDARK_CLASS_IN_COCO


def test_real_mini_layouts_through_both_packages(tmp_path):
    """benchmarks/real_mini.py's ``build``, read by each package through
    both layouts: the same items, People as class 0."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "benchmarks"))
    from real_mini import build
    root = str(tmp_path / "mini")
    build(root, seed=0)
    for cls in ("ImageListDataset", "ExDarkDataset"):
        args = ((os.path.join(root, "test.txt"),) if cls == "ImageListDataset"
                else (root, "test"))
        got, want = getattr(tdata, cls)(*args), getattr(jdata, cls)(*args)
        assert len(got) == len(want) > 0
        for i in range(0, len(got), 3):
            a = got.get(i)
            _same_item(a, want.get(i))
            if len(a["targets"]):
                assert set(a["targets"][:, 0]) == {0.0}


def _write_fusion_dataset(root, n=6, img=64):
    """The RadarFusionDataset layout tests/test_cli.py writes, with
    frames of two shapes and boxes that clip or vanish."""
    rng = np.random.default_rng(0)
    for sub in ("image", "label", "radar_box", "radar_point"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    stems = []
    for i in range(n):
        stem = f"{'HL'[i % 2]}{i % 3}-{i:03d}"
        h = img if i % 2 else img * 3 // 4
        Image.fromarray((rng.uniform(size=(h, img, 3)) * 255).astype(
            np.uint8)).save(os.path.join(root, "image", stem + ".jpg"))
        with open(os.path.join(root, "label", stem + ".txt"), "w") as f:
            f.write("0 0.5 0.5 0.4 0.4\n")
        with open(os.path.join(root, "radar_box", stem + ".pkl"), "wb") as f:
            pickle.dump(np.array([[5.0, 5.0, 40.0, 50.0],
                                  [-4.0, 2.0, 90.0, 70.0],
                                  [30.0, 30.0, 30.0, 40.0]]), f)
        with open(os.path.join(root, "radar_point", stem + ".pkl"),
                  "wb") as f:
            pickle.dump(rng.uniform(0, img, size=(6, 4)), f)
        stems.append(stem)
    with open(os.path.join(root, "dataset.txt"), "w") as f:
        f.write("\n".join(stems) + "\n")


def test_radar_fusion_and_concat_datasets_equal(tmp_path):
    root = str(tmp_path / "ds")
    _write_fusion_dataset(root)
    for mode, light, fold in (("train", ("H", "L"), 0), ("test", ("L",), 1),
                              ("test", ("H",), 2)):
        got = tdata.RadarFusionDataset(root, mode, light, fold)
        want = jdata.RadarFusionDataset(root, mode, light, fold)
        assert got.items == want.items and len(got) > 0
        for i in range(len(got)):
            _same_item(got.get(i), want.get(i))
    parts = [tdata.RadarFusionDataset(root, "test", ("H", "L"), f)
             for f in (0, 1)]
    jparts = [jdata.RadarFusionDataset(root, "test", ("H", "L"), f)
              for f in (0, 1)]
    got, want = tdata.ConcatDataset(*parts), jdata.ConcatDataset(*jparts)
    assert len(got) == len(want) == sum(len(p) for p in parts)
    for i in range(len(got)):
        _same_item(got.get(i), want.get(i))
    with pytest.raises(IndexError):
        got.get(len(got))


# ---------------------------------------------------------------- synthetic
@pytest.mark.parametrize("seed", [0, 777])
def test_synthetic_scenes_equal(seed):
    for kw in ({}, {"illumination": ("L",), "radar": False}):
        got, want = SyntheticScenes(6, seed=seed, **kw), JaxScenes(
            6, seed=seed, **kw)
        assert got.items == want.items
        for i in range(len(got)):
            assert got.light_of(i) == want.light_of(i)
            _same_item(got.get(i), want.get(i))


# --------------------------------------------------------- collate / loader
def test_padded_collate_equal():
    ds = SyntheticScenes(5, seed=3, frame_hw=(96, 128))
    items = [ds.get(i) for i in range(len(ds))]
    for kw in ({"img_size": 128, "max_targets": 2, "max_radar": 3,
                "max_points": 16},
               {"img_size": 160, "multiscale": True, "seed": 4}):
        got_c, want_c = PaddedCollate(**kw), JaxCollate(**kw)
        for _ in range(12):           # past a multiscale roll
            got, want = got_c(items), want_c(items)
            assert set(got) == set(want)
            _same_batch(got, want)


def test_loader_keeps_order_and_raises_worker_errors():
    ds = SyntheticScenes(9, seed=2, frame_hw=(48, 64))
    coll = dict(img_size=64, max_targets=4, max_radar=4, max_points=32)
    for shuffle in (False, True):
        got = DataLoader(ds, 4, PaddedCollate(**coll), shuffle=shuffle,
                         num_workers=3, seed=1)
        want = JaxLoader(ds, 4, JaxCollate(**coll), shuffle=shuffle,
                         num_workers=3, seed=1)
        assert len(got) == len(want) == 3
        for _ in range(2):            # two epochs: the shuffle moves on
            bg, bw = list(got), list(want)
            assert [b["paths"] for b in bg] == [b["paths"] for b in bw]
            for a, b in zip(bg, bw):
                _same_batch(a, b)
    drop = DataLoader(ds, 4, PaddedCollate(**coll), drop_last=True)
    assert len(drop) == 2 and len(list(drop)) == 2

    class Broken:
        def __len__(self):
            return 4

        def get(self, idx):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(DataLoader(Broken(), 2, PaddedCollate(64)))


def test_fusion_device_batch_equal():
    ds = SyntheticScenes(4, seed=9, frame_hw=(96, 128))
    host = PaddedCollate(128, max_targets=4, max_radar=8,
                         max_points=64)([ds.get(i) for i in range(4)])
    got = fusion_device_batch(host, 128, "cpu")
    want = jax_batch(host, 128)
    assert set(got) - {"host"} == set(want)
    _same_batch(got, want, skip=("radar_maps", "host"))
    assert all(isinstance(got[k], torch.Tensor) for k in want
               if k not in ("_n", "brightness"))
    # the heatmap's depth and speed sums are float32 sums in another order
    # (ops/rasterize.py): 1e-6, the scale of one float32 rounding of maps
    # in [0, 1]
    np.testing.assert_allclose(got["radar_maps"].numpy(),
                               np.asarray(want["radar_maps"]), atol=1e-6)
    for k in ("targets", "tmask"):
        np.testing.assert_array_equal(got["host"][k], host[k])


# ------------------------------------------------------------- device cache
def _collate():
    return dict(img_size=128, max_targets=8, max_radar=16, max_points=128)


@pytest.fixture(scope="module")
def caches():
    ds = SyntheticScenes(10, seed=5, frame_hw=(96, 128))
    return (DeviceCache.build(ds, PaddedCollate(**_collate()), device="cpu"),
            JaxCache.build(ds, JaxCollate(**_collate())), ds)


def _cache_batches(loader):
    return [{k: (v.numpy() if isinstance(v, torch.Tensor) else
                 np.asarray(v) if k != "host" else v)
             for k, v in b.items()} for b in loader]


@pytest.mark.parametrize("kw", [dict(batch_size=10),
                                dict(batch_size=4),
                                dict(batch_size=4, shuffle=True, seed=1),
                                dict(batch_size=4, drop_last=True),
                                dict(batch_size=3, shuffle=True, seed=2,
                                     drop_last=False)])
def test_device_cache_equal(caches, kw):
    got_c, want_c, _ = caches
    got_l, want_l = got_c.loader(**kw), want_c.loader(**kw)
    assert len(got_l) == len(want_l)
    for _ in range(2):                # two epochs: the same reshuffle
        got, want = _cache_batches(got_l), _cache_batches(want_l)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert set(a) - {"host"} == set(b)
            assert a["images"].dtype == np.float32
            _same_batch(a, b, skip=("host",))
            n = a["_n"]
            np.testing.assert_array_equal(a["host"]["targets"][:n],
                                          a["targets"][:n])
            np.testing.assert_array_equal(a["host"]["tmask"][:n],
                                          a["tmask"][:n])


def test_device_cache_matches_host_collate(caches):
    cache, _, ds = caches
    host = next(iter(DataLoader(ds, 10, PaddedCollate(**_collate()))))
    got = next(iter(cache.loader(10)))
    assert got["_n"] == 10 and got["images"].dtype == torch.float32
    # after the float16 round trip the images are the host's exactly
    np.testing.assert_array_equal(
        got["images"].numpy(),
        host["images"].astype(np.float16).astype(np.float32))
    for k in ("targets", "tmask", "radar_boxes", "rmask", "radar_points",
              "pmask"):
        np.testing.assert_array_equal(got[k].numpy(), host[k])
    assert got["frame_size"] == host["frame_size"]
    tail = list(cache.loader(4))[-1]
    assert tail["_n"] == 2
    np.testing.assert_array_equal(tail["images"][2].numpy(),
                                  tail["images"][3].numpy())
