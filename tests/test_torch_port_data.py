"""The data pipeline of the PyTorch port against the JAX package's, on
the CPU: the cv2-free resize against cv2 itself, the transforms, the
PPM decoder against cv2.imread, the COCO records, ``make_batch`` and
both loader streams (eval with its padded tails, train for three
iterations with flips and multi-scale sizes) on a synthetic PPM dataset
that the JAX package reads with cv2 and the port with numpy. Integer
and pixel outputs must be equal; so must the float boxes, since both
sides do the same float32 arithmetic on them. Last, the port's loader
feeds two iterations of its ``do_train``."""

import json
import logging
import os
import sys

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu.data import coco as jcoco
from paa_tpu.data import loader as jloader
from paa_tpu.data import transforms as jtransforms
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.data import coco, loader, transforms
from paa_tpu_torch.data.build import build_dataset
from paa_tpu_torch.data.list_dataset import ListDataset
from paa_tpu_torch.data.synth import synth_coco

MEAN = (102.9801, 115.9465, 122.7717)
STD = (1.0, 1.0, 1.0)
# small COCO-like sizes (w, h): both orientations, so both buckets fill
SIZES = ((96, 72), (72, 96), (64, 80), (100, 75), (80, 64), (90, 90))
CFG = [
    "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96,
    "INPUT.MIN_SIZE_RANGE_TRAIN", (48, 64), "INPUT.MAX_SIZE_TRAIN", 96,
    "TPU.TEST_BUCKETS", ((64, 96), (96, 64)),
    "TPU.TRAIN_BUCKETS", ((64, 96), (96, 64)),
    "TPU.MAX_GT", 8, "TEST.IMS_PER_BATCH", 3, "SOLVER.IMS_PER_BATCH", 2,
    "SOLVER.MAX_ITER", 3, "DATALOADER.NUM_WORKERS", 2,
]


def _rand_image(rng, h, w, c):
    shape = (h, w, c) if c > 1 else (h, w)
    return rng.randint(0, 256, shape).astype(np.uint8)


# ---- the resize ----------------------------------------------------------

@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.integers(1, 700), st.integers(1, 700), st.integers(1, 700),
       st.integers(1, 700), st.sampled_from([1, 3]),
       st.integers(0, 2 ** 31 - 1))
def test_resize_uint8_linear_equals_cv2(w, h, ow, oh, c, seed):
    img = _rand_image(np.random.RandomState(seed), h, w, c)
    want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
    got = transforms.resize_uint8_linear(img, ow, oh)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w,h,ow,oh", [
    (640, 480, 1067, 800), (480, 640, 800, 1067), (427, 640, 800, 1199),
    (500, 375, 1066, 800), (640, 360, 1333, 750), (1333, 800, 640, 384),
    (1, 1, 7, 5), (5, 1, 1, 3), (2, 2, 1, 1),
])
def test_resize_uint8_linear_equals_cv2_at_coco_shapes(w, h, ow, oh):
    img = _rand_image(np.random.RandomState(w * h), h, w, 3)
    np.testing.assert_array_equal(
        transforms.resize_uint8_linear(img, ow, oh),
        cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("w,h", [(64, 48), (640, 480), (2, 2), (34, 700)])
def test_resize_exact_2x_down_equals_cv2_linear_and_area(w, h):
    """OpenCV routes an exact 2x downscale of INTER_LINEAR to INTER_AREA;
    for uint8 both give the replica's pixels."""
    img = _rand_image(np.random.RandomState(h), h, w, 3)
    got = transforms.resize_uint8_linear(img, w // 2, h // 2)
    for flag in (cv2.INTER_LINEAR, cv2.INTER_AREA):
        np.testing.assert_array_equal(
            got, cv2.resize(img, (w // 2, h // 2), interpolation=flag))


def test_resize_rejects_other_inputs():
    with pytest.raises(ValueError):
        transforms.resize_uint8_linear(np.zeros((4, 4, 3), np.float32), 2, 2)
    with pytest.raises(ValueError):
        transforms.resize_uint8_linear(np.zeros((4, 4, 3), np.uint8), 0, 2)


# ---- transforms -------------------------------------------------------------

@pytest.mark.parametrize("wh,size,max_size", [
    ((640, 480), 800, 1333), ((480, 640), 800, 1333),
    ((640, 360), 800, 1333), ((427, 640), 800, 1333),
    ((800, 800), 800, 1333), ((500, 375), 640, None), ((3, 1000), 64, 96),
])
def test_get_resize_size_matches_jax(wh, size, max_size):
    assert transforms.get_resize_size(wh, size, max_size) == \
        jtransforms.get_resize_size(wh, size, max_size)


def _image_and_boxes(seed):
    rng = np.random.RandomState(seed)
    img = _rand_image(rng, 75, 100, 3)
    boxes = np.asarray([[3, 4, 50, 60], [20.5, 10.25, 99, 74]], np.float32)
    return img, boxes


@pytest.mark.parametrize("defer", [True, False])
def test_eval_transform_matches_jax(defer):
    img, boxes = _image_and_boxes(0)
    got = transforms.EvalTransform(64, 96, MEAN, STD, defer)(img, boxes)
    want = jtransforms.EvalTransform(64, 96, MEAN, STD, defer)(img, boxes)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("draws", [(0.1, 0.2), (0.9, 0.7), (0.55, 0.49)])
def test_train_transform_matches_jax(draws):
    """Multi-scale sizes (MIN_SIZE_RANGE_TRAIN 48..64) and the flip."""
    img, boxes = _image_and_boxes(1)
    sizes = list(range(48, 65))
    got = transforms.TrainTransform(sizes, 96, MEAN, STD, seed=0,
                                    defer_normalize=True)(img, boxes, draws)
    want = jtransforms.TrainTransform(sizes, 96, MEAN, STD, seed=0,
                                      defer_normalize=True)(
        img, boxes, draws=draws)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_build_transforms_expands_the_train_range():
    cfg = _cfgs()[1]
    t = transforms.build_transforms(cfg, is_train=True)
    assert t.min_sizes == list(range(48, 65)) and t.max_size == 96
    assert transforms.build_transforms(cfg, is_train=False).min_size == 64


# ---- the dataset ------------------------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A synthetic PPM COCO of 11 images at SIZES, plus a crowd
    annotation, a box of zero width and an image without annotations."""
    root = str(tmp_path_factory.mktemp("port_data"))
    ann_file, img_dir = synth_coco(root, 11, seed=3, sizes=SIZES)
    with open(ann_file) as f:
        data = json.load(f)
    data["annotations"].append(dict(
        id=1000, image_id=1, bbox=[1, 1, 30, 20], area=600,
        category_id=data["categories"][5]["id"], iscrowd=1))
    data["annotations"].append(dict(
        id=1001, image_id=2, bbox=[10, 10, 0.5, 20], area=10,
        category_id=data["categories"][0]["id"], iscrowd=0))
    coco.write_ppm(os.path.join(img_dir, "empty.ppm"),
                   _rand_image(np.random.RandomState(5), 64, 80, 3))
    data["images"].append(dict(id=99, file_name="empty.ppm", width=80,
                               height=64))
    with open(ann_file, "w") as f:
        json.dump(data, f)
    return ann_file, img_dir


def test_read_ppm_equals_cv2_imread(synth):
    _, img_dir = synth
    for name in sorted(os.listdir(img_dir))[:4]:
        path = os.path.join(img_dir, name)
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(coco.read_image(path), want)


def test_read_ppm_skips_header_comments(tmp_path):
    img = _rand_image(np.random.RandomState(2), 5, 7, 3)
    path = str(tmp_path / "c.ppm")
    with open(path, "wb") as f:
        f.write(b"P6\n# a comment\n7 5\n255\n")
        f.write(img[:, :, ::-1].tobytes())
    np.testing.assert_array_equal(coco.read_image(path), img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR), img)


def test_other_formats_need_cv2(tmp_path, monkeypatch):
    img = _rand_image(np.random.RandomState(3), 8, 8, 3)
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(coco.read_image(path), img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="a.png.*cv2"):
        coco.read_image(path)
    with pytest.raises(FileNotFoundError):
        coco.read_image(str(tmp_path / "missing.ppm"))


@pytest.mark.parametrize("remove", [True, False])
def test_coco_records_match_jax(synth, remove):
    got = coco.COCODataset(*synth, remove_images_without_annotations=remove)
    want = jcoco.COCODataset(*synth,
                             remove_images_without_annotations=remove)
    assert len(got) == len(want) == 11 + (not remove)
    assert got.json_category_id_to_contiguous_id == \
        want.json_category_id_to_contiguous_id
    assert got._raw_annotations == want._raw_annotations
    for g, w in zip(got.records, want.records):
        assert (g.id, g.file_name, g.width, g.height) == \
            (w.id, w.file_name, w.width, w.height)
        np.testing.assert_array_equal(g.boxes, w.boxes)
        np.testing.assert_array_equal(g.labels, w.labels)
        assert g.labels.dtype == w.labels.dtype
    # the crowd box and the zero-width box are gone from the records
    assert len(got.records[0].boxes) == len(
        [a for a in got._raw_annotations[1] if not a.get("iscrowd")])


def test_coco_masks_wait_for_the_mask_head(synth):
    """Polygons load since Mask R-CNN (tests/test_torch_port_mask.py),
    keypoints since Keypoint R-CNN (tests/test_torch_port_keypoint.py): a
    dataset without them gives each kept instance 17 zero keypoints, as
    the JAX package's does."""
    got = coco.COCODataset(*synth, with_keypoints=True)
    want = jcoco.COCODataset(*synth, with_keypoints=True)
    for g, w in zip(got.records, want.records):
        assert g.keypoints.shape == (len(g.labels), 17, 3)
        np.testing.assert_array_equal(g.keypoints, w.keypoints)
        assert not g.keypoints.any()


def test_list_dataset_matches_jax(synth):
    from paa_tpu.data.list_dataset import ListDataset as JListDataset

    _, img_dir = synth
    names = ["000000.ppm", "000001.ppm"]
    got, want = ListDataset(names, img_dir), JListDataset(names, img_dir)
    for g, w in zip(got.records, want.records):
        assert (g.width, g.height) == (w.width, w.height)
        np.testing.assert_array_equal(g.boxes, w.boxes)
    np.testing.assert_array_equal(got.load_image(1), want.load_image(1))


def _cfgs(extra=()):
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.merge_from_list(CFG + list(extra))
        c.freeze()
    return jcfg, cfg


def _catalog(tmp_path, ann_file, img_dir, factory="COCODataset"):
    path = tmp_path / "catalog.py"
    path.write_text(
        "class DatasetCatalog:\n"
        "    @staticmethod\n"
        "    def get(name):\n"
        f"        return dict(factory={factory!r}, args=dict(\n"
        f"            root={img_dir!r}, ann_file={ann_file!r}))\n")
    return str(path)


def test_build_dataset_through_the_catalog(synth, tmp_path):
    _, cfg = _cfgs(["PATHS_CATALOG", _catalog(tmp_path, *synth)])
    assert len(build_dataset(cfg, ("a",), is_train=True)) == 11
    assert len(build_dataset(cfg, ("a",), is_train=False)) == 12
    assert len(build_dataset(cfg, ("a", "b"), is_train=True)) == 22
    assert len(build_dataset(cfg, ("a", "b"), is_train=False)) == 2


def test_build_dataset_voc_waits(tmp_path):
    """The Pascal VOC factory, which raised until the VOC slice was
    ported (hence the name), builds through a catalog: the eval dataset
    with its difficult objects, a training name list concatenated."""
    from paa_tpu_torch.data.synth import synth_voc
    from paa_tpu_torch.data.voc import PascalVOCDataset

    root = synth_voc(str(tmp_path / "VOC2007"), 4)
    path = tmp_path / "catalog.py"
    path.write_text(
        "class DatasetCatalog:\n"
        "    @staticmethod\n"
        "    def get(name):\n"
        "        return dict(factory='PascalVOCDataset', args=dict(\n"
        f"            data_dir={root!r}, split=name.split('_')[-1]))\n")
    _, cfg = _cfgs(["PATHS_CATALOG", str(path)])
    test = build_dataset(cfg, ("voc_2007_test",), is_train=False)
    assert isinstance(test, PascalVOCDataset) and test.keep_difficult
    assert len(test) == 4 and len(test.records[1].labels) > 0
    train = build_dataset(cfg, ("voc_2007_train", "voc_2007_val"),
                          is_train=True)
    assert len(train) == 4 and len(train.records[1].labels) == 0


# ---- batches and loaders ---------------------------------------------------

def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("device_normalize", [True, False])
def test_make_batch_matches_jax(device_normalize):
    rng = np.random.RandomState(4)
    samples = []
    for i, (h, w) in enumerate([(64, 90), (60, 96)]):
        samples.append(dict(
            image=_rand_image(rng, h, w, 3), image_id=i + 1,
            boxes=rng.uniform(0, 60, (3 + i, 4)).astype(np.float32),
            labels=rng.randint(1, 81, 3 + i).astype(np.int32),
            orig_size=(h * 2, w * 2)))
    args = ((64, 96), 4)
    kw = dict(normalize=(MEAN, STD), device_normalize=device_normalize)
    _assert_batches_equal([loader.make_batch(samples, *args, **kw)],
                          [jloader.make_batch(samples, *args, **kw)])


@pytest.mark.parametrize("device_normalize", [True, False])
def test_eval_loader_matches_jax(synth, device_normalize):
    """Every batch and key, both buckets, and the short tails padded with
    image_id -1."""
    jcfg, cfg = _cfgs(["TPU.DEVICE_NORMALIZE", device_normalize])
    got = list(loader.make_data_loader(
        cfg, coco.COCODataset(*synth, False), is_train=False))
    want = list(jloader.make_data_loader(
        jcfg, jcoco.COCODataset(*synth, False), is_train=False))
    _assert_batches_equal(got, want)
    assert {b["images"].shape[1:3] for b in got} == {(64, 96), (96, 64)}
    ids = np.concatenate([b["image_ids"] for b in got])
    assert (ids == -1).sum() > 0 and sorted(ids[ids >= 0]) == \
        list(range(1, 12)) + [99]


def test_train_loader_matches_jax(synth):
    """Three iterations of the seeded train stream (flips and sizes
    drawn per sample) and its predicted buckets."""
    jcfg, cfg = _cfgs()
    got_loader = loader.make_data_loader(cfg, coco.COCODataset(*synth),
                                         is_train=True, seed=5)
    want_loader = jloader.make_data_loader(jcfg, jcoco.COCODataset(*synth),
                                           is_train=True, seed=5)
    got, want = list(got_loader), list(want_loader)
    assert len(got) == 3
    _assert_batches_equal(got, want)
    for epoch in (0, 1):
        for idx in range(11):
            assert got_loader._draws(epoch, idx) == \
                want_loader._draws(epoch, idx)
            assert got_loader._predicted_bucket(idx, epoch) == \
                want_loader._predicted_bucket(idx, epoch)


def test_loader_raises_what_a_load_raised(synth):
    _, cfg = _cfgs()
    ds = coco.COCODataset(*synth, False)
    ds.records[4].file_name = "missing.ppm"
    with pytest.raises(FileNotFoundError, match="missing.ppm"):
        list(loader.make_data_loader(cfg, ds, is_train=False))


def test_bucket_assigner_matches_jax():
    buckets = ((64, 96), (96, 64), (128, 128))
    got, want = loader.BucketAssigner(buckets), jloader.BucketAssigner(
        buckets)
    for h, w in [(64, 96), (60, 60), (96, 10), (100, 100), (1, 1)]:
        assert got.assign(h, w) == want.assign(h, w)
    with pytest.raises(ValueError):
        got.assign(200, 10)


# ---- the loader feeds do_train -------------------------------------------

def test_do_train_runs_from_the_loader(synth):
    """Two iterations of the port's do_train on batches of
    make_data_loader(is_train=True), at a slim PAA-R50."""
    from paa_tpu_torch.engine import TrainState, do_train
    from paa_tpu_torch.modeling import build_detection_model
    from paa_tpu_torch.solver import make_optimizer

    torch.set_num_threads(1)
    _, cfg = _cfgs([
        "MODEL.PAA_ON", True, "MODEL.RPN_ONLY", True,
        "MODEL.BACKBONE.CONV_BODY", "R-50-FPN-RETINANET",
        "MODEL.RETINANET.USE_C5", False,
        "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 32,
        "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
        "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
        "MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
        "TPU.COMPUTE_DTYPE", "float32", "SOLVER.MAX_ITER", 2,
    ])
    model = build_detection_model(cfg, device="cpu", seed=0)
    state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
    seen = {}
    do_train(cfg, model, state,
             loader.make_data_loader(cfg, coco.COCODataset(*synth), True),
             logger=logging.getLogger("test"),
             metric_hook=lambda i, m: seen.update({i: m}))
    assert state.step == 2 and sorted(seen) == [1, 2]
    assert all(np.isfinite(v) for m in seen.values() for v in m.values())
