"""Batched, bucketed data loading (port of paa_tpu/data/loader.py).

Replaces the reference's DataLoader stack (paa_core/data/build.py:107-177:
DistributedSampler -> GroupedBatchSampler -> IterationBasedBatchSampler
-> torch DataLoader workers -> BatchCollator pad-to-batch-max) with the
JAX package's design: images are resized, then padded into a small,
fixed set of size buckets (cfg.TPU.TRAIN_BUCKETS / TEST_BUCKETS).
Detections depend on the padded size (the features at the pad border),
so the port pads to the same bucket as the JAX package, never to the
batch maximum.

The reference's aspect-ratio grouping (build.py:85-104, two bins) maps
onto bucket grouping: batches are formed within a bucket. The
iteration-based infinite sampler with epoch-seeded shuffling mirrors
samplers/iteration_based_batch_sampler.py + distributed.py. Decoding and
resizing run in a thread pool (the numpy PPM read and the torch resize
release the GIL) with batch prefetch. For Mask R-CNN training each
sample's polygons are rasterized in its boxes' frames
(structures/masks.py ``rasterize_instances``, no cv2) and the batch
carries them as 'gt_masks' (B, MAX_GT, 112, 112) uint8. For Keypoint
R-CNN training each sample's keypoints follow its resize and flip
(data/transforms.py) and the batch carries them as 'gt_keypoints'
(B, MAX_GT, K, 3) float32, zero in the padding slots.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence, Tuple

import numpy as np

from ..structures.masks import rasterize_instances
from .transforms import build_transforms, get_resize_size, normalize_image


class BucketAssigner:
    """Assigns a resized (h, w) to the smallest bucket that contains it."""

    def __init__(self, buckets: Sequence[Tuple[int, int]]):
        self.buckets = [tuple(b) for b in buckets]
        order = np.argsort([h * w for h, w in self.buckets])
        self._by_area = [self.buckets[i] for i in order]

    def assign(self, h, w):
        for bh, bw in self._by_area:
            if h <= bh and w <= bw:
                return (bh, bw)
        raise ValueError(
            f"image of resized size ({h}, {w}) fits no bucket "
            f"{self.buckets}; add a larger bucket to cfg.TPU.*_BUCKETS"
        )


def make_batch(samples, bucket_hw, max_gt, normalize=None,
               device_normalize=False):
    """Assemble transformed samples into fixed-shape arrays.

    samples: list of dicts with image (HWC), boxes, labels, image_id,
    orig_size (h, w), and optionally masks (n, M, M) and keypoints (n,
    K, 3). Short batches are padded with zero images and image_id -1.
    When a sample has masks the batch has 'gt_masks' (B, max_gt, M, M)
    uint8, when one has keypoints 'gt_keypoints' (B, max_gt, K, 3)
    float32 (K of the first sample with any, else 17), each zero in the
    padding slots.

    normalize: optional (pixel_mean, pixel_std): samples then carry RAW
    uint8 images and (x - mean)/std is computed straight into the
    padded float32 batch buffer.

    device_normalize: emit the batch's images as RAW padded uint8 and
    leave normalization to the eval function or train step
    (ops/image_norm.py): 4x less host->device traffic, the same values.
    """
    bsz = len(samples)
    bh, bw = bucket_hw
    images = np.zeros(
        (bsz, bh, bw, 3),
        dtype=np.uint8 if device_normalize else np.float32,
    )
    gt_boxes = np.zeros((bsz, max_gt, 4), dtype=np.float32)
    gt_labels = np.zeros((bsz, max_gt), dtype=np.int32)
    image_sizes = np.zeros((bsz, 2), dtype=np.float32)
    orig_sizes = np.zeros((bsz, 2), dtype=np.float32)
    image_ids = np.full((bsz,), -1, dtype=np.int64)
    gt_masks = None
    masked = [s["masks"] for s in samples if s.get("masks") is not None]
    if masked:
        gt_masks = np.zeros((bsz, max_gt, *masked[0].shape[1:]), np.uint8)
    gt_keypoints = None
    kps = [s["keypoints"] for s in samples if s.get("keypoints") is not None]
    if kps:
        k = next((p.shape[1] for p in kps if len(p)), 17)
        gt_keypoints = np.zeros((bsz, max_gt, k, 3), np.float32)

    for i, s in enumerate(samples):
        img = s["image"]
        h, w = img.shape[:2]
        if device_normalize:
            images[i, :h, :w] = img  # raw uint8 (sentinel f32 zeros cast)
        elif normalize is not None and img.dtype == np.uint8:
            normalize_image(img, *normalize, out=images[i, :h, :w])
        else:
            images[i, :h, :w] = img
        image_sizes[i] = (h, w)
        orig_sizes[i] = s["orig_size"]
        image_ids[i] = s["image_id"]
        boxes, labels = s["boxes"], s["labels"]
        n = min(len(labels), max_gt)
        if n:
            gt_boxes[i, :n] = boxes[:n]
            gt_labels[i, :n] = labels[:n]
            if gt_masks is not None and s.get("masks") is not None:
                gt_masks[i, :n] = s["masks"][:n]
            if gt_keypoints is not None and s.get("keypoints") is not None:
                gt_keypoints[i, :n] = s["keypoints"][:n]
    batch = {
        "images": images,
        "gt_boxes": gt_boxes,
        "gt_labels": gt_labels,
        "image_sizes": image_sizes,
        "orig_sizes": orig_sizes,
        "image_ids": image_ids,
    }
    if gt_masks is not None:
        batch["gt_masks"] = gt_masks
    if gt_keypoints is not None:
        batch["gt_keypoints"] = gt_keypoints
    return batch


class DetectionLoader:
    """Iterates fixed-shape batches over a COCO-style dataset."""

    def __init__(self, dataset, transform, buckets, batch_size, max_gt,
                 is_train=True, seed=0, num_threads=4, prefetch=2,
                 start_iter=0, max_iter=None, process_count=1,
                 process_index=0, normalize=None, device_normalize=False):
        """``batch_size`` is the GLOBAL batch; with ``process_count`` > 1
        every process computes the identical global batch/bucket stream
        (deterministic seed + per-(epoch, index) augmentation draws).
        Training loads only the ``process_index``-th interleaved slice of
        each batch: the reference's DistributedSampler
        (paa_core/data/samplers/distributed.py:10-66), with the bucket
        shapes kept equal across processes. Evaluation loads whole
        batches, every ``process_count``-th one from the
        ``process_index``-th, so that each batch keeps the composition
        it has in one process (the round robin of
        paa_tpu/engine/inference.py:85-88, with no rank loading a batch
        it does not run)."""
        self.dataset = dataset
        self.transform = transform
        self.assigner = BucketAssigner(buckets)
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.is_train = is_train
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.start_iter = start_iter
        self.max_iter = max_iter
        if is_train and batch_size % process_count:
            raise ValueError(
                f"global batch {batch_size} not divisible by "
                f"{process_count} processes")
        self.process_count = process_count
        self.process_index = process_index
        self.normalize = normalize
        self.device_normalize = device_normalize

    def _predicted_bucket(self, idx, epoch):
        """Exact bucket for a sample, computed WITHOUT loading the image:
        the resize rule is deterministic given the record's size and the
        (deterministic) size draw, so every process predicts the same
        bucket. The transform is a TrainTransform or an EvalTransform."""
        r = self.dataset.records[idx]
        t = self.transform
        if self.is_train and hasattr(t, "min_sizes"):
            size_draw, _ = self._draws(epoch, idx)
            chosen = t.min_sizes[int(size_draw * len(t.min_sizes))]
        else:
            chosen = t.min_size
        oh, ow = get_resize_size((r.width, r.height), chosen, t.max_size)
        return self.assigner.assign(oh, ow)

    def bucket_counts(self, epoch=0):
        """{bucket: images of the dataset it gets} in ``epoch``: a batch
        forms within one bucket."""
        counts = {}
        for idx in range(len(self.dataset)):
            b = self._predicted_bucket(idx, epoch)
            counts[b] = counts.get(b, 0) + 1
        return counts

    def _draws(self, epoch, index):
        """Deterministic per-(epoch, sample) augmentation draws."""
        rng = np.random.RandomState(
            (self.seed * 1000003 + epoch * 9973 + index) % (2 ** 31)
        )
        return rng.random_sample(), rng.random_sample()

    def _load_sample(self, index, epoch=0):
        if index < 0:  # eval tail padding sentinel
            return {
                "image": np.zeros((1, 1, 3), dtype=np.float32),
                "boxes": np.zeros((0, 4), dtype=np.float32),
                "labels": np.zeros((0,), dtype=np.int64),
                "image_id": -1,
                "orig_size": (1, 1),
            }
        r = self.dataset.records[index]
        masks = None
        if getattr(r, "polygons", None) is not None:
            # box-normalized masks: the resize leaves them as they are,
            # the flip flips them with the image
            masks = rasterize_instances(r.polygons, r.boxes,
                                        max(len(r.labels), 1)
                                        )[:len(r.labels)]
        keypoints = getattr(r, "keypoints", None)
        out = self.transform(
            self.dataset.load_image(index), r.boxes.copy(),
            draws=self._draws(epoch, index) if self.is_train else None,
            masks=masks, keypoints=keypoints,
        )
        image, boxes, *rest = out
        return {
            "image": image,
            "boxes": boxes if boxes is not None else np.zeros((0, 4)),
            "labels": r.labels.copy(),
            "masks": rest.pop(0) if masks is not None else None,
            "keypoints": rest.pop(0) if keypoints is not None else None,
            "image_id": r.id,
            "orig_size": (r.height, r.width),
        }

    def _batches_of_indices(self):
        """Yields (epoch, bucket, global_indices); deterministic given
        (seed, start_iter) so all processes agree on the stream."""
        n = len(self.dataset)
        if self.is_train:
            # infinite, epoch-seeded shuffle, grouped by bucket
            # (IterationBasedBatchSampler + GroupedBatchSampler)
            it = 0
            epoch = 0
            while self.max_iter is None or it < self.max_iter:
                rng = np.random.RandomState(self.seed + epoch)
                perm = rng.permutation(n)
                pending = {}
                for idx in perm:
                    b = self._predicted_bucket(int(idx), epoch)
                    pending.setdefault(b, []).append(int(idx))
                    if len(pending[b]) == self.batch_size:
                        if it >= self.start_iter:
                            yield epoch, b, pending.pop(b)
                        else:
                            pending.pop(b)
                        it += 1
                        if self.max_iter is not None and it >= self.max_iter:
                            return
                epoch += 1
        else:
            # sequential, grouped by bucket, dropping nothing; tail
            # batches are padded to batch_size with sentinel index -1
            # (dummy image_id -1 samples) so every batch of a bucket has
            # one shape
            pending = {}
            batches = []
            for idx in range(n):
                b = self._predicted_bucket(idx, 0)
                pending.setdefault(b, []).append(idx)
                if len(pending[b]) == self.batch_size:
                    batches.append((0, b, pending.pop(b)))
            for b, rest in pending.items():
                if rest:
                    batches.append(
                        (0, b, rest + [-1] * (self.batch_size - len(rest))))
            yield from batches[self.process_index::self.process_count]

    def _assemble(self, epoch, group_bucket, indices, pool):
        # in training this process loads only its interleaved slice of
        # the global batch (all of it for process_count=1)
        local = (indices[self.process_index::self.process_count]
                 if self.is_train else indices)
        samples = list(
            pool.map(lambda i: self._load_sample(i, epoch), local)
        )
        # the bucket is the deterministic group key, NOT the realized
        # max size: all processes run the same shapes at every step
        for s in samples:
            h, w = s["image"].shape[:2]
            assert h <= group_bucket[0] and w <= group_bucket[1], (
                (h, w), group_bucket
            )
        return make_batch(
            samples, group_bucket, self.max_gt, normalize=self.normalize,
            device_normalize=self.device_normalize,
        )

    def __iter__(self):
        pool = ThreadPoolExecutor(max_workers=self.num_threads)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        failure = []

        def producer():
            try:
                for epoch, bucket, indices in self._batches_of_indices():
                    q.put(self._assemble(epoch, bucket, indices, pool))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                failure.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            pool.shutdown(wait=False)
        if failure:
            raise failure[0]


def process_count_and_index():
    """(world size, rank) of the process group (utils/comm.py), else
    (1, 0)."""
    from ..utils import comm

    return comm.get_world_size(), comm.get_rank()


def make_data_loader(cfg, dataset, is_train=True, start_iter=0, seed=0):
    transform = build_transforms(
        cfg, is_train=is_train, seed=seed, defer_normalize=True
    )
    buckets = (
        cfg.TPU.TRAIN_BUCKETS if is_train else cfg.TPU.TEST_BUCKETS
    )
    batch_size = (
        cfg.SOLVER.IMS_PER_BATCH if is_train else cfg.TEST.IMS_PER_BATCH
    )
    count, index = process_count_and_index()
    return DetectionLoader(
        dataset,
        transform,
        buckets,
        batch_size,
        cfg.TPU.MAX_GT,
        is_train=is_train,
        seed=seed,
        num_threads=cfg.DATALOADER.NUM_WORKERS,
        start_iter=start_iter,
        max_iter=cfg.SOLVER.MAX_ITER if is_train else None,
        process_count=count,
        process_index=index,
        normalize=(cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD),
        device_normalize=cfg.TPU.DEVICE_NORMALIZE,
    )
