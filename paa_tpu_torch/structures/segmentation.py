"""Polygon and binary-mask segmentation containers (port of
paa_tpu/structures/segmentation.py; reference
paa_core/structures/segmentation_mask.py: BinaryMaskList,
PolygonInstance, PolygonList, SegmentationMask), in numpy: per-instance
COCO polygons or (N, H, W) bitmasks with ``transpose`` (horizontal and
vertical flips, +1 pixel convention), ``crop``, ``resize``, conversion
between the two modes, indexing and iteration. The training pipeline
uses the fixed-size box-normalized bitmasks of structures/masks.py;
this container is the general one (tooling, the reference's API).

Polygons are rasterized by structures/masks.py's ``polygons_to_bitmask``
(cv2's ``fillPoly`` bit for bit, without cv2). A mask resize is cv2's
INTER_NEAREST in numpy (``resize_nearest``: source pixel floor(x *
(1 / (dst / src))), in float64, clamped to the last one), bit for bit.
Mask to polygon is cv2's ``findContours`` (CHAIN_APPROX_TC89_L1),
imported inside the call: it needs the cv2 package.
"""

from __future__ import annotations

import copy

import numpy as np

from .masks import polygons_to_bitmask

FLIP_LEFT_RIGHT = 0
FLIP_TOP_BOTTOM = 1
_TO_REMOVE = 1


def _nearest_taps(n_in, n_out):
    """cv2's INTER_NEAREST source index of each of ``n_out`` outputs:
    floor(i * (1 / (n_out / n_in))) in float64, at most n_in - 1."""
    inv = 1.0 / (n_out / n_in)
    return np.minimum(np.floor(np.arange(n_out) * inv).astype(np.int64),
                      n_in - 1)


def resize_nearest(masks, width, height):
    """``cv2.resize(m, (width, height), interpolation=INTER_NEAREST)``
    of each (H, W) mask of ``masks`` (N, H, W)."""
    _, h, w = masks.shape
    return masks[:, _nearest_taps(h, height)][:, :, _nearest_taps(w, width)]


class PolygonInstance:
    """Polygons of ONE instance (reference PolygonInstance)."""

    def __init__(self, polygons, size):
        if isinstance(polygons, PolygonInstance):
            polygons = copy.deepcopy(polygons.polygons)
        self.polygons = [
            np.asarray(p, dtype=np.float64).reshape(-1) for p in polygons
        ]
        self.size = tuple(size)  # (w, h)

    def transpose(self, method):
        w, h = self.size
        flipped = []
        for p in self.polygons:
            q = p.copy()
            if method == FLIP_LEFT_RIGHT:
                q[0::2] = w - p[0::2] - _TO_REMOVE
            elif method == FLIP_TOP_BOTTOM:
                q[1::2] = h - p[1::2] - _TO_REMOVE
            else:
                raise NotImplementedError(method)
            flipped.append(q)
        return PolygonInstance(flipped, self.size)

    def crop(self, box):
        # reference PolygonInstance.crop: clamp the BOX to the image,
        # shift coordinates (no per-point clipping), exclusive max
        w0, h0 = self.size
        x1, y1, x2, y2 = map(float, box)
        x1 = min(max(x1, 0), w0 - 1)
        y1 = min(max(y1, 0), h0 - 1)
        x2 = max(min(max(x2, 0), w0), x1 + 1)
        y2 = max(min(max(y2, 0), h0), y1 + 1)
        cropped = []
        for p in self.polygons:
            q = p.copy()
            q[0::2] = p[0::2] - x1
            q[1::2] = p[1::2] - y1
            cropped.append(q)
        return PolygonInstance(cropped, (x2 - x1, y2 - y1))

    def resize(self, size):
        rw = size[0] / max(self.size[0], 1e-8)
        rh = size[1] / max(self.size[1], 1e-8)
        out = []
        for p in self.polygons:
            q = p.copy()
            q[0::2] = p[0::2] * rw
            q[1::2] = p[1::2] * rh
            out.append(q)
        return PolygonInstance(out, size)

    def get_mask(self) -> np.ndarray:
        w, h = self.size
        return polygons_to_bitmask(
            [p.tolist() for p in self.polygons],
            int(round(h)), int(round(w)),
        )

    def __len__(self):
        return len(self.polygons)

    def __repr__(self):
        return (
            f"PolygonInstance(num_polygons={len(self.polygons)}, "
            f"size={self.size})"
        )


class PolygonList:
    """Per-image list of PolygonInstances (reference PolygonList)."""

    def __init__(self, instances, size):
        self.instances = [
            p if isinstance(p, PolygonInstance) else PolygonInstance(p, size)
            for p in instances
        ]
        self.size = tuple(size)

    def _map(self, fn, size=None):
        out = PolygonList.__new__(PolygonList)
        out.instances = [fn(p) for p in self.instances]
        out.size = tuple(size) if size is not None else self.size
        return out

    def transpose(self, method):
        return self._map(lambda p: p.transpose(method))

    def crop(self, box):
        out = [p.crop(box) for p in self.instances]
        size = out[0].size if out else self.size
        wrapped = PolygonList.__new__(PolygonList)
        wrapped.instances = out
        wrapped.size = size
        return wrapped

    def resize(self, size):
        return self._map(lambda p: p.resize(size), size)

    def convert_to_binarymask(self):
        if len(self.instances):
            masks = np.stack([p.get_mask() for p in self.instances])
        else:
            w, h = self.size
            masks = np.zeros((0, int(round(h)), int(round(w))), np.uint8)
        return BinaryMaskList(masks, self.size)

    def __len__(self):
        return len(self.instances)

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            selected = [self.instances[int(item)]]
        elif isinstance(item, slice):
            selected = self.instances[item]
        else:
            item = np.asarray(item)
            if item.dtype == bool:
                item = np.nonzero(item)[0]
            selected = [self.instances[int(i)] for i in item]
        return PolygonList(selected, self.size)

    def __iter__(self):
        return iter(self.instances)

    def __repr__(self):
        return (
            f"PolygonList(num_instances={len(self.instances)}, "
            f"size={self.size})"
        )


class BinaryMaskList:
    """(N, H, W) uint8 masks for all instances (reference
    BinaryMaskList)."""

    def __init__(self, masks, size):
        masks = np.asarray(masks)
        if masks.ndim == 2:
            masks = masks[None]
        self.masks = masks.astype(np.uint8)
        self.size = tuple(size)  # (w, h)

    def transpose(self, method):
        if method == FLIP_LEFT_RIGHT:
            return BinaryMaskList(self.masks[:, :, ::-1], self.size)
        if method == FLIP_TOP_BOTTOM:
            return BinaryMaskList(self.masks[:, ::-1], self.size)
        raise NotImplementedError(method)

    def crop(self, box):
        # reference BinaryMaskList.crop: round, clamp, exclusive max
        w, h = self.size
        x1, y1, x2, y2 = (int(round(float(v))) for v in box)
        x1 = min(max(x1, 0), int(w) - 1)
        y1 = min(max(y1, 0), int(h) - 1)
        x2 = max(min(max(x2, 0), int(w)), x1 + 1)
        y2 = max(min(max(y2, 0), int(h)), y1 + 1)
        cropped = self.masks[:, y1:y2, x1:x2]
        return BinaryMaskList(cropped, (x2 - x1, y2 - y1))

    def resize(self, size):
        w, h = (int(round(float(s))) for s in size)
        if len(self.masks) == 0:
            return BinaryMaskList(np.zeros((0, h, w), np.uint8), (w, h))
        return BinaryMaskList(resize_nearest(self.masks, w, h), (w, h))

    def convert_to_polygon(self):
        import cv2

        instances = []
        for m in self.masks:
            contours, _ = cv2.findContours(
                m.astype(np.uint8), cv2.RETR_EXTERNAL,
                cv2.CHAIN_APPROX_TC89_L1,
            )
            polys = [
                c.reshape(-1).astype(np.float64)
                for c in contours
                if c.size >= 6  # >= 3 points
            ]
            instances.append(PolygonInstance(polys, self.size))
        return PolygonList(instances, self.size)

    def get_mask_tensor(self):
        return self.masks.squeeze(0) if len(self.masks) == 1 else self.masks

    def __len__(self):
        return len(self.masks)

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            sel = self.masks[int(item)][None]
        else:
            item = np.asarray(item)
            if item.dtype == bool:
                item = np.nonzero(item)[0]
            sel = self.masks[item]
        return BinaryMaskList(sel, self.size)

    def __iter__(self):
        return iter(self.masks)

    def __repr__(self):
        return (
            f"BinaryMaskList(num_instances={len(self.masks)}, "
            f"size={self.size})"
        )


class SegmentationMask:
    """Mode-dispatching wrapper (reference SegmentationMask): holds a
    PolygonList ('poly') or BinaryMaskList ('mask') and forwards the op
    surface; ``convert`` switches representation."""

    def __init__(self, instances, size, mode="poly"):
        if mode == "poly":
            self.instances = (
                instances
                if isinstance(instances, PolygonList)
                else PolygonList(instances, size)
            )
        elif mode == "mask":
            self.instances = (
                instances
                if isinstance(instances, BinaryMaskList)
                else BinaryMaskList(instances, size)
            )
        else:
            raise NotImplementedError(mode)
        self.mode = mode
        self.size = tuple(size)

    def _wrap(self, inner):
        out = SegmentationMask.__new__(SegmentationMask)
        out.instances = inner
        out.mode = self.mode
        out.size = inner.size
        return out

    def transpose(self, method):
        return self._wrap(self.instances.transpose(method))

    def crop(self, box):
        return self._wrap(self.instances.crop(box))

    def resize(self, size, *args, **kwargs):
        return self._wrap(self.instances.resize(size))

    def convert(self, mode):
        if mode == self.mode:
            return self
        if mode == "poly":
            converted = self.instances.convert_to_polygon()
        elif mode == "mask":
            converted = self.instances.convert_to_binarymask()
        else:
            raise NotImplementedError(mode)
        out = SegmentationMask.__new__(SegmentationMask)
        out.instances = converted
        out.mode = mode
        out.size = converted.size
        return out

    def get_mask_tensor(self):
        return self.convert("mask").instances.get_mask_tensor()

    def __len__(self):
        return len(self.instances)

    def __getitem__(self, item):
        return self._wrap(self.instances[item])

    def __iter__(self):
        self._idx = 0
        return self

    def __next__(self):
        if self._idx < len(self):
            out = self[self._idx]
            self._idx += 1
            return out
        raise StopIteration

    def __repr__(self):
        return (
            f"SegmentationMask(num_instances={len(self)}, "
            f"size={self.size}, mode={self.mode})"
        )
