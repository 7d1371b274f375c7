"""Convert Cityscapes instance annotations to COCO-format json (a copy of
tools/cityscapes/convert_cityscapes_to_coco.py, which imports neither
package).

    python -m paa_tpu_torch.tools.cityscapes.convert_cityscapes_to_coco \\
        --datadir CITYSCAPES_ROOT [--split train|val|test] --outdir DIR

Plays the role of the reference's tools/cityscapes converters
(convert_cityscapes_to_coco.py): walks gtFine/<split>, reads the
*_polygons.json files, keeps the 8 instance classes, and emits a COCO
instances json (polygons as ``segmentation``) that the port's
``COCODataset`` reads, with ``with_masks=True`` for Mask R-CNN, with
leftImg8bit/<split> as its image root. Touches no device.
"""

import argparse
import glob
import json
import os

INSTANCE_CLASSES = [
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
]


def poly_to_bbox(poly):
    xs = [p[0] for p in poly]
    ys = [p[1] for p in poly]
    x1, y1 = min(xs), min(ys)
    return [x1, y1, max(xs) - x1, max(ys) - y1]


def poly_area(poly):
    area = 0.0
    n = len(poly)
    for i in range(n):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % n]
        area += x1 * y2 - x2 * y1
    return abs(area) / 2.0


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--datadir", required=True,
                        help="cityscapes root (contains gtFine/, leftImg8bit/)")
    parser.add_argument("--split", default="train",
                        choices=["train", "val", "test"])
    parser.add_argument("--outdir", required=True)
    args = parser.parse_args(argv)

    cat_id = {name: i + 1 for i, name in enumerate(INSTANCE_CLASSES)}
    images, annotations = [], []
    ann_id = 1
    img_id = 0

    pattern = os.path.join(
        args.datadir, "gtFine", args.split, "*", "*_polygons.json"
    )
    for path in sorted(glob.glob(pattern)):
        with open(path) as f:
            data = json.load(f)
        img_id += 1
        city = os.path.basename(os.path.dirname(path))
        base = os.path.basename(path).replace(
            "_gtFine_polygons.json", "_leftImg8bit.png"
        )
        images.append(
            dict(
                id=img_id,
                file_name=os.path.join(city, base),
                width=data["imgWidth"],
                height=data["imgHeight"],
            )
        )
        for obj in data.get("objects", []):
            label = obj["label"]
            group = label.endswith("group")
            if group:
                label = label[: -len("group")]
            if label not in cat_id:
                continue
            poly = obj["polygon"]
            flat = [float(v) for pt in poly for v in pt]
            annotations.append(
                dict(
                    id=ann_id,
                    image_id=img_id,
                    category_id=cat_id[label],
                    segmentation=[flat],
                    bbox=poly_to_bbox(poly),
                    area=poly_area(poly),
                    iscrowd=1 if group else 0,
                )
            )
            ann_id += 1

    categories = [
        dict(id=i + 1, name=n) for i, n in enumerate(INSTANCE_CLASSES)
    ]
    os.makedirs(args.outdir, exist_ok=True)
    out = os.path.join(
        args.outdir, f"instancesonly_filtered_gtFine_{args.split}.json"
    )
    with open(out, "w") as f:
        json.dump(
            dict(images=images, annotations=annotations,
                 categories=categories), f
        )
    print(f"wrote {out}: {len(images)} images, {len(annotations)} anns")


if __name__ == "__main__":
    main()
