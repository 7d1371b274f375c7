"""Concatenation of datasets sharing the ImageRecord layout (a copy of
paa_tpu/data/concat.py; the reference relies on
torch.utils.data.ConcatDataset via data/build.py:44-46)."""

from __future__ import annotations


class ConcatDataset:
    def __init__(self, datasets):
        assert datasets
        self.datasets = list(datasets)
        base = self.datasets[0]
        self.contiguous_category_id_to_json_id = getattr(
            base, "contiguous_category_id_to_json_id", None
        )
        self.json_category_id_to_contiguous_id = getattr(
            base, "json_category_id_to_contiguous_id", None
        )
        self.records = []
        self._origin = []  # (dataset_idx, local_idx)
        for di, ds in enumerate(self.datasets):
            for li, r in enumerate(ds.records):
                self.records.append(r)
                self._origin.append((di, li))

    def __len__(self):
        return len(self.records)

    def load_image(self, index):
        di, li = self._origin[index]
        return self.datasets[di].load_image(li)

    def image_path(self, index):
        di, li = self._origin[index]
        return self.datasets[di].image_path(li)

    def get_img_info(self, index):
        di, li = self._origin[index]
        return self.datasets[di].get_img_info(li)
