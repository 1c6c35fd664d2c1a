"""COCO readers of the R-Tagger's inputs (counterpart of
rlipv2_tpu/data/coco.py:45-190; reference datasets/coco.py). The COCO JSON is parsed directly, without pycocotools.

  * `CocoDetectionDataset`: a COCO-format detection file; crowd boxes
    dropped, xywh boxes made xyxy and clamped to the image, degenerate ones
    dropped, category ids mapped to a contiguous label space in id order
    (`object_names`).
  * `CocoRelDataset`: the tagger's input, each image with its relation
    candidates, the groups `[[pairs, rel_texts], ...]` of a
    `vg_rel_texts_for_*_images` JSON keyed by str(image_id); images without
    candidates are dropped.
  * `build_coco_rlip`: pre-training on pseudo-labelled COCO is the VG
    reader (`data/vg.py::VGRelDataset`) over the tagger's VG-format output.

Images are read by `data/image_io.py` (JPEG through nvJPEG on `device`, PNG
on the host) and, with `transforms`, augmented by `data/transforms.py`; the
boxes are then normalized cxcywh, without them xyxy pixels. Items are
(uint8 (h, w, 3) numpy image, target), where the JAX reader gives a float
image unless its transforms say `normalize=False`.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from rlipv2_tpu_torch.data.image_io import ImageReader
from rlipv2_tpu_torch.data.transforms import normalize_boxes


class CocoDetectionDataset:
    def __init__(self, img_folder, ann_file, transforms=None, device="cuda"):
        self.img_folder = Path(img_folder)
        self.transforms = transforms
        self.reader = ImageReader(device)
        coco = json.loads(Path(ann_file).read_text())
        self.images = {im["id"]: im for im in coco["images"]}
        self.categories = {c["id"]: c["name"] for c in coco.get("categories", [])}
        self.cat_ids = sorted(self.categories)
        self._cat_to_contig = {c: i for i, c in enumerate(self.cat_ids)}
        self.object_names = [self.categories[c] for c in self.cat_ids]
        self.anns: dict = {im_id: [] for im_id in self.images}
        for a in coco.get("annotations", []):
            if a.get("iscrowd", 0) != 1:
                self.anns.setdefault(a["image_id"], []).append(a)
        self.ids = sorted(self.images)

    def __len__(self):
        return len(self.ids)

    def _target(self, image_id: int, h: int, w: int) -> dict:
        boxes, labels = [], []
        for a in self.anns.get(image_id, []):
            x, y, bw, bh = a["bbox"]
            x0, y0 = min(max(x, 0.0), w), min(max(y, 0.0), h)
            x1, y1 = min(max(x + bw, 0.0), w), min(max(y + bh, 0.0), h)
            if x1 > x0 and y1 > y0:
                boxes.append([x0, y0, x1, y1])
                labels.append(self._cat_to_contig.get(a["category_id"], a["category_id"]))
        return {"image_id": image_id, "orig_size": np.array([h, w], np.int64),
                "boxes": np.asarray(boxes, np.float32).reshape(-1, 4), "labels": np.asarray(labels, np.int64)}

    def __getitem__(self, idx: int):
        image_id = self.ids[idx]
        img = self.reader.read(self.img_folder / self.images[image_id]["file_name"])
        h, w = img.shape[:2]
        target = self._target(image_id, h, w)
        if self.transforms is not None:
            img, target = self.transforms(img, target)
            target["boxes"] = normalize_boxes(target["boxes"], img.shape[0], img.shape[1])
        return img.numpy(), target

    def close(self) -> None:
        self.reader.close()


class CocoRelDataset(CocoDetectionDataset):
    """Each item's target carries `relation_candidates`, a list of
    (pairs, rel_texts) groups, pairs (subject, object) indices into its
    boxes (reference datasets/coco.py:258-287)."""

    def __init__(self, img_folder, ann_file, rel_candidates_file, transforms=None, device="cuda"):
        super().__init__(img_folder, ann_file, transforms, device)
        if isinstance(rel_candidates_file, dict):
            self.img_rels = rel_candidates_file
        else:
            self.img_rels = json.loads(Path(rel_candidates_file).read_text())
        self.ids = [i for i in self.ids if str(i) in self.img_rels]

    def __getitem__(self, idx: int):
        img, target = super().__getitem__(idx)
        target["relation_candidates"] = [(list(map(tuple, pairs)), list(rels))
                                         for pairs, rels in self.img_rels[str(target["image_id"])]]
        return img, target


def build_coco_rlip(anno_file, img_folders: dict, num_queries: int, transforms=None,
                    relation_threshold: float = 0.0, pair_overlap: bool = False, device="cuda"):
    """Pre-training on pseudo-labelled COCO: the VG reader over a VG-format
    JSON of tagger relationships with their `confidence` (reference
    datasets/coco.py:46-240 `CocoRLIPDetection`)."""
    from rlipv2_tpu_torch.data.vg import VGRelDataset

    return VGRelDataset(anno_file, img_folders, num_queries=num_queries, transforms=transforms,
                        relation_threshold=relation_threshold, pair_overlap=pair_overlap, device=device)
