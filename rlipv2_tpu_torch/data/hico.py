"""HICO-DET dataset on the host (counterpart of rlipv2_tpu/data/hico.py:39-280;
reference `HICODetection`, datasets/hico.py:32-261, and `build`,
:529-623).

  * the annotation JSON schema (file_name, annotations [bbox, category_id],
    hoi_annotation [subject_id, object_id, category_id]);
  * COCO ids 1-90 remapped to 0-79 by VALID_OBJ_IDS;
  * one row per (subject, object) pair with multi-hot verbs;
  * train: boxes clamped to the image, degenerate boxes dropped, and the
    pairs whose boxes a crop dropped removed;
  * rare (< 10 training occurrences) and non-rare triplets, or for a
    zero-shot setting the unseen and seen triplets in their place;
  * correct_mat, and the annotation file for the zero-shot, few-shot and
    relation-noise settings;
  * the hooks of the datasets built on it (`data/vcoco.py`,
    `data/oi_sgg.py`): `rel_key`, `_obj_index` and `_verb_index` (the
    category id remaps), `num_verb_classes`, and `allow_no_object_pairs`:
    a GT `object_id` of -1 is a subject-only action, which trains against
    `no_object_class` with an all-zero object box and stays -1 in the val
    `hois` for the evaluator (JAX data/hico.py:40-45, :91-95, :142-157).

Images are read by `data/image_io.py` (JPEG through nvJPEG on `device`, so a
JPEG with device "cpu" raises) and augmented by `data/transforms.py` on
uint8 host tensors; items are (uint8 (h, w, 3) numpy image, target) as in
the JAX package, ready for `data/collate.py` and `evaluate_hoi`.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Optional

import numpy as np

from rlipv2_tpu_torch.data.image_io import ImageReader
from rlipv2_tpu_torch.data.transforms import HOITransform
from rlipv2_tpu_torch.data.vocab import (
    HICO_OBJECT_NAMES,
    HICO_VERB_NAMES,
    UNSEEN_HOI_IDX,
    VALID_OBJ_IDS,
    VALID_VERB_IDS,
)


class HICODataset:
    rel_key = "hoi_annotation"
    num_verb_classes = len(VALID_VERB_IDS)
    allow_no_object_pairs = False
    no_object_class = len(VALID_OBJ_IDS)

    def __init__(
        self,
        image_set: str,  # train | val
        img_folder,
        anno_file,
        num_queries: int = 100,
        transforms: Optional[HOITransform] = None,
        subject_category_id: int = 0,
        build_verb_hm: bool = False,
        device="cuda",
    ):
        if build_verb_hm:
            raise NotImplementedError("verb heatmap targets are not ported yet (ROADMAP queue 1 item 14)")
        self.image_set = image_set
        self.img_folder = Path(img_folder)
        with open(anno_file) as f:
            self.annotations = json.load(f)
        self.num_queries = num_queries
        self.transforms = transforms if transforms is not None else HOITransform(train=image_set == "train")
        self.subject_category_id = subject_category_id
        self.reader = ImageReader(device)

        if image_set == "train":
            n_boxes = [len(a["annotations"]) for a in self.annotations]
            self.ids = [
                idx for idx, anno in enumerate(self.annotations)
                if all(h["subject_id"] < n_boxes[idx] and h["object_id"] < n_boxes[idx]
                       for h in anno[self.rel_key])
            ]
        else:
            self.ids = list(range(len(self.annotations)))

        self.object_text = list(HICO_OBJECT_NAMES)
        self.verb_text = list(HICO_VERB_NAMES)
        self.rare_triplets: list = []
        self.non_rare_triplets: list = []
        self.correct_mat: Optional[np.ndarray] = None

    def _obj_index(self, category_id: int) -> int:
        return VALID_OBJ_IDS.index(category_id)

    def _verb_index(self, category_id: int) -> int:
        return VALID_VERB_IDS.index(category_id)

    def __len__(self):
        return len(self.ids)

    def load_image(self, file_name):
        """(H, W, 3) uint8 RGB host tensor."""
        return self.reader.read(self.img_folder / file_name)

    def __getitem__(self, idx):
        anno = self.annotations[self.ids[idx]]
        img = self.load_image(anno["file_name"])
        h, w = img.shape[:2]

        ann_list = anno["annotations"]
        if self.image_set == "train" and len(ann_list) > self.num_queries:
            ann_list = ann_list[: self.num_queries]
        boxes = np.asarray([obj["bbox"] for obj in ann_list], np.float32).reshape(-1, 4)
        classes = np.asarray([self._obj_index(obj["category_id"]) for obj in ann_list], np.int64)
        target = {"orig_size": np.array([h, w], np.int64), "filename": anno["file_name"]}

        if self.image_set != "train":
            # val: the GT stays in original pixels for the evaluator
            img, _ = self.transforms(img, {"boxes": np.zeros((0, 4), np.float32),
                                           "labels": np.zeros(0, np.int64)})
            hois = np.asarray(
                [(r["subject_id"], r["object_id"], self._verb_index(r["category_id"]))
                 for r in anno[self.rel_key]],
                np.int64,
            ).reshape(-1, 3)
            target.update(boxes=boxes, labels=classes, hois=hois, id=idx)
            return img.numpy(), target

        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
        keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
        t = {"boxes": boxes[keep], "labels": classes[keep], "box_indices": np.nonzero(keep)[0]}
        img, t = self.transforms(img, t)
        kept = list(t["box_indices"])

        obj_labels, verb_labels, sub_boxes, obj_boxes, pairs = [], [], [], [], []
        for hoi in anno[self.rel_key]:
            no_obj = self.allow_no_object_pairs and hoi["object_id"] == -1
            if hoi["subject_id"] not in kept or (not no_obj and hoi["object_id"] not in kept):
                continue
            pair = (hoi["subject_id"], hoi["object_id"])
            v_idx = self._verb_index(hoi["category_id"])
            if pair in pairs:
                verb_labels[pairs.index(pair)][v_idx] = 1.0
                continue
            pairs.append(pair)
            if no_obj:
                obj_labels.append(self.no_object_class)
                obj_boxes.append(np.zeros(4, np.float32))
            else:
                obj_labels.append(t["labels"][kept.index(hoi["object_id"])])
                obj_boxes.append(t["boxes"][kept.index(hoi["object_id"])])
            vl = np.zeros(self.num_verb_classes, np.float32)
            vl[v_idx] = 1.0
            verb_labels.append(vl)
            sub_boxes.append(t["boxes"][kept.index(hoi["subject_id"])])

        n = len(pairs)
        target.update(
            obj_labels=np.asarray(obj_labels, np.int64).reshape(n),
            sub_labels=np.full(n, self.subject_category_id, np.int64),
            verb_labels=np.stack(verb_labels) if n else np.zeros((0, self.num_verb_classes), np.float32),
            sub_boxes=np.asarray(sub_boxes, np.float32).reshape(n, 4),
            obj_boxes=np.asarray(obj_boxes, np.float32).reshape(n, 4),
            obj_classes=self.object_text,
            verb_classes=self.verb_text,
        )
        return img.numpy(), target

    def set_rare_hois(self, anno_file):
        """Triplets seen fewer than 10 times in `anno_file` are rare."""
        with open(anno_file) as f:
            annotations = json.load(f)
        counts = defaultdict(int)
        for anno in annotations:
            bboxes = anno["annotations"]
            for hoi in anno["hoi_annotation"]:
                triplet = (
                    VALID_OBJ_IDS.index(bboxes[hoi["subject_id"]]["category_id"]),
                    VALID_OBJ_IDS.index(bboxes[hoi["object_id"]]["category_id"]),
                    VALID_VERB_IDS.index(hoi["category_id"]),
                )
                counts[triplet] += 1
        self.rare_triplets = [t for t, c in counts.items() if c < 10]
        self.non_rare_triplets = [t for t, c in counts.items() if c >= 10]

    def set_seen_hois(self, zero_shot_setting: str, hoi_list_new_path):
        """Unseen triplets in `rare_triplets`, seen ones in
        `non_rare_triplets` (the reference reuses the two fields,
        datasets/hico.py:213-242)."""
        unseen = UNSEEN_HOI_IDX[zero_shot_setting]
        with open(hoi_list_new_path) as f:
            hoi_list = json.load(f)

        def triplet(i):
            return (0, VALID_OBJ_IDS.index(hoi_list[i]["object_cat"]), VALID_VERB_IDS.index(hoi_list[i]["verb_id"]))

        unseen_set = set(unseen)
        self.rare_triplets = [triplet(u) for u in unseen]
        self.non_rare_triplets = [triplet(s) for s in range(600) if s not in unseen_set]

    def load_correct_mat(self, path):
        self.correct_mat = np.load(path)

    def close(self) -> None:
        self.reader.close()


def hico_annotation_file(root: Path, zero_shot_setting: Optional[str] = None, few_shot_transfer: int = 100,
                         relation_label_noise: int = 0) -> Path:
    """The train annotation file of a setting (reference datasets/hico.py:529-623)."""
    annotations = Path(root) / "annotations"
    if few_shot_transfer in (1, 10):
        return annotations / f"trainval_hico_{few_shot_transfer}percent.json"
    if few_shot_transfer != 100:
        raise ValueError(f"few_shot_transfer is 1, 10 or 100, not {few_shot_transfer}")
    if zero_shot_setting is not None:
        return annotations / f"trainval_hico_{zero_shot_setting}.json"
    if relation_label_noise:
        return annotations / f"trainval_hico_{relation_label_noise}relation_noise.json"
    return annotations / "trainval_hico.json"


def build_hico(
    image_set: str,
    hoi_path,
    num_queries: int = 100,
    zero_shot_setting: Optional[str] = None,
    few_shot_transfer: int = 100,
    relation_label_noise: int = 0,
    device="cuda",
    transforms: Optional[HOITransform] = None,
) -> HICODataset:
    """The train or val split of the HICO-DET tree at `hoi_path`
    (images/{train2015,test2015}, annotations/*.json, corre_hico.npy)."""
    root = Path(hoi_path)
    if image_set == "train":
        img_folder = root / "images" / "train2015"
        anno_file = hico_annotation_file(root, zero_shot_setting, few_shot_transfer, relation_label_noise)
    elif image_set == "val":
        img_folder, anno_file = root / "images" / "test2015", root / "annotations" / "test_hico.json"
    else:
        raise ValueError(f"image_set is 'train' or 'val', not {image_set!r}")
    ds = HICODataset(image_set, img_folder, anno_file, num_queries, transforms=transforms, device=device)
    if image_set == "val":
        if zero_shot_setting is None:
            ds.set_rare_hois(root / "annotations" / "trainval_hico.json")
        else:
            ds.set_seen_hois(zero_shot_setting, root / "annotations" / "hoi_list_new.json")
        ds.load_correct_mat(root / "annotations" / "corre_hico.npy")
    return ds
