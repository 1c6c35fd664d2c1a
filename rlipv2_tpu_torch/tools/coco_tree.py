"""A COCO tree written from a seed, the R-Tagger's input where COCO and the
BLIP relation candidates are not at hand (`chip_smoke.py` phase 12 and the
CPU tests).

`write_coco_tree(root, images, n_images, seed)` writes, in COCO's layout:
  * train2017/{image_id:012}.jpg, copies of the given image files in turn
    (the reader sniffs the format, so PNG bytes may stand under a .jpg
    name), which is also where `--dataset_file pretrain` looks for
    `dataset: "coco2017"` images with `--coco2017_folder root`;
  * annotations/instances_train2017.json: the 80 COCO categories with
    their ids and names, every image's `height` and `width`, and instances
    with xywh `bbox`es; about CROWD of them `iscrowd`;
  * vg_rel_texts_for_coco_images.json, the relation candidates in the
    reference's `{str(image_id): [[pairs, rel_texts], ...]}` form: groups
    of (subject, object) indices into the image's kept boxes (in the
    instances' order, crowd boxes skipped) with candidate relation texts
    drawn from `n_predicates` made-up predicates (`vg_tree.label_names`);
    every SKIPPED-th image has none, so that the reader drops it.

The instances an image are negative-binomial around COCO train2017's
published mean, 7.3 (860,001 instances over 118,287 images, Lin et al.,
"Microsoft COCO", ECCV 2014, and the 2017 release's files); the spread,
the crowd share, the candidate groups an image (GROUPS), their pairs
(PAIRS) and their texts (TEXTS) are assumptions, not fits to COCO or to
the BLIP candidates. Returns the paths and "texts", every label text the
tagger's slots can take, for `tools/hico_tree.py::write_label_tokenizer`.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Sequence

import numpy as np

from rlipv2_tpu_torch.data.vocab import HICO_OBJECT_NAMES, VALID_OBJ_IDS
from rlipv2_tpu_torch.tools.vg_tree import label_names

MEAN_INSTANCES, INSTANCES_SHAPE = 7.3, 3  # COCO train2017's mean; the shape assumed
CROWD = 0.01
GROUPS, PAIRS, TEXTS = (1, 4), (1, 6), (2, 8)  # candidate groups an image, pairs and texts a group
SKIPPED = 7


def write_coco_tree(root, images: Sequence[tuple], n_images: int = 48, n_predicates: int = 120,
                    seed: int = 0) -> dict:
    """images: (source image path, height, width) per entry, used in turn.
    Returns {"img_folder", "ann_file", "rel_candidates", "coco2017_folder",
    "texts"}."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    predicates = label_names(n_predicates, rng, words=(1, 3))
    img_folder = root / "train2017"
    img_folder.mkdir(parents=True, exist_ok=True)
    coco = {"images": [], "annotations": [],
            "categories": [{"id": int(c), "name": n} for c, n in zip(VALID_OBJ_IDS, HICO_OBJECT_NAMES)]}
    candidates = {}
    for k in range(n_images):
        src, h, w = images[k % len(images)]
        image_id = 1 + k
        name = f"{image_id:012d}.jpg"
        shutil.copyfile(src, img_folder / name)
        coco["images"].append({"id": image_id, "file_name": name, "height": int(h), "width": int(w)})
        n = 1 + int(rng.negative_binomial(INSTANCES_SHAPE, INSTANCES_SHAPE / (INSTANCES_SHAPE + MEAN_INSTANCES - 1)))
        kept = 0
        for _ in range(n):
            bw, bh = rng.uniform(0.08, 0.6) * w, rng.uniform(0.08, 0.6) * h
            crowd = int(rng.rand() < CROWD)
            coco["annotations"].append({
                "id": len(coco["annotations"]) + 1, "image_id": image_id, "iscrowd": crowd,
                "category_id": int(VALID_OBJ_IDS[rng.randint(len(VALID_OBJ_IDS))]),
                "bbox": [round(float(rng.uniform(0, w - bw)), 2), round(float(rng.uniform(0, h - bh)), 2),
                         round(float(bw), 2), round(float(bh), 2)]})
            kept += 1 - crowd
        if k % SKIPPED == SKIPPED - 1 or kept < 2:
            continue
        pairs_all = [[i, j] for i in range(kept) for j in range(kept) if i != j]
        groups = []
        for _ in range(rng.randint(GROUPS[0], GROUPS[1] + 1)):
            m = min(rng.randint(PAIRS[0], PAIRS[1] + 1), len(pairs_all))
            pairs = [pairs_all[i] for i in rng.choice(len(pairs_all), m, replace=False)]
            texts = [predicates[i] for i in rng.choice(n_predicates, rng.randint(TEXTS[0], TEXTS[1] + 1),
                                                       replace=False)]
            groups.append([pairs, texts])
        candidates[str(image_id)] = groups
    ann_dir = root / "annotations"
    ann_dir.mkdir(parents=True, exist_ok=True)
    ann_file = ann_dir / "instances_train2017.json"
    ann_file.write_text(json.dumps(coco))
    rel_file = root / "vg_rel_texts_for_coco_images.json"
    rel_file.write_text(json.dumps(candidates))
    return {"img_folder": img_folder, "ann_file": ann_file, "rel_candidates": rel_file, "coco2017_folder": root,
            "texts": list(HICO_OBJECT_NAMES) + predicates}
