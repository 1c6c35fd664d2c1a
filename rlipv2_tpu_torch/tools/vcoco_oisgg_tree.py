"""V-COCO and Open Images v6 SGG trees written from a seed, for runs of their
loaders, evaluators and command-line paths where the real V-COCO, Open
Images and COCO files are not at hand (`chip_smoke.py` phase 11 and the CPU
tests). The trees are in the reference schema; their counts are
assumptions, not fits to either dataset.

  * `write_vcoco_tree(root, train, val, seed)`: annotations/
    {trainval,test}_vcoco.json in the HOIA format (COCO category ids,
    boxes xyxy in pixels, 1-2 person subjects and 1-3 objects an image,
    `hoi_annotation` with V-COCO's 29 actions 0-based), about
    SUBJECT_ONLY of the actions subject-only (`object_id` -1, an action
    drawn from AGENT_ONLY), annotations/corre_vcoco.npy (29 x 80), and
    copies of the images under images/{train2014,val2014};
  * `write_oisgg_tree(root, train, val, seed)`: annotations/
    oi_sgg_{train,test}.json with `rel_annotations` (subjects and objects of
    any class, 1-4 relations between distinct boxes),
    annotations/OI_SGG_trainval_test_categories_dict.json with Open Images
    v6 SGG's counts, 288 object and 30 relation classes, and
    annotations/categories_dict.json, a larger object list (601, Open
    Images' boxable classes) that holds the 288 in another order, so that
    the loader's id remap runs; the box `category_id`s index the larger
    list. The real class names are not in the repository: the names are
    made up from the seed (`tools/vg_tree.py::label_names`). Images are
    copied under images/.

Each returns its label texts, (object names, verb or relation names), from
which `tools/hico_tree.py::write_label_tokenizer` learns the tokenizer
files.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Sequence

import numpy as np

from rlipv2_tpu_torch.data.vocab import HICO_OBJECT_NAMES, VALID_OBJ_IDS, VCOCO_VERB_NAMES
from rlipv2_tpu_torch.tools.vg_tree import label_names

SUBJECT_ONLY = 0.2  # share of V-COCO actions without an object
AGENT_ONLY = tuple(VCOCO_VERB_NAMES.index(v) for v in ("stand", "walk", "run", "smile"))
OI_OBJECTS, OI_RELATIONS, OI_ALL_OBJECTS = 288, 30, 601


def _box(rng: np.random.RandomState, h: int, w: int) -> list:
    x0, y0 = rng.uniform(0, 0.6) * w, rng.uniform(0, 0.6) * h
    bw, bh = rng.uniform(0.15, 0.4) * w, rng.uniform(0.15, 0.4) * h
    return [round(x0, 1), round(y0, 1), round(min(x0 + bw, w - 1), 1), round(min(y0 + bh, h - 1), 1)]


def _copy(src, folder: Path) -> str:
    src = Path(src)
    folder.mkdir(parents=True, exist_ok=True)
    if not (folder / src.name).exists():
        shutil.copyfile(src, folder / src.name)
    return src.name


def _vcoco_annotation(rng, file_name: str, h: int, w: int) -> dict:
    n_sub, n_obj = int(rng.randint(1, 3)), int(rng.randint(1, 4))
    cats = [1] * n_sub + [int(VALID_OBJ_IDS[rng.randint(len(VALID_OBJ_IDS))]) for _ in range(n_obj)]
    hois = []
    for s in range(n_sub):
        for _ in range(int(rng.randint(1, 4))):
            if rng.rand() < SUBJECT_ONLY:
                hois.append({"subject_id": s, "object_id": -1, "category_id": int(rng.choice(AGENT_ONLY))})
            else:
                hois.append({"subject_id": s, "object_id": int(rng.randint(n_sub, n_sub + n_obj)),
                             "category_id": int(rng.randint(len(VCOCO_VERB_NAMES)))})
    return {"file_name": file_name, "annotations": [{"bbox": _box(rng, h, w), "category_id": c} for c in cats],
            "hoi_annotation": hois}


def write_vcoco_tree(root, train: Sequence[tuple], val: Sequence[tuple], seed: int = 0) -> tuple:
    """train, val: (source image path, height, width) per entry; an image
    may repeat. Returns the label texts: (COCO's 80 object names, V-COCO's
    29 action texts)."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    ann_dir = root / "annotations"
    ann_dir.mkdir(parents=True, exist_ok=True)
    for split, folder, entries in (("trainval_vcoco", "train2014", train), ("test_vcoco", "val2014", val)):
        annos = [_vcoco_annotation(rng, _copy(src, root / "images" / folder), int(h), int(w))
                 for src, h, w in entries]
        (ann_dir / f"{split}.json").write_text(json.dumps(annos))
    correct = (rng.rand(len(VCOCO_VERB_NAMES), len(VALID_OBJ_IDS)) < 0.7).astype(np.float64)
    np.save(ann_dir / "corre_vcoco.npy", correct)
    return list(HICO_OBJECT_NAMES), list(VCOCO_VERB_NAMES)


def write_oisgg_tree(root, train: Sequence[tuple], val: Sequence[tuple], seed: int = 0) -> tuple:
    """train, val: (source image path, height, width) per entry. Returns the
    label texts: (the 288 object names, the 30 relation names)."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    names = label_names(OI_ALL_OBJECTS + OI_RELATIONS, rng, words=(1, 2))
    all_objects, relations = names[:OI_ALL_OBJECTS], names[OI_ALL_OBJECTS:]
    objects = [all_objects[i] for i in rng.permutation(OI_ALL_OBJECTS)[:OI_OBJECTS]]
    all_ids = [all_objects.index(o) for o in objects]  # the annotations' category ids
    ann_dir = root / "annotations"
    ann_dir.mkdir(parents=True, exist_ok=True)
    (ann_dir / "OI_SGG_trainval_test_categories_dict.json").write_text(json.dumps({"obj": objects, "rel": relations}))
    (ann_dir / "categories_dict.json").write_text(json.dumps({"obj": all_objects, "rel": relations}))
    for split, entries in (("oi_sgg_train", train), ("oi_sgg_test", val)):
        annos = []
        for src, h, w in entries:
            n_box = int(rng.randint(2, 6))
            boxes = [{"bbox": _box(rng, int(h), int(w)), "category_id": int(all_ids[rng.randint(OI_OBJECTS)])}
                     for _ in range(n_box)]
            rels = []
            for _ in range(int(rng.randint(1, 5))):
                s, o = rng.choice(n_box, 2, replace=False)
                rels.append({"subject_id": int(s), "object_id": int(o), "category_id": int(rng.randint(OI_RELATIONS))})
            annos.append({"file_name": _copy(src, root / "images"), "annotations": boxes, "rel_annotations": rels})
        (ann_dir / f"{split}.json").write_text(json.dumps(annos))
    return objects, relations
