"""VG-format pre-training trees written from a seed, for runs of the VG
loader and the pre-training command line where Visual Genome and the
pseudo-labelled COCO and Objects365 files are not at hand (`chip_smoke.py`
phase 9 and the CPU tests).

`write_vg_tree(root, images, ...)` writes three annotation files in the
reference's VG format (objects [object_id, x, y, w, h, names],
relationships [subject_id, object_id, predicate]):
  * vg.json, `dataset: "vg"`, images vg/{image_id}.jpg;
  * coco.json, pseudo-labelled COCO, `dataset: "coco2017"`, images
    coco2017/train2017/{image_id:012}.jpg, each relationship with the
    tagger's `confidence` in [0, 1] and, on about half of them, the
    pair's precomputed `overlap` (the rest are computed from the boxes);
  * o365.json, pseudo-labelled Objects365, `dataset: "o365"`, images
    under o365/ at the paths o365/image_id_to_filepath.json gives;
and copies of the given image files under those names (the reader sniffs
the format, so PNG bytes may stand under a .jpg name).

The counts are drawn around Visual Genome's published per-image means,
35 objects and 21 relationships (Krishna et al., "Visual Genome", IJCV
2017, abstract). The spread of those draws, the share of relationships
between overlapping boxes (`OVERLAPPING`), the one dense image a file
(`DENSE_IMAGE`: more than the 100 pairs and 64 triplets a batch holds, so
that both truncations run) and the Zipf exponents of the names are
assumptions, not fits to VG:
triplet counts, matching times and filter shares measured on such a tree
are those of this synthetic distribution. Names are drawn from
`n_object_names` object names and `n_predicates` predicates, every name
used at least once in each file that has room for it.

`write_label_tokenizer` (tools/hico_tree.py) learns the tokenizer files
from `tree["texts"]`.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Sequence

import numpy as np

from rlipv2_tpu_torch.data.vg import boxes_overlap

# Visual Genome's mean objects and relationships an image (Krishna et al.
# 2017); the counts are negative-binomial around them, shapes assumed
MEAN_OBJECTS, MEAN_RELATIONSHIPS = 35, 21
OBJECTS_SHAPE, RELATIONSHIPS_SHAPE = 8, 2
# (objects, relationships) of each file's first image
DENSE_IMAGE = (40, 120)
# assumed Zipf exponents, steeper for predicates than for object names
OBJECT_ZIPF, PREDICATE_ZIPF = 1.0, 1.3
OVERLAPPING = 0.85  # share of relationships drawn between overlapping boxes
_SYLLABLES = ("ka", "lo", "mi", "ran", "tes", "vo", "pu", "shi", "gar", "den", "ber", "lin", "mo", "tor",
              "fa", "ne", "ri", "sul", "cha", "pel", "dro", "wi", "zan", "quo", "bel", "ost", "um", "rek")


def label_names(n: int, rng: np.random.RandomState, words: tuple = (1, 2)) -> list:
    """n distinct made-up labels of `words` (least, most) words of 2-3
    syllables."""
    names: dict = {}
    while len(names) < n:
        k = rng.randint(words[0], words[1] + 1)
        name = " ".join("".join(rng.choice(_SYLLABLES, rng.randint(2, 4))) for _ in range(k))
        names.setdefault(name, None)
    return list(names)


def zipf_probs(n: int, s: float) -> np.ndarray:
    p = np.arange(1, n + 1, dtype=np.float64) ** -s
    return p / p.sum()


def _count(rng, mean: int, shape: int, least: int) -> int:
    """At least `least`, negative-binomial with the given mean."""
    return least + int(rng.negative_binomial(shape, shape / (shape + mean - least)))


def _scene(rng, image_id, h, w, obj_names, obj_p, predicates, pred_p, pseudo, dense):
    n_obj, n_rel = DENSE_IMAGE if dense else (_count(rng, MEAN_OBJECTS, OBJECTS_SHAPE, 2),
                                             _count(rng, MEAN_RELATIONSHIPS, RELATIONSHIPS_SHAPE, 1))
    objects = []
    for k in range(n_obj):
        bw, bh = rng.uniform(0.1, 0.5) * w, rng.uniform(0.1, 0.5) * h
        objects.append({"object_id": int(image_id) * 100 + k, "x": round(rng.uniform(0, w - bw), 1),
                        "y": round(rng.uniform(0, h - bh), 1), "w": round(bw, 1), "h": round(bh, 1),
                        "names": obj_names[rng.choice(len(obj_names), p=obj_p)]})
    xywh = [(o["x"], o["y"], o["w"], o["h"]) for o in objects]
    pairs = [(i, j) for i in range(n_obj) for j in range(n_obj) if i != j]
    close = [(i, j) for i, j in pairs if boxes_overlap(xywh[i], xywh[j])] or pairs
    relationships = []
    for _ in range(n_rel):
        pool = close if rng.rand() < OVERLAPPING else pairs
        i, j = pool[rng.randint(len(pool))]
        r = {"subject_id": objects[i]["object_id"], "object_id": objects[j]["object_id"],
             "predicate": predicates[rng.choice(len(predicates), p=pred_p)]}
        if pseudo:
            r["confidence"] = round(float(rng.uniform() ** 0.5), 4)
            if rng.rand() < 0.5:
                r["overlap"] = boxes_overlap(xywh[i], xywh[j])
        relationships.append(r)
    return {"image_id": image_id, "objects": objects, "relationships": relationships}


def _cover(rng, items: list, key: str, names: list) -> None:
    """Rename items so that every name is used at least once, taking only
    items whose name is used more than once."""
    counts: dict = {}
    for it in items:
        counts[it[key]] = counts.get(it[key], 0) + 1
    for name in names:
        if name in counts:
            continue
        spare = [it for it in items if counts[it[key]] > 1]
        if not spare:
            return
        it = spare[rng.randint(len(spare))]
        counts[it[key]] -= 1
        it[key] = name
        counts[name] = 1


def write_vg_tree(root, images: Sequence[tuple], n_images: Sequence[int] = (200, 200, 100),
                  n_object_names: int = 1200, n_predicates: int = 320, seed: int = 0) -> dict:
    """images: (source image path, height, width) per entry, used in turn.
    n_images: images in the VG, COCO and O365 files. Returns the paths
    {"vg_anno", "coco_anno", "o365_anno", "vg_folder", "coco2017_folder",
    "o365_folder"} and "texts", every label text of the three files."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    obj_names = label_names(n_object_names, rng)
    predicates = label_names(n_predicates, rng, words=(1, 3))
    obj_p, pred_p = zipf_probs(n_object_names, OBJECT_ZIPF), zipf_probs(n_predicates, PREDICATE_ZIPF)
    out = {"vg_folder": root / "vg", "coco2017_folder": root / "coco2017", "o365_folder": root / "o365"}
    o365_paths = {}
    for source, first_id, n in (("vg", 1, n_images[0]), ("coco2017", 100_000, n_images[1]),
                                ("o365", 200_000, n_images[2])):
        annos = []
        for k in range(n):
            src, h, w = images[k % len(images)]
            image_id = first_id + k
            anno = _scene(rng, image_id, int(h), int(w), obj_names, obj_p, predicates, pred_p,
                          pseudo=source != "vg", dense=k == 0)
            anno["dataset"] = source
            if source == "vg":
                dst = out["vg_folder"] / f"{image_id}.jpg"
            elif source == "coco2017":
                dst = out["coco2017_folder"] / "train2017" / f"{image_id:012d}.jpg"
            else:
                rel = f"images/v1/patch{k % 3}/objects365_v1_{image_id:08d}.jpg"
                o365_paths[str(image_id)] = rel
                dst = out["o365_folder"] / rel
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(src, dst)
            annos.append(anno)
        _cover(rng, [o for a in annos for o in a["objects"]], "names", obj_names)
        _cover(rng, [r for a in annos for r in a["relationships"]], "predicate", predicates)
        name = {"vg": "vg", "coco2017": "coco", "o365": "o365"}[source]
        out[f"{name}_anno"] = root / f"{name}.json"
        out[f"{name}_anno"].write_text(json.dumps(annos))
    out["o365_folder"].mkdir(parents=True, exist_ok=True)
    (out["o365_folder"] / "image_id_to_filepath.json").write_text(json.dumps(o365_paths))
    out["texts"] = obj_names + predicates
    return out
