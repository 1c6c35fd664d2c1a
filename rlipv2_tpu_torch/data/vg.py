"""VG-format relational pre-training data on the host (counterpart of
rlipv2_tpu/data/vg.py:1-423; reference datasets/vg.py:37-247 and
datasets/mixed_dataset.py:48-777).

  * `VGRelDataset`: a scene-graph JSON (objects [object_id, x, y, w, h,
    names], relationships [subject_id, object_id, predicate, and for
    pseudo-labelled data confidence and overlap]) of VG, or of COCO, O365
    or HICO images labelled by the R-Tagger; tagger-confidence
    thresholding (`relation_threshold`), pair-overlap filtering, dropping
    of relation-less images, per-source image paths (O365's from the
    folder's image_id_to_filepath.json), per-image label spaces, at most
    `num_queries // 2` relationships an image, one row per (subject,
    object) pair with multi-hot predicates;
  * the label frequency tables (`generate_keep_names_freq`,
    `fuse_keep_names_freq`) that feed 'freq' negative text sampling;
  * `ConcatRelDataset`: datasets end to end with their tables fused;
  * `batch_iterative_indices`: whole batches interleaved between datasets
    per `iterative_paradigm` (reference BatchIterativeDistributedSampler),
    so that one optimizer step accumulates one micro-batch of each.

Images are read by `data/image_io.py` (JPEG through nvJPEG on `device`, so
a JPEG with device "cpu" raises; the format is sniffed, not taken from the
name) and augmented by `data/transforms.py` on uint8 host tensors; items
are (uint8 (h, w, 3) numpy image, target), as `data/hico.py` gives them.

`VGRelTaggerDataset` is the R-Tagger's training data (JAX :275, reference
`VGRelTagger`, datasets/vg.py:250-533): each item's GT pairs, then
negative pairs of the boxes that survive the transforms, drawn without
replacement, with all-zero verb vectors, up to `num_queries // 2` pairs.
Its `random.Random` (`pair_rng`) is seeded from `seed` (the command line
gives --seed; the JAX CLI seeds it with 0) and a checkpoint carries its
state (`TrainState.sampler_rng`); an item read inside
`transforms.item_stream` draws its pairs from that item's stream.
"""

from __future__ import annotations

import json
import math
import random
from collections import OrderedDict
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from rlipv2_tpu_torch.data.image_io import ImageReader
from rlipv2_tpu_torch.data.transforms import HOITransform, item_rng


def unique_names_from_anno(objects_anno, relationships_anno):
    """Per-image label spaces in first-appearance order (reference
    unique_name_dict_from_anno)."""
    obj_unique = OrderedDict()
    for o in objects_anno:
        if o["names"] not in obj_unique:
            obj_unique[o["names"]] = len(obj_unique)
    rel_unique = OrderedDict()
    for r in relationships_anno:
        if r["predicate"] not in rel_unique:
            rel_unique[r["predicate"]] = len(rel_unique)
    return obj_unique, rel_unique


def _tables(obj_freq: OrderedDict, rel_freq: OrderedDict) -> dict:
    return {"object_names": list(obj_freq), "relationship_names": list(rel_freq),
            "object_freq": obj_freq, "relationship_freq": rel_freq}


def generate_keep_names_freq(annotations) -> dict:
    """Label frequency tables of VG-format annotations, names in
    first-appearance order."""
    obj_freq: OrderedDict = OrderedDict()
    rel_freq: OrderedDict = OrderedDict()
    for anno in annotations:
        for o in anno["objects"]:
            obj_freq[o["names"]] = obj_freq.get(o["names"], 0) + 1
        for r in anno["relationships"]:
            rel_freq[r["predicate"]] = rel_freq.get(r["predicate"], 0) + 1
    return _tables(obj_freq, rel_freq)


def fuse_keep_names_freq(tables: Sequence[dict]) -> dict:
    """The tables summed name by name, in first-appearance order."""
    obj_freq: OrderedDict = OrderedDict()
    rel_freq: OrderedDict = OrderedDict()
    for t in tables:
        for k, v in t["object_freq"].items():
            obj_freq[k] = obj_freq.get(k, 0) + v
        for k, v in t["relationship_freq"].items():
            rel_freq[k] = rel_freq.get(k, 0) + v
    return _tables(obj_freq, rel_freq)


def boxes_overlap(b1, b2) -> bool:
    """Whether two xywh boxes overlap (reference check_overlap, for
    pair_overlap)."""
    ax0, ay0, ax1, ay1 = b1[0], b1[1], b1[0] + b1[2], b1[1] + b1[3]
    bx0, by0, bx1, by1 = b2[0], b2[1], b2[0] + b2[2], b2[1] + b2[3]
    return not (ax1 <= bx0 or bx1 <= ax0 or ay1 <= by0 or by1 <= ay0)


class VGRelDataset:
    """A VG-format relational dataset; an annotation's `dataset` field
    ("vg" or absent, "coco2017", "o365", "hico") picks its image folder."""

    def __init__(
        self,
        anno_file,
        folders: dict,  # {'vg': path, 'coco2017': path, 'o365': path, 'hico': path}
        num_queries: int = 200,
        transforms: Optional[HOITransform] = None,
        relation_threshold: float = 0.0,
        pair_overlap: bool = False,
        device="cuda",
    ):
        with open(anno_file) as f:
            self.annotations = json.load(f)
        self.folders = {k: Path(v) for k, v in folders.items() if v is not None}
        self.num_pairs = num_queries // 2
        self.transforms = transforms if transforms is not None else HOITransform(train=True)
        self.reader = ImageReader(device)
        o365 = self.folders.get("o365")
        self.o365_paths = json.loads((o365 / "image_id_to_filepath.json").read_text()) if o365 else None

        # tagger-confidence thresholding (VG relationships carry no
        # confidence and are always kept)
        if relation_threshold > 0.0:
            for anno in self.annotations:
                anno["relationships"] = [r for r in anno["relationships"]
                                         if r.get("confidence", 1.0) >= relation_threshold]
        if pair_overlap:
            for anno in self.annotations:
                objs = {o["object_id"]: o for o in anno["objects"]}
                kept = []
                for r in anno["relationships"]:
                    if "overlap" in r:
                        if r["overlap"] is True:
                            kept.append(r)
                        continue
                    s, o = objs[r["subject_id"]], objs[r["object_id"]]
                    if boxes_overlap((s["x"], s["y"], s["w"], s["h"]), (o["x"], o["y"], o["w"], o["h"])):
                        kept.append(r)
                anno["relationships"] = kept

        self.ids = [i for i, anno in enumerate(self.annotations) if anno["relationships"]]

        tables = generate_keep_names_freq(self.annotations)
        self.object_names = tables["object_names"]
        self.relationship_names = tables["relationship_names"]
        self.object_freq = tables["object_freq"]
        self.relationship_freq = tables["relationship_freq"]

    def __len__(self):
        return len(self.ids)

    def image_path(self, anno) -> Path:
        ds = anno.get("dataset")
        if ds == "coco2017":
            name = str(anno["image_id"]).zfill(12) + ".jpg"
            return self.folders["coco2017"] / anno.get("data_split", "train2017") / name
        if ds == "o365":
            return self.folders["o365"] / self.o365_paths[str(anno["image_id"])]
        if ds == "hico":
            return self.folders["hico"] / anno["image_id"]
        return self.folders["vg"] / (str(anno["image_id"]) + ".jpg")

    def __getitem__(self, idx):
        return self._item(idx)[:2]

    def _item(self, idx):
        """(image, target, (transformed boxes, their labels, the kept
        boxes' indices, the positive pairs)); the last for the tagger's
        negative pairs."""
        anno = self.annotations[self.ids[idx]]
        objects_anno = anno["objects"]
        relationships_anno = anno["relationships"][: self.num_pairs]

        img = self.reader.read(self.image_path(anno))
        h, w = img.shape[:2]
        boxes = np.asarray([[o["x"], o["y"], o["x"] + o["w"], o["y"] + o["h"]] for o in objects_anno],
                           np.float32).reshape(-1, 4)
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)

        obj_unique, rel_unique = unique_names_from_anno(objects_anno, relationships_anno)

        labels = np.asarray([obj_unique[o["names"]] for o in objects_anno], np.int64)
        t = {"boxes": boxes, "labels": labels, "box_indices": np.arange(len(boxes))}
        img, t = self.transforms(img, t)
        kept = list(t["box_indices"])
        oid_to_local = {o["object_id"]: i for i, o in enumerate(objects_anno)}

        sub_labels, obj_labels, verb_labels, sub_boxes, obj_boxes, pairs = [], [], [], [], [], []
        for rel in relationships_anno:
            s_loc, o_loc = oid_to_local[rel["subject_id"]], oid_to_local[rel["object_id"]]
            if s_loc not in kept or o_loc not in kept:
                continue
            pair = (s_loc, o_loc)
            p_idx = rel_unique[rel["predicate"]]
            if pair in pairs:
                verb_labels[pairs.index(pair)][p_idx] = 1.0
                continue
            pairs.append(pair)
            ks, ko = kept.index(s_loc), kept.index(o_loc)
            sub_labels.append(t["labels"][ks])
            obj_labels.append(t["labels"][ko])
            vl = np.zeros(len(rel_unique), np.float32)
            vl[p_idx] = 1.0
            verb_labels.append(vl)
            sub_boxes.append(t["boxes"][ks])
            obj_boxes.append(t["boxes"][ko])

        n = len(pairs)
        target = {
            "orig_size": np.array([h, w], np.int64),
            "image_id": anno["image_id"],
            "obj_classes": list(obj_unique.keys()),
            "verb_classes": list(rel_unique.keys()),
            "obj_labels": np.asarray(obj_labels, np.int64).reshape(n),
            "sub_labels": np.asarray(sub_labels, np.int64).reshape(n),
            "verb_labels": np.stack(verb_labels) if n else np.zeros((0, len(rel_unique)), np.float32),
            "sub_boxes": np.asarray(sub_boxes, np.float32).reshape(n, 4),
            "obj_boxes": np.asarray(obj_boxes, np.float32).reshape(n, 4),
        }
        return img.numpy(), target, (t["boxes"], t["labels"], kept, pairs)

    def label_space_sizes(self) -> list:
        """(object names, predicates) of each item's own label space: the
        texts an item brings to a batch without negative texts."""
        out = []
        for i in self.ids:
            anno = self.annotations[i]
            obj, rel = unique_names_from_anno(anno["objects"], anno["relationships"][: self.num_pairs])
            out.append((len(obj), len(rel)))
        return out

    def close(self) -> None:
        self.reader.close()


class VGRelTaggerDataset(VGRelDataset):
    """Each item fills up to num_queries // 2 pair slots with its GT pairs
    (a sample of them when there are more), then with negative pairs of
    surviving boxes drawn without replacement, each with its boxes' labels
    and boxes and an all-zero verb vector; when fewer ordered pairs exist
    than slots, every one of them."""

    def __init__(self, *args, seed: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.pair_rng = random.Random(seed)

    def __getitem__(self, idx):
        img, target, (boxes, labels, kept, pairs) = self._item(idx)
        num_pairs, n_pos, n_boxes = self.num_pairs, len(pairs), len(kept)
        pos_set = {(kept.index(s), kept.index(o)) for s, o in pairs}
        possible = [(i, j) for i in range(n_boxes) for j in range(n_boxes) if i != j]
        negs = [p for p in possible if p not in pos_set]
        if n_pos >= num_pairs:
            keep_pos = item_rng(self.pair_rng).sample(range(n_pos), num_pairs)
            for k in ("obj_labels", "sub_labels", "verb_labels", "sub_boxes", "obj_boxes"):
                target[k] = target[k][keep_pos]
            negs = []
        elif len(possible) >= num_pairs:  # enough to fill every slot (reference datasets/vg.py:486-490)
            negs = item_rng(self.pair_rng).sample(negs, num_pairs - n_pos)
        if negs:
            V = target["verb_labels"].shape[1]
            extra = {
                "sub_labels": np.asarray([labels[i] for i, _ in negs], np.int64),
                "obj_labels": np.asarray([labels[j] for _, j in negs], np.int64),
                "verb_labels": np.zeros((len(negs), V), np.float32),
                "sub_boxes": np.stack([boxes[i] for i, _ in negs]),
                "obj_boxes": np.stack([boxes[j] for _, j in negs]),
            }
            for k, v in extra.items():
                target[k] = np.concatenate([target[k], v])
        return img, target


class ConcatRelDataset:
    """VG-format datasets end to end, their frequency tables fused
    (reference ConcatDataset, datasets/mixed_dataset.py:223-246)."""

    def __init__(self, datasets: Sequence[VGRelDataset]):
        self.datasets = list(datasets)
        self.cumsizes = np.cumsum([len(d) for d in self.datasets])
        fused = fuse_keep_names_freq([{"object_freq": d.object_freq, "relationship_freq": d.relationship_freq}
                                      for d in self.datasets])
        self.object_names = fused["object_names"]
        self.relationship_names = fused["relationship_names"]
        self.object_freq = fused["object_freq"]
        self.relationship_freq = fused["relationship_freq"]

    def __len__(self):
        return int(self.cumsizes[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self.cumsizes, idx, side="right"))
        prev = 0 if d == 0 else int(self.cumsizes[d - 1])
        return self.datasets[d][idx - prev]

    def close(self) -> None:
        for d in self.datasets:
            d.close()


def batch_iterative_indices(
    dataset_sizes: Sequence[int],
    batch_size: int,
    iterative_paradigm: Sequence[int],
    num_replicas: int = 1,
    rank: int = 0,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
):
    """This rank's whole batches of GLOBAL indices (dataset d's items follow
    those of datasets 0..d-1), one per paradigm entry in turn: [0, 1, 2]
    gives a VG batch, a COCO batch, an O365 batch, then the next VG batch.
    The first dataset is the anchor: its size sets the epoch, and dataset
    d contributes at most anchor size x (its entries in the paradigm)
    items, so its last batches may be short or empty."""
    rng = random.Random(seed + epoch)
    anchor = dataset_sizes[0]
    num_samples = math.ceil(anchor / num_replicas)
    total = num_samples * num_replicas

    def perm(n):
        idx = list(range(n))
        if shuffle:
            rng.shuffle(idx)
        return idx

    indices = perm(anchor)
    pad = total - len(indices)
    if pad:
        indices += (indices * math.ceil(pad / len(indices)))[:pad]

    all_indices = [indices]
    start = anchor
    for d in range(1, len(dataset_sizes)):
        reps = sum(1 for p in iterative_paradigm if p == d)
        all_indices.append([i + start for i in perm(dataset_sizes[d])][: anchor * reps])
        start += dataset_sizes[d]

    out = []
    start_flag = [0] * len(all_indices)
    for _ in range(math.ceil(num_samples / batch_size)):
        take = min(num_replicas * batch_size, len(all_indices[0]) - start_flag[0])
        for d in iterative_paradigm:
            out.append(all_indices[d][start_flag[d] : start_flag[d] + take][rank::num_replicas])
            start_flag[d] += take
    return out
