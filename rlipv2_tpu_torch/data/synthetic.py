"""A seeded, in-memory HICO-like dataset and a hash tokenizer.

They stand in for the HICO-DET images and the RoBERTa BPE files, which the
repository does not hold, so the evaluation and training paths can run end
to end from a seed. `SyntheticHICODataset` has the interface of a HICO
split: `object_text`, `verb_text`, `rare_triplets`, `non_rare_triplets`,
`correct_mat`, and items `(uint8 image (h, w, 3), target)`.

  * image_set="val": the target `evaluate_hoi` reads, in original pixels
    (`orig_size`, `filename`, `boxes` xyxy, `labels`, `hois` as
    [subject box, object box, verb]);
  * image_set="train": the JAX HICO train target that `build_train_batch`
    reads (rlipv2_tpu/data/hico.py:128-178): one row per (subject, object)
    pair with `obj_labels`, `sub_labels` (0, the person class), multi-hot
    `verb_labels` over `verb_classes`, XYXY pixel `sub_boxes`/`obj_boxes`,
    and the texts `obj_classes`/`verb_classes`. No augmentation is applied.

Annotations are drawn at construction; each image is drawn on access from
its own seed, so the dataset holds no pixels.
"""

from __future__ import annotations

import zlib
from collections import Counter
from typing import Sequence

import numpy as np

from rlipv2_tpu_torch.data.vocab import HICO_OBJECT_NAMES, HICO_VERB_NAMES


def hash_tokenize(texts: Sequence[str], vocab_size: int, maxlen: int = 8):
    """Deterministic stand-in for the RoBERTa tokenizer: <s> (0), one id per
    word from a CRC32 of the word, </s> (2), padded with <pad> (1).
    Returns (ids, mask) int64 arrays of shape (len(texts), maxlen)."""
    ids = np.ones((len(texts), maxlen), np.int64)
    mask = np.zeros((len(texts), maxlen), np.int64)
    for i, t in enumerate(texts):
        words = [3 + zlib.crc32(f"0:{w}".encode()) % (vocab_size - 3) for w in t.split()]
        toks = ([0] + words[: maxlen - 2] + [2])[:maxlen]
        ids[i, : len(toks)] = toks
        mask[i, : len(toks)] = 1
    return ids, mask


class SyntheticHICODataset:
    def __init__(
        self,
        n_images: int,
        min_size=(600, 800),
        max_size=(832, 1344),
        n_obj_classes: int = 80,
        n_verb_classes: int = 117,
        seed: int = 0,
        image_set: str = "val",
    ):
        if image_set not in ("val", "train"):
            raise ValueError(f"image_set is 'val' or 'train', got {image_set!r}")
        rng = np.random.RandomState(seed)
        self.seed = seed
        self.image_set = image_set
        self.object_text = list(HICO_OBJECT_NAMES[:n_obj_classes])
        self.verb_text = list(HICO_VERB_NAMES[:n_verb_classes])
        self.correct_mat = None
        self.annotations = []
        counts: Counter = Counter()
        for i in range(n_images):
            h = int(rng.randint(min_size[0], max_size[0] + 1))
            w = int(rng.randint(min_size[1], max_size[1] + 1))
            n_boxes = int(rng.randint(2, 6))
            xy0 = rng.rand(n_boxes, 2) * 0.6 * [w, h]
            wh = (0.1 + rng.rand(n_boxes, 2) * 0.3) * [w, h]
            boxes = np.concatenate([xy0, np.minimum(xy0 + wh, [w - 1, h - 1])], 1).astype(np.float32)
            labels = np.concatenate([[0], rng.randint(0, n_obj_classes, n_boxes - 1)]).astype(np.int64)
            hois = np.asarray(
                [(0, j, int(rng.randint(n_verb_classes))) for j in range(1, n_boxes)], np.int64
            ).reshape(-1, 3)
            counts.update((int(labels[s]), int(labels[o]), int(v)) for s, o, v in hois)
            self.annotations.append(
                {"size": (h, w), "boxes": boxes, "labels": labels, "hois": hois}
            )
        self.rare_triplets = [t for t, c in counts.items() if c < 2]
        self.non_rare_triplets = [t for t, c in counts.items() if c >= 2]

    def __len__(self) -> int:
        return len(self.annotations)

    def __getitem__(self, idx: int):
        a = self.annotations[idx]
        h, w = a["size"]
        img = np.random.RandomState([self.seed, idx]).randint(0, 256, (h, w, 3), dtype=np.uint8)
        if self.image_set == "train":
            return img, self._train_target(a)
        target = {
            "orig_size": np.array([h, w], np.int64),
            "filename": f"synthetic_{idx:06d}.jpg",
            "boxes": a["boxes"],
            "labels": a["labels"],
            "hois": a["hois"],
            "id": idx,
        }
        return img, target

    def _train_target(self, a: dict) -> dict:
        """One row per (subject, object) pair, its verbs multi-hot."""
        pairs: list = []
        verbs: list = []
        for s, o, v in a["hois"]:
            if (s, o) not in pairs:
                pairs.append((s, o))
                verbs.append(np.zeros(len(self.verb_text), np.float32))
            verbs[pairs.index((s, o))][v] = 1.0
        n = len(pairs)
        return {
            "orig_size": np.array(a["size"], np.int64),
            "obj_labels": np.asarray([a["labels"][o] for _, o in pairs], np.int64).reshape(n),
            "sub_labels": np.zeros(n, np.int64),
            "verb_labels": np.stack(verbs) if n else np.zeros((0, len(self.verb_text)), np.float32),
            "sub_boxes": np.asarray([a["boxes"][s] for s, _ in pairs], np.float32).reshape(n, 4),
            "obj_boxes": np.asarray([a["boxes"][o] for _, o in pairs], np.float32).reshape(n, 4),
            "obj_classes": self.object_text,
            "verb_classes": self.verb_text,
        }
