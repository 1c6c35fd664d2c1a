"""A HICO-DET tree and RoBERTa-format tokenizer files written from a seed, for
runs of the HICO loader and the CLI where the real dataset and the real
RoBERTa vocabulary are not at hand (`chip_smoke.py` phase 8 and the CPU
tests).

  * `write_hico_tree(root, train, val, seed)` writes
    annotations/{trainval_hico,test_hico}.json in the reference schema
    (COCO category ids, boxes xyxy in pixels, one person subject per image
    and 1-4 objects with a verb each), the files of the zero-shot and
    few-shot settings (copies of the train annotations),
    annotations/hoi_list_new.json (the 600 HICO triplets),
    annotations/corre_hico.npy, and copies of the given image files under
    images/{train2015,test2015};
  * `write_label_tokenizer(dir, texts)` writes vocab.json and merges.txt of
    a byte-level BPE learned from the texts (specials <s>, <pad>, </s>,
    <unk> at 0-3, then the bytes the texts use, then the merges), so the
    port's tokenizer encodes every label in a few tokens.
"""

from __future__ import annotations

import json
import shutil
from collections import Counter
from pathlib import Path
from typing import Sequence

import numpy as np

from rlipv2_tpu_torch.data.vocab import VALID_OBJ_IDS, VALID_VERB_IDS
from rlipv2_tpu_torch.utils.tokenizer import bytes_to_unicode

SPECIALS = ("<s>", "<pad>", "</s>", "<unk>")
SETTINGS = ("UC-RF", "UC-NF", "UO", "1percent", "10percent")


def _annotation(rng: np.random.RandomState, file_name: str, h: int, w: int, img_id: int) -> dict:
    n_obj = int(rng.randint(1, 5))
    boxes = []
    for _ in range(n_obj + 1):
        x0, y0 = rng.uniform(0, 0.6) * w, rng.uniform(0, 0.6) * h
        bw, bh = rng.uniform(0.15, 0.4) * w, rng.uniform(0.15, 0.4) * h
        boxes.append([round(x0, 1), round(y0, 1), round(min(x0 + bw, w - 1), 1), round(min(y0 + bh, h - 1), 1)])
    cats = [1] + [int(VALID_OBJ_IDS[rng.randint(len(VALID_OBJ_IDS))]) for _ in range(n_obj)]
    hois = [{"subject_id": 0, "object_id": j, "category_id": int(VALID_VERB_IDS[rng.randint(len(VALID_VERB_IDS))])}
            for j in range(1, n_obj + 1)]
    if rng.rand() < 0.5:  # a second verb on the first pair
        hois.append({"subject_id": 0, "object_id": 1,
                     "category_id": int(VALID_VERB_IDS[rng.randint(len(VALID_VERB_IDS))])})
    return {"file_name": file_name, "img_id": img_id,
            "annotations": [{"bbox": b, "category_id": c} for b, c in zip(boxes, cats)],
            "hoi_annotation": hois}


def write_hico_tree(root, train: Sequence[tuple], val: Sequence[tuple], seed: int = 0) -> Path:
    """train, val: (source image path, height, width) per entry; an image
    may repeat. Each distinct source file is copied once into its split's
    folder under its own name. Returns `root`."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    ann_dir = root / "annotations"
    ann_dir.mkdir(parents=True, exist_ok=True)
    for split, folder, entries in (("trainval_hico", "train2015", train), ("test_hico", "test2015", val)):
        img_dir = root / "images" / folder
        img_dir.mkdir(parents=True, exist_ok=True)
        annos = []
        for i, (src, h, w) in enumerate(entries):
            src = Path(src)
            if not (img_dir / src.name).exists():
                shutil.copyfile(src, img_dir / src.name)
            annos.append(_annotation(rng, src.name, int(h), int(w), i))
        (ann_dir / f"{split}.json").write_text(json.dumps(annos))
    train_text = (ann_dir / "trainval_hico.json").read_text()
    for setting in SETTINGS:
        (ann_dir / f"trainval_hico_{setting}.json").write_text(train_text)
    hoi_list = [{"object_cat": int(VALID_OBJ_IDS[i % len(VALID_OBJ_IDS)]),
                 "verb_id": int(VALID_VERB_IDS[(7 * i) % len(VALID_VERB_IDS)])} for i in range(600)]
    (ann_dir / "hoi_list_new.json").write_text(json.dumps(hoi_list))
    correct = (rng.rand(len(VALID_VERB_IDS), len(VALID_OBJ_IDS)) < 0.7).astype(np.float64)
    np.save(ann_dir / "corre_hico.npy", correct)
    return root


def _words(texts: Sequence[str]) -> Counter:
    """Byte-level words as the tokenizer forms them: the first word of a
    text bare, later ones with the leading-space byte."""
    be = bytes_to_unicode()
    counts: Counter = Counter()
    for t in texts:
        for i, w in enumerate(t.strip().split()):
            counts[tuple(be[b] for b in ((" " + w) if i else w).encode("utf-8"))] += 1
    return counts


def write_label_tokenizer(directory, texts: Sequence[str], n_merges: int = 400) -> Path:
    """Learn up to `n_merges` BPE merges over the texts' words (the most
    frequent pair first, ties by first appearance) and write vocab.json and
    merges.txt to `directory`. Returns `directory`."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    words = _words(texts)
    symbols = list(dict.fromkeys(s for w in words for s in w))
    merges: list[tuple[str, str]] = []
    segs = {w: list(w) for w in words}
    for _ in range(n_merges):
        pairs: Counter = Counter()
        for w, n in words.items():
            s = segs[w]
            for a, b in zip(s, s[1:]):
                pairs[(a, b)] += n
        if not pairs:
            break
        best = max(pairs, key=lambda p: pairs[p])
        merges.append(best)
        for w in words:
            s, out, i = segs[w], [], 0
            while i < len(s):
                if i + 1 < len(s) and (s[i], s[i + 1]) == best:
                    out.append(s[i] + s[i + 1])
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            segs[w] = out
    tokens = list(dict.fromkeys([*SPECIALS, *symbols, *("".join(m) for m in merges)]))
    (directory / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(tokens)}))
    (directory / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return directory
