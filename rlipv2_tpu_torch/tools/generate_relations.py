"""Pseudo-relation generation with a trained R-Tagger (counterpart of
rlipv2_tpu/tools/generate_relations.py; reference
generate_relations_using_verb_tagger.py:554-1100 `verb_tagger_with_text`),
the third step of RLIPv2's scaling pipeline: scripts/tagger_generate_coco.sh.

    python -m rlipv2_tpu_torch.tools.generate_relations \\
        --checkpoint output/tagger_vg/ckpt/checkpoint0019.pth \\
        --coco_img_folder COCO/train2017 \\
        --coco_ann_file COCO/annotations/instances_train2017.json \\
        --rel_candidates vg_rel_texts_for_coco_images.json \\
        --relation_threshold 0.2 --out coco_pseudo_relations.json

Per image, each group of relation candidates (subject/object box pairs of
its GT boxes and candidate relation texts) becomes one row: the pairs as
the tagger's GT queries, the candidates as its verb texts. Rows are scored
`batch_size` at a time by `forward_tagger` (no noise), the last batch
wrap-padded with its first row; every (pair, candidate) whose sigmoid
confidence reaches `relation_threshold` is written as a VG-format
relationship with its `confidence`. The output JSON is what
`--dataset_file pretrain` reads (`data/vg.py::VGRelDataset`, which
thresholds again at load time).

Departures from the JAX module, which has no command line (ROADMAP
queue 3): `generate_pseudo_annotations` reads each image once (the JAX
function reads it twice) and scores rows as they come, holding one batch
of images, not all of them; it writes each object's box in the pixels of
the original image, which is what the VG reader reads back, where the JAX
function writes it in the pixels of the resized image. The checkpoint is
one that `rlipv2-torch --verb_tagger` wrote: its `args` give the model's
preset and flags and the tokenizer's directory, and its weights load
strictly. Rows are scored 8 at a time; the output's entries are
`dataset: "coco2017"`, as the script's COCO images are.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from rlipv2_tpu_torch.data.text import NO_OBJ_TEXT
from rlipv2_tpu_torch.structures import HOITargets


def _build_row(boxes, labels, pairs, rel_texts, object_texts, text_encoder, cfg):
    """One (image, candidate group) row: its padded targets, text features
    and text mask, and what maps its scores back. Returns (targets,
    text_emb, text_valid, n_pairs, rel_texts, sub_idx, obj_idx)."""
    M = cfg.num_queries // 2
    n_obj_slots, n_verb_slots = cfg.max_obj_texts, cfg.max_verb_texts
    pairs = list(pairs)[:M]
    rel_texts = list(rel_texts)[:n_verb_slots]
    sub_idx = [s for s, _ in pairs]
    obj_idx = [o for _, o in pairs]
    n = len(pairs)
    targets = {
        "obj_labels": np.pad(labels[obj_idx], (0, M - n)).astype(np.int64),
        "sub_labels": np.pad(labels[sub_idx], (0, M - n)).astype(np.int64),
        "verb_labels": np.zeros((M, n_verb_slots), np.float32),
        "sub_boxes": np.pad(boxes[sub_idx], ((0, M - n), (0, 0))).astype(np.float32),
        "obj_boxes": np.pad(boxes[obj_idx], ((0, M - n), (0, 0))).astype(np.float32),
        "valid": np.arange(M) < n,
    }
    obj_slots = list(object_texts) + [""] * (n_obj_slots - 1 - len(object_texts)) + [NO_OBJ_TEXT]
    verb_slots = rel_texts + [""] * (n_verb_slots - len(rel_texts))
    feats = text_encoder([t if t else "." for t in obj_slots + verb_slots])
    text_valid = np.zeros(n_obj_slots + n_verb_slots, bool)
    text_valid[: len(object_texts)] = True
    text_valid[n_obj_slots - 1] = True
    text_valid[n_obj_slots : n_obj_slots + len(rel_texts)] = True
    return targets, np.asarray(feats), text_valid, n, rel_texts, sub_idx, obj_idx


def tag_image(tagger_apply: Callable, pixels: np.ndarray, pixel_valid: np.ndarray, boxes: np.ndarray,
              labels: np.ndarray, candidates: Sequence[tuple], object_texts: Sequence[str], text_encoder, cfg,
              relation_threshold: float = 0.2) -> list:
    """One image's candidate groups, one forward of one row each (JAX
    `tag_image`): pixels (H, W, 3) with their validity mask, boxes (n, 4)
    normalized cxcywh, labels (n,) in `object_texts`' space. Returns the
    VG-format relationships with their confidences."""
    out: list = []
    rows = [{"pixels": pixels, "valid": pixel_valid, "boxes": boxes, "labels": labels, "pairs": pairs,
             "rel_texts": rel_texts, "object_texts": object_texts, "out": out}
            for pairs, rel_texts in candidates if pairs and rel_texts]
    tag_rows_batched(tagger_apply, rows, text_encoder, cfg, relation_threshold, batch_size=1)
    return out


def tag_rows_batched(tagger_apply: Callable, rows: Sequence[dict], text_encoder, cfg, relation_threshold: float,
                     batch_size: int = 8) -> None:
    """Score rows (each a dict of pixels, boxes, labels, pairs, rel_texts,
    object_texts and `out`, the list its relationships go to; `valid`, the
    pixels' mask, if not all of them are real) in batches of `batch_size`:
    the images zero-padded to the chunk's largest height and width, a short
    chunk wrap-padded with its first row. Each row is its own batch entry,
    since ALIF fuses the row's texts into its image's encoding.
    `tagger_apply(pixels, valid, text_emb, text_valid, targets)` takes numpy
    arrays and returns the forward's outputs."""
    for start in range(0, len(rows), batch_size):
        chunk = rows[start : start + batch_size]
        B = len(chunk)
        built = [_build_row(r["boxes"], r["labels"], r["pairs"], r["rel_texts"], r["object_texts"], text_encoder,
                            cfg) for r in chunk]
        Hm = max(r["pixels"].shape[0] for r in chunk)
        Wm = max(r["pixels"].shape[1] for r in chunk)
        pixels = np.zeros((batch_size, Hm, Wm, 3), chunk[0]["pixels"].dtype)
        valid = np.zeros((batch_size, Hm, Wm), bool)
        for b, r in enumerate(chunk):
            h, w = r["pixels"].shape[:2]
            pixels[b, :h, :w] = r["pixels"]
            valid[b, :h, :w] = r.get("valid", True)
        pixels[B:], valid[B:] = pixels[0], valid[0]

        def stack(items):
            a = np.stack(items)
            return np.concatenate([a, np.repeat(a[:1], batch_size - B, axis=0)]) if B < batch_size else a

        targets = {k: stack([t[0][k] for t in built]) for k in built[0][0]}
        out = tagger_apply(pixels, valid, stack([t[1] for t in built]), stack([t[2] for t in built]), targets)
        conf_all = torch.sigmoid(out["pred_verb_logits"].float()).cpu().numpy()
        for b, (r, (_, _, _, n, rel_texts, sub_idx, obj_idx)) in enumerate(zip(chunk, built)):
            conf = conf_all[b]
            for p in range(n):
                for ri, rel in enumerate(rel_texts):
                    c = float(conf[p, ri])
                    if c >= relation_threshold:
                        r["out"].append({"subject_id": int(sub_idx[p]), "object_id": int(obj_idx[p]),
                                         "predicate": rel, "confidence": c})


def tagger_apply_fn(model, cfg) -> Callable:
    """`tag_rows_batched`'s `tagger_apply` for the port's model: numpy
    arrays to the model's device, `forward_tagger` without noise."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def apply(pixels, valid, text_emb, text_valid, targets):
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)

        tg = HOITargets(*(dev(targets[k]) for k in ("obj_labels", "sub_labels", "verb_labels", "sub_boxes",
                                                     "obj_boxes", "valid")))
        return model.forward_tagger(dev(pixels), dev(valid), dev(text_emb), dev(text_valid), tg, cfg.max_obj_texts,
                                    box_noise_scale=0.0, label_noise_scale=0.0)

    return apply


def generate_pseudo_annotations(tagger_apply: Callable, dataset, text_encoder, cfg, relation_threshold: float = 0.2,
                                dataset_name: Optional[str] = None, batch_size: int = 8) -> list:
    """The tagger over `dataset` (items (image, target) with normalized
    cxcywh `boxes`, `labels`, `orig_size` and `relation_candidates`) -> a
    VG-format annotation list, one entry per image with its objects (boxes
    in the original image's pixels) and its relationships. Each image is
    read once; rows are scored as soon as a batch of them is ready, in the
    order the JAX function scores its flattened rows."""
    annos, pending = [], []
    for i in range(len(dataset)):
        img, target = dataset[i]
        rels: list = []
        boxes, labels = np.asarray(target["boxes"]), np.asarray(target["labels"])
        obj_texts = target.get("object_texts", dataset.object_names)
        for pairs, rel_texts in target["relation_candidates"]:
            if pairs and rel_texts:
                pending.append({"pixels": img, "boxes": boxes, "labels": labels, "pairs": pairs,
                                "rel_texts": rel_texts, "object_texts": obj_texts, "out": rels})
        h, w = (int(v) for v in target["orig_size"])
        objects = []
        for oid, (b, label) in enumerate(zip(boxes, labels)):
            cx, cy, bw, bh = (float(v) for v in b)
            objects.append({"object_id": oid, "x": (cx - bw / 2) * w, "y": (cy - bh / 2) * h, "w": bw * w,
                            "h": bh * h, "names": dataset.object_names[int(label)]})
        anno = {"image_id": target["image_id"], "objects": objects, "relationships": rels}
        if dataset_name:
            anno["dataset"] = dataset_name
        annos.append(anno)
        if len(pending) >= batch_size:
            full = len(pending) - len(pending) % batch_size
            tag_rows_batched(tagger_apply, pending[:full], text_encoder, cfg, relation_threshold, batch_size)
            pending = pending[full:]
    tag_rows_batched(tagger_apply, pending, text_encoder, cfg, relation_threshold, batch_size)
    return annos


def deduplicate_relationships(annos: list) -> list:
    """Drop duplicate (subject, object, predicate) relationships, keeping
    the highest-confidence copy (reference
    datasets/rlipv2_helper/tagger_helper.py:29-73); every copy whose
    confidence equals the maximum survives, as in the reference. Mutates
    and returns `annos`."""
    for anno in annos:
        rels = anno["relationships"]
        max_conf: dict = {}
        for rel in rels:
            key = (rel["subject_id"], rel["object_id"], rel["predicate"])
            if key not in max_conf or rel["confidence"] > max_conf[key]:
                max_conf[key] = rel["confidence"]
        anno["relationships"] = [rel for rel in rels
                                 if rel["confidence"] == max_conf[(rel["subject_id"], rel["object_id"],
                                                                   rel["predicate"])]]
    return annos


def merge_tagger_segments(json_list, dataset_change_to=None, save_merged_file=None) -> list:
    """Tagger outputs of several segments (e.g. the four O365 shards)
    concatenated entry by entry, the "dataset" field restamped when asked
    (reference datasets/rlipv2_helper/tagger_helper.py:76-110)."""
    annos: list = []
    for jf in json_list:
        annos += json.loads(Path(jf).read_text())
    if dataset_change_to is not None:
        for anno in annos:
            anno["dataset"] = dataset_change_to
    if save_merged_file:
        Path(save_merged_file).write_text(json.dumps(annos))
    return annos


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("rlipv2_tpu_torch.tools.generate_relations", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True, help="a checkpoint of rlipv2-torch --verb_tagger")
    p.add_argument("--coco_img_folder", required=True)
    p.add_argument("--coco_ann_file", required=True, help="COCO-format instances JSON")
    p.add_argument("--rel_candidates", required=True, help="{str(image_id): [[pairs, rel_texts], ...]} JSON")
    p.add_argument("--relation_threshold", type=float, default=0.2)
    p.add_argument("--out", required=True, help="the VG-format output JSON")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def main(argv=None, model_cfg=None, transforms=None) -> list:
    """Parse `argv` and write the pseudo-relations; returns the annotation
    list. `model_cfg` replaces the training run's preset (the tests pass a
    tiny one); `transforms` the evaluation resize."""
    from rlipv2_tpu_torch import cli
    from rlipv2_tpu_torch.data.coco import CocoRelDataset
    from rlipv2_tpu_torch.data.transforms import HOITransform
    from rlipv2_tpu_torch.engine.loops import CachedTextEncoder
    from rlipv2_tpu_torch.models.factory import build_model
    from rlipv2_tpu_torch.utils.tokenizer import RobertaTokenizer

    args = get_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, and torch sees no CUDA device (give --device cpu to run on the CPU)")
    ckpt = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    train_args = argparse.Namespace(**{**vars(cli.get_parser().parse_args([])), **(ckpt.get("args") or {})})
    if not train_args.verb_tagger:
        raise ValueError(f"{args.checkpoint} was not written by a --verb_tagger run")
    dataset = CocoRelDataset(args.coco_img_folder, args.coco_ann_file, args.rel_candidates,
                             transforms=transforms or HOITransform(train=False), device=device)
    try:
        # the training run's slots, with room for every object name and the no-object text
        cfg = cli.text_slots(cli.model_config(train_args, model_cfg), train_args.negative_text_sampling)
        cfg = dataclasses.replace(cfg, max_obj_texts=max(cfg.max_obj_texts, len(dataset.object_names) + 1))
        model = build_model(cfg, tagger=True)
        model.load_state_dict(ckpt["model"], strict=True)
        model.to(device).eval()
        tok_dir = Path(train_args.tokenizer_dir)
        tokenizer = RobertaTokenizer.from_files(tok_dir / "vocab.json", tok_dir / "merges.txt")

        @torch.no_grad()
        def encode_fn(texts):
            ids, mask = tokenizer.batch_encode(texts)
            ids, mask = (torch.from_numpy(a.astype(np.int64)).to(device) for a in (ids, mask))
            return model.encode_text(ids, mask).cpu().numpy()

        annos = generate_pseudo_annotations(tagger_apply_fn(model, cfg), dataset, CachedTextEncoder(encode_fn), cfg,
                                            args.relation_threshold, dataset_name="coco2017")
    finally:
        dataset.close()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(annos))
    n_rel = sum(len(a["relationships"]) for a in annos)
    print(f"{len(annos)} images, {n_rel} relationships at confidence >= {args.relation_threshold}: {args.out}",
          flush=True)
    return annos


if __name__ == "__main__":
    main(sys.argv[1:])
