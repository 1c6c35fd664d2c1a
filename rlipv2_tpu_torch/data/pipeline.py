"""Batch building: dataset samples -> static train batch + text slots
(counterpart of rlipv2_tpu/data/pipeline.py; reference engine.py:93-98 and
merge_batch_data). Per batch it unions the label texts, samples negatives
(the object texts get 2/3 of the budget, engine.py:733-744), packs the
texts into static slots and pads the targets; a no-object label (V-COCO's
subject-only actions) takes the no-object slot, the last object slot. The
slot texts are encoded into pooled features by the engine, cached per
unique text.

A rank of a data-parallel run builds its slice of a global batch:
`batch_texts` gives every image's label texts in the global batch's order
and where the slice starts, so the merged texts, the negatives (drawn
from the same rng on every rank) and the slots are the global batch's,
and the slice's labels map into them as in the one-process build.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np

from rlipv2_tpu_torch.data.collate import make_hoi_batch
from rlipv2_tpu_torch.data.text import (
    NO_OBJ_LABEL,
    merge_batch_texts,
    pack_text_slots,
    sample_negative_texts,
)


def build_train_batch(
    samples: Sequence[tuple],  # [(img, target)] from a dataset
    max_obj_texts: int,
    max_verb_texts: int,
    max_triplets: int,
    negative_text_sampling: int = 0,
    obj_vocab: Optional[Sequence[str]] = None,
    obj_freqs=None,
    verb_vocab: Optional[Sequence[str]] = None,
    verb_freqs=None,
    sampling_strategy: str = "freq",
    rng: Optional[random.Random] = None,
    bucket=None,
    batch_texts: Optional[tuple] = None,
):
    """`batch_texts` = (object texts, verb texts, start): each image's
    label texts for every image of the global batch, and the index of
    samples[0] in it."""
    rng = rng or random.Random()
    images = [s[0] for s in samples]
    targets = [s[1] for s in samples]

    obj_labels = [t["obj_labels"] for t in targets]
    sub_labels = [t["sub_labels"] for t in targets]
    verb_labels = [t["verb_labels"] for t in targets]
    if batch_texts is None:
        obj_texts, verb_texts, start = [t["obj_classes"] for t in targets], [t["verb_classes"] for t in targets], 0
    else:  # the global batch's other images take part with their texts and no labels
        obj_texts, verb_texts, start = batch_texts
        end, none = start + len(targets), np.zeros(0, np.int64)
        obj_labels = [none] * start + obj_labels + [none] * (len(obj_texts) - end)
        sub_labels = [none] * start + sub_labels + [none] * (len(obj_texts) - end)
        verb_labels = ([np.zeros((0, len(v)), np.float32) for v in verb_texts[:start]] + verb_labels
                       + [np.zeros((0, len(v)), np.float32) for v in verb_texts[end:]])
    merged_obj, merged_verb, new_obj, new_sub, new_verb = merge_batch_texts(
        obj_texts, verb_texts, obj_labels, sub_labels, verb_labels)
    own = slice(start, start + len(targets))
    new_obj, new_sub, new_verb = new_obj[own], new_sub[own], new_verb[own]

    if negative_text_sampling > 0:
        n_obj_budget = int(negative_text_sampling * 2 / 3.0)
        n_verb_budget = negative_text_sampling - n_obj_budget
        if obj_vocab is not None:
            merged_obj = sample_negative_texts(
                merged_obj, n_obj_budget, obj_vocab, obj_freqs,
                sampling_strategy, rng,
            )
        if verb_vocab is not None:
            merged_verb = sample_negative_texts(
                merged_verb, n_verb_budget, verb_vocab, verb_freqs,
                sampling_strategy, rng,
            )

    obj_slots, verb_slots, obj_valid, verb_valid = pack_text_slots(
        merged_obj, merged_verb, max_obj_texts, max_verb_texts
    )

    # pad the per-image verb multi-hots to the static verb-slot width
    padded_targets = []
    for t, ol, sl, vl in zip(targets, new_obj, new_sub, new_verb):
        vfull = np.zeros((len(vl), max_verb_texts), np.float32)
        if len(vl):
            vfull[:, : vl.shape[1]] = vl
        padded_targets.append(
            {
                "obj_labels": np.where(ol == NO_OBJ_LABEL, max_obj_texts - 1, ol),
                "sub_labels": sl,
                "verb_labels": vfull,
                "sub_boxes": t["sub_boxes"],
                "obj_boxes": t["obj_boxes"],
            }
        )

    arrays = make_hoi_batch(
        images, padded_targets, max_triplets, max_verb_texts, bucket=bucket
    )
    B = len(samples)
    arrays["obj_text_valid"] = np.tile(obj_valid, (B, 1))
    arrays["verb_text_valid"] = np.tile(verb_valid, (B, 1))
    return arrays, obj_slots, verb_slots
