"""Label-text merging, negative sampling and static slot packing
(counterpart of rlipv2_tpu/data/text.py; reference engine.py:700-937):
  * merge_batch_texts: union the per-image object/verb label texts across
    the batch and remap per-image labels into the merged space; an object
    label one past an image's texts (V-COCO's no-object class of a
    subject-only action) becomes NO_OBJ_LABEL, which `data/pipeline.py`
    puts on the no-object slot;
  * sample_negative_texts: grow the merged texts to a fixed count, or to
    the whole vocabulary, with 'random' or 'freq' sampling ('hard_mining'
    is not ported yet);
  * pack_text_slots: object slots [reals, pads..., no-object] with the
    no-object text pinned to the LAST slot, verb slots [reals, pads...].
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np

NO_OBJ_TEXT = "no objects"
# the merged label of the no-object class: the no-object text has no place
# in the merged texts, its slot is the last one
NO_OBJ_LABEL = -1


def merge_batch_texts(obj_texts, verb_texts, obj_labels, sub_labels, verb_labels):
    """Union texts across batch; remap labels.

    obj_texts/verb_texts: list (per image) of list[str]
    obj_labels/sub_labels: list of (n_i,) int arrays indexing obj_texts[i]
    verb_labels: list of (n_i, len(verb_texts[i])) multi-hot arrays
    Returns merged_obj, merged_verb, new_obj/new_sub (lists of int arrays),
    new_verb (list of (n_i, len(merged_verb)) multi-hot). An object label
    equal to len(obj_texts[i]) is the no-object class and maps to
    NO_OBJ_LABEL; the JAX function raises IndexError on it (ROADMAP queue
    3)."""
    merged_obj: list[str] = []
    for texts in obj_texts:
        for t in texts:
            if t not in merged_obj:
                merged_obj.append(t)
    merged_verb: list[str] = []
    for texts in verb_texts:
        for t in texts:
            if t not in merged_verb:
                merged_verb.append(t)

    def merged_label(texts, label):
        return NO_OBJ_LABEL if int(label) == len(texts) else merged_obj.index(texts[int(label)])

    new_obj, new_sub, new_verb = [], [], []
    for texts, ol, sl, vl in zip(obj_texts, obj_labels, sub_labels, verb_labels):
        new_obj.append(np.array([merged_label(texts, l) for l in ol], np.int64))
        new_sub.append(
            np.array([merged_obj.index(texts[int(l)]) for l in sl], np.int64)
        )
    for texts, vl in zip(verb_texts, verb_labels):
        n = len(vl)
        out = np.zeros((n, len(merged_verb)), np.float32)
        for i in range(n):
            for j in np.nonzero(vl[i])[0]:
                out[i, merged_verb.index(texts[int(j)])] = 1.0
        new_verb.append(out)
    return merged_obj, merged_verb, new_obj, new_sub, new_verb


def sample_negative_texts(
    merged: list,
    target_count: int,
    full_texts: Sequence[str],
    freqs: Optional[Sequence[float]] = None,
    strategy: str = "freq",
    rng: Optional[random.Random] = None,
):
    """Grow `merged` with sampled negatives until target_count (reference
    sample_text semantics: skip duplicates, 'freq' samples by dataset label
    frequency), or until every text of `full_texts` is in it.

    The draws are the JAX function's while texts remain. Where the budget
    exceeds the vocabulary the JAX function draws on (up to 100 draws a
    slot) and then pads with made-up "<pad text i>" labels, which overflow
    the static slots: HICO's 80 objects under `--negative_text_sampling
    500` (333 object texts) raise in `pack_text_slots` (ROADMAP queue 3).
    Here the list stops at the vocabulary, and the unused slots stay
    padding."""
    rng = rng or random.Random()
    merged = list(merged)
    if len(merged) >= target_count:
        return merged  # the reference keeps every positive
    remaining = set(full_texts) - set(merged)
    if strategy == "freq" and freqs is not None:
        cum = np.cumsum(np.asarray(freqs, np.float64))
        cum = cum / cum[-1]
    guard = 0
    while len(merged) < target_count and remaining and guard < 100 * target_count:
        guard += 1
        if strategy == "freq" and freqs is not None:
            t = full_texts[int(np.searchsorted(cum, rng.random()))]
        else:
            t = rng.choice(list(full_texts))
        if t in remaining:
            merged.append(t)
            remaining.discard(t)
    return merged


def pack_text_slots(
    merged_obj: list,
    merged_verb: list,
    max_obj: int,
    max_verb: int,
    add_no_obj: bool = True,
):
    """-> (obj_slot_texts, verb_slot_texts, obj_valid (max_obj,), verb_valid)
    with no-object pinned at slot max_obj-1. Raises if texts overflow the
    static budget (callers choose max_* >= negative_sampling target + 1)."""
    n_obj = len(merged_obj)
    n_verb = len(merged_verb)
    budget_obj = max_obj - 1 if add_no_obj else max_obj
    if n_obj > budget_obj or n_verb > max_verb:
        raise ValueError(
            f"text slots overflow: obj {n_obj}/{budget_obj}, verb {n_verb}/{max_verb}"
        )
    obj_slots = list(merged_obj) + [""] * (budget_obj - n_obj)
    obj_valid = np.zeros(max_obj, bool)
    obj_valid[:n_obj] = True
    if add_no_obj:
        obj_slots.append(NO_OBJ_TEXT)
        obj_valid[-1] = True
    verb_slots = list(merged_verb) + [""] * (max_verb - n_verb)
    verb_valid = np.zeros(max_verb, bool)
    verb_valid[:n_verb] = True
    return obj_slots, verb_slots, obj_valid, verb_valid
