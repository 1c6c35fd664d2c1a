"""Host-side train and HICO evaluation loops (counterpart of
rlipv2_tpu/engine/loops.py:40, :77, :237, :340).

`train_one_epoch` builds each batch on host threads (text merge, negative
sampling, slot packing, padding to a bucket; `data/pipeline.py`), takes
the slot texts' features from a `CachedTextEncoder`, moves the batch to the
model's device and runs the train step; the step's metrics are read one
step late, so the host never waits for a step that is still running.

`evaluate_hoi` encodes the label vocabulary once through a
`CachedTextEncoder`, pads each batch of images into one fixed bucket with a
pixel-validity mask, runs `apply_fn(model, pixels, valid, text_emb,
text_valid, n_obj)` on the model's device, post-processes there, and feeds
host-side per-image results to the shared HICO evaluator. Batches are
packed on host threads while the device runs the previous one.
"""

from __future__ import annotations

import math
import random
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from rlipv2_tpu_torch.config import ModelConfig
from rlipv2_tpu_torch.data.loader import batch_rng, prefetch_map
from rlipv2_tpu_torch.data.pipeline import build_train_batch
from rlipv2_tpu_torch.engine.train import TrainBatch, check_trainable
from rlipv2_tpu_torch.eval.hico_eval import HICOEvaluator
from rlipv2_tpu_torch.eval.postprocess import postprocess_hoi, to_image_results
from rlipv2_tpu_torch.structures import HOITargets
from rlipv2_tpu_torch.utils.logging import MetricLogger

SUBJECT_CATEGORY_ID = 0  # HICO's "person"


class CachedTextEncoder:
    """Memoizes pooled text features per unique label text."""

    def __init__(self, encode_fn: Callable[[Sequence[str]], np.ndarray]):
        self.encode_fn = encode_fn
        self.cache: dict[str, np.ndarray] = {}

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        missing = [t for t in texts if t not in self.cache]
        if missing:
            feats = np.asarray(self.encode_fn(missing))
            for t, f in zip(missing, feats):
                self.cache[t] = f
        return np.stack([self.cache[t] for t in texts])


def train_one_epoch(
    step_fn,
    model: torch.nn.Module,
    dataset,
    indices: Sequence[int],
    batch_size: int,
    cfg: ModelConfig,
    text_encoder: CachedTextEncoder,
    epoch: int = 0,
    negative_text_sampling: int = 0,
    obj_vocab=None,
    verb_vocab=None,
    obj_freqs=None,
    verb_freqs=None,
    sampling_strategy: str = "freq",
    print_freq: int = 50,
    logger: Optional[MetricLogger] = None,
    rng: Optional[random.Random] = None,
    max_steps: Optional[int] = None,
    max_triplets: Optional[int] = None,
    batch_lists: Optional[Sequence[Sequence[int]]] = None,
    num_workers: int = 0,
    accumulation_steps: int = 1,
    tokenize_fn=None,
):
    """One epoch of `step_fn(TrainBatch) -> metrics` (engine/train.py) over
    `dataset`, with the JAX loop's signature and defaults; `model` takes
    the place of the JAX train state: the step updates it in place, and it
    is returned as given, beside {metric: global average}.

    indices + batch_size give a plain epoch; batch_lists gives pre-built
    whole batches. num_workers > 0 builds batches in a threaded prefetch
    window, each from its own deterministic rng stream. A non-finite loss
    raises FloatingPointError (the reference aborts training), one step
    after the step that made it. `text_encoder` should already hold every
    slot text: encoding on a worker thread would run the model beside the
    train step. tokenize_fn (in-graph text-encoder training) and
    accumulation_steps > 1 are not ported yet. A config with an int8
    inference option raises ValueError (`engine/train.py::check_trainable`)."""
    check_trainable(cfg)
    if tokenize_fn is not None:
        raise NotImplementedError(
            "in-graph text-encoder training (tokenize_fn) is not ported yet (ROADMAP queue 1 item 15)"
        )
    if accumulation_steps != 1:
        raise NotImplementedError("gradient accumulation is not ported yet (ROADMAP queue 1 item 15)")
    device = next(model.parameters()).device
    rng = rng or random.Random(epoch)
    if max_triplets is None:
        # the matcher needs M <= n_pairs (= num_queries // 2)
        max_triplets = min(64, cfg.num_queries // 2)
    logger = logger or MetricLogger()
    n_batches = len(batch_lists) if batch_lists is not None else len(indices) // batch_size
    if max_steps is not None:
        n_batches = min(n_batches, max_steps)

    def batches():
        for i in range(n_batches):
            if batch_lists is not None:
                yield list(batch_lists[i])
            else:
                yield indices[i * batch_size : (i + 1) * batch_size]

    def make_batch(job):
        bidx, batch_ids = job
        samples = [dataset[i] for i in batch_ids]
        arrays, obj_slots, verb_slots = build_train_batch(
            samples,
            max_obj_texts=cfg.max_obj_texts,
            max_verb_texts=cfg.max_verb_texts,
            max_triplets=max_triplets,
            negative_text_sampling=negative_text_sampling,
            obj_vocab=obj_vocab,
            verb_vocab=verb_vocab,
            obj_freqs=obj_freqs,
            verb_freqs=verb_freqs,
            sampling_strategy=sampling_strategy,
            rng=rng if num_workers <= 0 else batch_rng(0, epoch, bidx),
        )
        slot_texts = [t if t else "." for t in list(obj_slots) + list(verb_slots)]  # pad slots encode '.'
        feats = text_encoder(slot_texts)
        B = arrays["pixels"].shape[0]
        arrays["text_emb"] = np.ascontiguousarray(np.broadcast_to(feats[None], (B, *feats.shape)))
        arrays["text_valid"] = np.concatenate([arrays["obj_text_valid"], arrays["verb_text_valid"]], axis=1)
        # pinned on the worker thread, so the copy to the card is asynchronous
        return {k: _host_tensor(v, device) for k, v in arrays.items()}

    def flush(metrics):
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss} at epoch {epoch}")
        logger.update(
            loss=loss,
            grad_norm=float(metrics["grad_norm"]),
            obj_ce=float(metrics["loss_obj_ce"]),
            verb_ce=float(metrics["loss_verb_ce"]),
        )

    pending = None
    batch_iter = prefetch_map(make_batch, enumerate(batches()), num_workers)
    for host in logger.log_every(_SizedIter(batch_iter, n_batches), print_freq, f"Epoch [{epoch}]"):
        metrics = step_fn(_train_batch(host, device))
        if pending is not None:
            flush(pending)  # one step late: the host does not wait for this step
        pending = metrics
    if pending is not None:
        flush(pending)
    return model, {k: m.global_avg for k, m in logger.meters.items()}


def _host_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if device.type == "cuda" else t


def _train_batch(host: dict, device: torch.device) -> TrainBatch:
    def dev(k):
        return host[k].to(device, non_blocking=True)

    return TrainBatch(
        pixels=dev("pixels"),
        pixel_valid=dev("pixel_valid"),
        text_emb=dev("text_emb"),
        text_valid=dev("text_valid"),
        targets=HOITargets(
            obj_labels=dev("obj_labels"),
            sub_labels=dev("sub_labels"),
            verb_labels=dev("verb_labels"),
            sub_boxes=dev("sub_boxes"),
            obj_boxes=dev("obj_boxes"),
            valid=dev("triplet_valid"),
        ),
    )


class _SizedIter:
    def __init__(self, it, n):
        self.it, self.n = iter(it), n

    def __len__(self):
        return self.n

    def __iter__(self):
        return self.it


@torch.no_grad()
def evaluate_hoi(
    apply_fn,
    model: torch.nn.Module,
    dataset,
    cfg: ModelConfig,
    text_encoder: CachedTextEncoder,
    batch_size: int = 8,
    bucket=(832, 1344),
):
    """Full-vocabulary HICO-style evaluation on the model's device, with
    the JAX function's defaults (subject class 0, no NMS filter, every
    image). apply_fn(model, pixels, valid, text_emb, text_valid, n_obj) ->
    output dict. Returns the evaluator's stats dict."""
    device = next(model.parameters()).device
    obj_texts = list(dataset.object_text) + ["no objects"]
    verb_texts = list(dataset.verb_text)
    n_obj, n_verb = len(obj_texts), len(verb_texts)
    feats = text_encoder(obj_texts + verb_texts)  # (n_obj + n_verb, D)
    n_images = len(dataset)

    def make_eval_batch(start):
        samples = [dataset[i] for i in range(start, min(start + batch_size, n_images))]
        images = [s[0] for s in samples]
        B = len(images)
        H, W = bucket
        pixels = np.zeros((B, H, W, 3), np.asarray(images[0]).dtype)
        valid = np.zeros((B, H, W), bool)
        for b, im in enumerate(images):
            h, w = im.shape[:2]
            if h > H or w > W:
                raise ValueError(f"eval image ({h},{w}) exceeds the bucket ({H},{W})")
            pixels[b, :h, :w] = im
            valid[b, :h, :w] = True
        text_emb = np.tile(feats[None], (B, 1, 1))
        text_valid = np.ones((B, n_obj + n_verb), bool)
        return pixels, valid, text_emb, text_valid, [s[1] for s in samples]

    def to_device(a):
        return torch.from_numpy(a).to(device, non_blocking=True)

    preds, gts = [], []
    for pixels, valid, text_emb, text_valid, targets in prefetch_map(
        make_eval_batch, range(0, n_images, batch_size), num_workers=2
    ):
        out = apply_fn(
            model, to_device(pixels), to_device(valid), to_device(text_emb),
            to_device(text_valid), n_obj,
        )
        orig = to_device(np.stack([t["orig_size"] for t in targets]).astype(np.float32))
        preds.extend(to_image_results(postprocess_hoi(out, orig), SUBJECT_CATEGORY_ID))
        gts.extend(
            {
                "filename": t["filename"],
                "boxes": np.asarray(t["boxes"]),
                "labels": np.asarray(t["labels"]),
                "hois": np.asarray(t["hois"]),
            }
            for t in targets
        )
    return _run_hico_evaluator(dataset, preds, gts, n_obj, n_verb)


def _run_hico_evaluator(dataset, preds, gts, n_obj, n_verb):
    correct_mat = dataset.correct_mat
    if correct_mat is None:
        correct_mat = np.ones((n_verb, n_obj - 1), np.float64)
    return HICOEvaluator(
        preds,
        gts,
        dataset.rare_triplets,
        dataset.non_rare_triplets,
        correct_mat,
    ).evaluate()
