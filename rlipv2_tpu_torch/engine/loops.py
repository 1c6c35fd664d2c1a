"""Host-side train and evaluation loops (counterpart of
rlipv2_tpu/engine/loops.py:40, :77, :237, :340, :613, :657, :683).

`train_one_epoch` builds each batch on host threads (text merge, negative
sampling, slot packing, padding to a bucket; `data/pipeline.py`), takes
the slot texts' features from a `CachedTextEncoder` or, for in-graph
text-encoder training, their tokens from `tokenize_fn`, moves the batch to
the model's device and runs the train step; the step's metrics are read one
step late, so the host never waits for a step that is still running. The
time the loop waits for each batch is logged as `host_wait_s`. With
`accumulation_steps` K > 1 (pre-training over interleaved datasets) each
step takes a group of K micro-batches, each with its own negative texts
and slots, all padded to the group's largest bucket.

`evaluate_hoi`, `evaluate_vcoco`, `evaluate_sgg` and
`evaluate_hoi_matching_uniformity` (the verb-feature uniformity and
alignment analysis of RLIPv2's paper) share `_collect_predictions`: it encodes the label vocabulary once through a
`CachedTextEncoder`, pads each batch of images into a bucket with a
pixel-validity mask, runs `apply_fn(model, pixels, valid, text_emb,
text_valid, n_obj)` on the model's device and post-processes there; batches
are packed on host threads while the device runs the previous one. The
host-side per-image results go to the HICO evaluator (with the pairwise
triplet NMS when asked), the V-COCO evaluator, or the Open Images SGG
evaluator at top-50 and top-100 with the composite score.

Data-parallel (one process a card, `parallel/mesh.py`): `train_one_epoch`
builds each rank's slice of every global batch, equal to that part of the
one-process batch, and `evaluate_hoi(rank=, world=)` scores a strided
shard, gathers fixed-shape arrays and dedupes (JAX :237-280, :555-610).
"""

from __future__ import annotations

import contextlib
import math
import random
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from rlipv2_tpu_torch.config import ModelConfig
from rlipv2_tpu_torch.data.collate import pick_bucket
from rlipv2_tpu_torch.data.loader import batch_rng, prefetch_map
from rlipv2_tpu_torch.data.pipeline import build_train_batch
from rlipv2_tpu_torch.data.transforms import item_stream
from rlipv2_tpu_torch.engine.train import TrainBatch, check_trainable
from rlipv2_tpu_torch.eval.hico_eval import HICOEvaluator
from rlipv2_tpu_torch.eval.oi_sgg_eval import OISGGEvaluator, score_wtd
from rlipv2_tpu_torch.eval.postprocess import postprocess_hoi, postprocess_sgg, to_image_results
from rlipv2_tpu_torch.eval.vcoco_eval import VCOCOEvaluator
from rlipv2_tpu_torch.parallel.dist_eval import DistEvalBuffer, pad_gt_arrays, shard_indices, unpack_gt_arrays
from rlipv2_tpu_torch.parallel.mesh import DataParallel
from rlipv2_tpu_torch.structures import HOITargets
from rlipv2_tpu_torch.utils.logging import MetricLogger

SUBJECT_CATEGORY_ID = 0  # HICO's "person"
# the final layer's class terms the train loop logs, where the criterion gives them
CLASS_TERMS = ("loss_obj_ce", "loss_obj_matching", "loss_verb_ce", "loss_verb_matching")


class CachedTextEncoder:
    """Memoizes pooled text features per unique label text. `clear()`
    drops them: features of a text encoder that has trained since are
    stale."""

    def __init__(self, encode_fn: Callable[[Sequence[str]], np.ndarray]):
        self.encode_fn = encode_fn
        self.cache: dict[str, np.ndarray] = {}

    def clear(self) -> None:
        self.cache.clear()

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
    augment_rng: Optional[random.Random] = None,
    mesh: Optional[DataParallel] = None,
):
    """One epoch of `step_fn(TrainBatch) -> metrics` (engine/train.py) over
    `dataset`, with the JAX loop's signature and defaults; `model` takes
    the place of the JAX train state: the step updates it in place, and it
    is returned as given, beside {metric: global average}.

    indices + batch_size give a plain epoch; batch_lists gives pre-built
    whole batches (`data/vg.py::batch_iterative_indices`), and with
    accumulation_steps K > 1 each of its entries is a group of K index
    lists: the step gets K TrainBatches built in turn from one rng, each
    padded (pixels and pixel_valid, with zeros) to the largest height and
    width in the group, as the JAX loop pads before it stacks them (the
    reference pads each micro-batch on its own; ROADMAP queue 3).
    num_workers > 0 builds batches in a threaded prefetch
    window, each from its own deterministic rng stream. A non-finite loss
    raises FloatingPointError (the reference aborts training), one step
    after the step that made it. `text_encoder` should already hold every
    slot text: encoding on a worker thread would run the model beside the
    train step. tokenize_fn (texts -> (ids, mask) int arrays) puts the slot
    texts' tokens into the batch, and the step encodes them in the graph
    (in-graph text-encoder training); the cached features are then taken
    only for the offline pseudo-verb target. A config with an int8
    inference option raises ValueError (`engine/train.py::check_trainable`).

    augment_rng: each global batch draws one seed an image from it, in
    order, on the loop's thread, and image k of the batch is read inside
    `data/transforms.py::item_stream(random.Random(seed k))`, so its
    augmentations draw the same whichever thread, process or rank reads
    it; None leaves the dataset's own stream.

    mesh, a DataParallel (`parallel/mesh.py`): `batch_size` and the
    batches of `batch_lists` are global batches, and this rank builds,
    reads and uploads only its contiguous slice of each (`step_fn` being
    the data-parallel step of `make_train_step(mesh=...)`). The slice
    equals that part of the one-process batch: the images' label texts and
    sizes are gathered over the host group, in batch order, as
    fixed-shape int arrays, so every rank builds the global batch's text
    slots and negatives (from the same `rng`) and pads to the global
    batch's bucket (with accumulation, to the group's largest over every
    rank); with `augment_rng` each image draws its own stream. It needs
    the label vocabularies `obj_vocab` and `verb_vocab`, which hold
    every label text. Only rank 0 prints."""
    check_trainable(cfg)
    if accumulation_steps > 1 and batch_lists is None:
        raise ValueError("accumulation_steps > 1 takes its groups of micro-batches from batch_lists")
    if mesh is not None and batch_lists is None and batch_size % mesh.world:
        raise ValueError(f"the global batch size {batch_size} does not divide over the world size {mesh.world}")
    if mesh is not None and (obj_vocab is None or verb_vocab is None):
        raise ValueError("a data-parallel epoch gathers label texts as indices into obj_vocab and verb_vocab")
    device = next(model.parameters()).device
    rng = rng or random.Random(epoch)
    if max_triplets is None:
        # the matcher needs M <= n_pairs (= num_queries // 2)
        max_triplets = min(64, cfg.num_queries // 2)
    if logger is None:
        quiet = mesh is not None and mesh.rank != 0
        logger = MetricLogger(print_fn=(lambda *_: None) if quiet else print)
    n_batches = len(batch_lists) if batch_lists is not None else len(indices) // batch_size
    if max_steps is not None:
        n_batches = min(n_batches, max_steps)
    cached_features = tokenize_fn is None or (cfg.pseudo_verb and cfg.pseudo_verb_mode == "offline")

    def batches():
        """(global batch, each image's stream seed or None), in order."""
        def seeds(ids):
            return [augment_rng.getrandbits(64) for _ in ids] if augment_rng is not None else [None] * len(ids)

        for i in range(n_batches):
            if batch_lists is None:
                ids = indices[i * batch_size : (i + 1) * batch_size]
                yield ids, seeds(ids)
            elif accumulation_steps > 1:
                group = [list(ids) for ids in batch_lists[i]]
                yield group, [seeds(ids) for ids in group]
            else:
                ids = list(batch_lists[i])
                yield ids, seeds(ids)

    def read(i, seed):
        if seed is None:
            return dataset[i]
        with item_stream(random.Random(seed)):
            return dataset[i]

    obj_index = verb_index = None
    if mesh is not None:
        obj_index = {t: j for j, t in enumerate(obj_vocab)}
        verb_index = {t: j for j, t in enumerate(verb_vocab)}

    def global_layout(samples) -> tuple:
        """This rank's part of a global batch -> (every image's object and
        verb label texts, the batch's bucket), gathered over the host
        group."""
        def ids(texts, index):
            missing = [t for t in texts if t not in index]
            if missing:
                raise ValueError(f"label texts {missing[:3]} are not in the vocabulary the epoch was given")
            return [index[t] for t in texts]

        own = [(ids(t["obj_classes"], obj_index), ids(t["verb_classes"], verb_index)) for _, t in samples]
        sizes = mesh.gather_numpy(np.asarray([[im.shape[0], im.shape[1], len(o), len(v)]
                                              for (im, _), (o, v) in zip(samples, own)], np.int64), host=True)
        sizes = sizes.reshape(-1, 4)
        n_o, n_v = int(sizes[:, 2].max()), int(sizes[:, 3].max())
        packed = np.full((len(own), n_o + n_v), -1, np.int64)
        for b, (o, v) in enumerate(own):
            packed[b, : len(o)], packed[b, n_o : n_o + len(v)] = o, v
        every = mesh.gather_numpy(packed, host=True).reshape(-1, n_o + n_v)
        obj_texts = [[obj_vocab[j] for j in row[:n_o] if j >= 0] for row in every]
        verb_texts = [[verb_vocab[j] for j in row[n_o:] if j >= 0] for row in every]
        return obj_texts, verb_texts, pick_bucket(int(sizes[:, 0].max()), int(sizes[:, 1].max()))

    def read_slice(batch_ids, item_seeds) -> tuple:
        """The samples of this rank's slice of a global batch (the whole
        batch in one process) and the slice's first index."""
        start = 0
        if mesh is not None:
            own = mesh.batch_slice(len(batch_ids))
            batch_ids, item_seeds, start = batch_ids[own], item_seeds[own], own.start
        return [read(i, seed) for i, seed in zip(batch_ids, item_seeds)], start

    def make_one(samples, layout: dict, b_rng) -> dict:
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
            rng=b_rng,
            **layout,
        )
        slot_texts = [t if t else "." for t in list(obj_slots) + list(verb_slots)]  # pad slots encode '.'
        if cached_features:
            feats = text_encoder(slot_texts)
            B = arrays["pixels"].shape[0]
            arrays["text_emb"] = np.ascontiguousarray(np.broadcast_to(feats[None], (B, *feats.shape)))
        if tokenize_fn is not None:
            arrays["token_ids"], arrays["token_mask"] = (np.asarray(a, np.int64) for a in tokenize_fn(slot_texts))
        arrays["text_valid"] = np.concatenate([arrays["obj_text_valid"], arrays["verb_text_valid"]], axis=1)
        return arrays

    def pinned(arrays: dict) -> dict:
        # pinned on the worker thread, so the copy to the card is asynchronous
        return {k: _host_tensor(v, device) for k, v in arrays.items()}

    in_order = _InOrder()

    def layouts(bidx: int, reads: list) -> list:
        """build_train_batch's global layout of each micro-batch read: its
        texts and bucket gathered over the host group, whose calls the
        loader's threads make in batch order. A batch takes its turn even
        when its read failed, so the later batches' threads never wait for
        it."""
        with in_order.turn(bidx):
            if isinstance(reads, BaseException):
                raise reads
            out = []
            for samples, start in reads:
                obj_texts, verb_texts, bucket = global_layout(samples)
                out.append(dict(batch_texts=(obj_texts, verb_texts, start), bucket=bucket))
            return out

    def make_batch(job):
        bidx, (batch_ids, item_seeds) = job
        b_rng = rng if num_workers <= 0 else batch_rng(0, epoch, bidx)
        groups = [(batch_ids, item_seeds)] if accumulation_steps == 1 else list(zip(batch_ids, item_seeds))
        try:
            reads = [read_slice(ids, seeds) for ids, seeds in groups]
        except BaseException as e:
            if mesh is None:
                raise
            reads = e
        extra = layouts(bidx, reads) if mesh is not None else [{}] * len(reads)
        micros = [make_one(samples, layout, b_rng) for (samples, _), layout in zip(reads, extra)]
        if accumulation_steps == 1:
            return pinned(micros[0])
        H = max(m["pixels"].shape[1] for m in micros)
        W = max(m["pixels"].shape[2] for m in micros)
        for m in micros:
            for k in ("pixels", "pixel_valid"):
                x = m[k]
                pad = [(0, 0), (0, H - x.shape[1]), (0, W - x.shape[2])] + [(0, 0)] * (x.ndim - 3)
                m[k] = np.pad(x, pad)
        return [pinned(m) for m in micros]

    def flush(metrics):
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss} at epoch {epoch}")
        # the class terms the loss types give: CE forms or the contrastive
        # ones (the JAX loop reads only the CE keys and raises KeyError on
        # cross_modal_matching: ROADMAP queue 3)
        terms = {k[len("loss_"):]: float(metrics[k]) for k in CLASS_TERMS if k in metrics}
        logger.update(loss=loss, grad_norm=float(metrics["grad_norm"]), **terms)

    def timed(it):
        """The batches, each with the time the loop waited for it."""
        while True:
            t0 = time.perf_counter()
            try:
                host = next(it)
            except StopIteration:
                return
            yield host, time.perf_counter() - t0

    pending = None
    batch_iter = timed(prefetch_map(make_batch, enumerate(batches()), num_workers))
    for host, wait in logger.log_every(_SizedIter(batch_iter, n_batches), print_freq, f"Epoch [{epoch}]"):
        logger.update(host_wait_s=wait)
        batch = [_train_batch(m, device) for m in host] if accumulation_steps > 1 else _train_batch(host, device)
        metrics = step_fn(batch)
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
        text_emb=dev("text_emb") if "text_emb" in host else None,
        text_valid=dev("text_valid"),
        targets=HOITargets(
            obj_labels=dev("obj_labels"),
            sub_labels=dev("sub_labels"),
            verb_labels=dev("verb_labels"),
            sub_boxes=dev("sub_boxes"),
            obj_boxes=dev("obj_boxes"),
            valid=dev("triplet_valid"),
        ),
        token_ids=dev("token_ids") if "token_ids" in host else None,
        token_mask=dev("token_mask") if "token_mask" in host else None,
    )


class _InOrder:
    """Lets the loader's threads take turns in batch order."""

    def __init__(self):
        self.next = 0
        self.cond = threading.Condition()

    @contextlib.contextmanager
    def turn(self, i: int):
        with self.cond:
            self.cond.wait_for(lambda: self.next == i)
        try:
            yield
        finally:
            with self.cond:
                self.next += 1
                self.cond.notify_all()


class _SizedIter:
    def __init__(self, it, n):
        self.it, self.n = iter(it), n

    def __len__(self):
        return self.n

    def __iter__(self):
        return self.it


@torch.no_grad()
def _collect_predictions(apply_fn, model: torch.nn.Module, dataset, text_encoder: CachedTextEncoder,
                         batch_size: int, bucket, sgg: bool = False, on_batch=None, indices=None, on_post=None):
    """Every image of `dataset` through `apply_fn` against the dataset's
    whole vocabulary (its object texts, the no-object text, its verb
    texts). Returns the per-image results of `to_image_results` and the
    dataset's targets. `bucket=None` pads each batch to the smallest of
    `data/collate.py`'s buckets that holds it, as the train batches are:
    portrait images resize to 1333 x 800 (H x W) and do not fit the
    landscape (832, 1344). With `sgg`, an output that has `pred_sub_logits`
    is post-processed by `postprocess_sgg`; every other output by
    `postprocess_hoi` with verb curing, which cures the verb scores of a
    model with the curing heads (the JAX loops never pass it: ROADMAP
    queue 3). `on_batch(out, targets)` sees each batch's outputs and
    targets. `indices` (default: every image in order) are the images to
    score; `on_post(ids, post, targets)` then takes each batch's
    post-processed tensors, and the lists returned stay empty."""
    device = next(model.parameters()).device
    obj_texts = list(dataset.object_text) + ["no objects"]
    verb_texts = list(dataset.verb_text)
    n_obj, n_verb = len(obj_texts), len(verb_texts)
    feats = text_encoder(obj_texts + verb_texts)  # (n_obj + n_verb, D)
    order = list(range(len(dataset))) if indices is None else list(indices)

    def make_eval_batch(start):
        ids = order[start : start + batch_size]
        samples = [dataset[i] for i in ids]
        images = [s[0] for s in samples]
        B = len(images)
        H, W = bucket or pick_bucket(max(im.shape[0] for im in images), max(im.shape[1] for im in images))
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
        return ids, pixels, valid, text_emb, text_valid, [s[1] for s in samples]

    def to_device(a):
        return torch.from_numpy(a).to(device, non_blocking=True)

    preds, targets = [], []
    for ids, pixels, valid, text_emb, text_valid, batch_targets in prefetch_map(
        make_eval_batch, range(0, len(order), batch_size), num_workers=2
    ):
        out = apply_fn(
            model, to_device(pixels), to_device(valid), to_device(text_emb),
            to_device(text_valid), n_obj,
        )
        if on_batch is not None:
            on_batch(out, batch_targets)
        orig = to_device(np.stack([t["orig_size"] for t in batch_targets]).astype(np.float32))
        post = (postprocess_sgg(out, orig) if sgg and "pred_sub_logits" in out
                else postprocess_hoi(out, orig))
        if on_post is not None:
            on_post(ids, post, batch_targets)
            continue
        preds.extend(to_image_results(post, SUBJECT_CATEGORY_ID))
        targets.extend(batch_targets)
    return preds, targets


def _gt(t: dict, relations: str = "hois") -> dict:
    return {"filename": t["filename"], "boxes": np.asarray(t["boxes"]), "labels": np.asarray(t["labels"]),
            relations: np.asarray(t["hois"])}


def evaluate_hoi(
    apply_fn,
    model: torch.nn.Module,
    dataset,
    cfg: ModelConfig,
    text_encoder: CachedTextEncoder,
    batch_size: int = 8,
    bucket=(832, 1344),
    use_nms_filter: bool = False,
    rank: int = 0,
    world: int = 1,
    gather_fn=None,
    max_gt_boxes: int = 128,
    max_gt_hois: int = 128,
):
    """Full-vocabulary HICO-style evaluation on the model's device, with
    the JAX function's defaults (subject class 0, every image).
    apply_fn(model, pixels, valid, text_emb, text_valid, n_obj) -> output
    dict; `use_nms_filter` runs the evaluator's pairwise triplet NMS;
    `bucket=None` picks a bucket per batch (`_collect_predictions`).
    Returns the evaluator's stats dict.

    Several processes (JAX :237-280): give `rank` and `world` (and
    `gather_fn`, default `parallel/dist_eval.py::default_gather` over the
    joined process group). Each rank scores its wrap-padded strided shard
    in batches of `batch_size`, the fixed-shape predictions and padded GTs
    (at most `max_gt_boxes` boxes and `max_gt_hois` HOIs an image) are
    gathered, and the dedupe by image index rebuilds the one-process list;
    every rank then runs the evaluator. With `bucket=None` a rank's batch
    pads to its own bucket, so an image whose batch-mates differ from the
    one-process run's may pad differently, which moves its scores through
    the GroupNorm moments of the padded maps (ROADMAP queue 3)."""
    n_obj, n_verb = len(dataset.object_text) + 1, len(dataset.verb_text)
    if world > 1 or gather_fn is not None:
        preds, gts = _collect_predictions_sharded(apply_fn, model, dataset, text_encoder, batch_size, bucket, rank,
                                                  world, gather_fn, max_gt_boxes, max_gt_hois)
        return _run_hico_evaluator(dataset, preds, gts, n_obj, n_verb, use_nms_filter)
    preds, targets = _collect_predictions(apply_fn, model, dataset, text_encoder, batch_size, bucket)
    return _run_hico_evaluator(dataset, preds, [_gt(t) for t in targets], n_obj, n_verb, use_nms_filter)


def _collect_predictions_sharded(apply_fn, model, dataset, text_encoder, batch_size, bucket, rank, world,
                                 gather_fn, max_gt_boxes, max_gt_hois):
    """The rank's wrap-padded strided shard (JAX :555-610), padded by
    wrapping to whole batches so every rank's arrays have one shape, then
    the gather and the dedupe: (per-image results, GTs) in image order."""
    idx = shard_indices(len(dataset), rank, world)
    idx = [idx[j % len(idx)] for j in range(-(-len(idx) // batch_size) * batch_size)]
    buf = DistEvalBuffer()

    def keep(ids, post, targets):
        tree = {k: v.detach().cpu().numpy() for k, v in post.items()}
        tree.update(pad_gt_arrays(targets, max_gt_boxes, max_gt_hois))
        buf.add(ids, tree)

    _collect_predictions(apply_fn, model, dataset, text_encoder, batch_size, bucket, indices=idx, on_post=keep)
    _, tree = buf.gather_and_dedupe(gather_fn)
    gt_tree = {k: tree.pop(k) for k in list(tree) if k.startswith("gt_")}
    preds = to_image_results({k: torch.from_numpy(v) for k, v in tree.items()}, SUBJECT_CATEGORY_ID)
    return preds, unpack_gt_arrays(gt_tree)


def evaluate_vcoco(
    apply_fn,
    model: torch.nn.Module,
    dataset,
    cfg: ModelConfig,
    text_encoder: CachedTextEncoder,
    batch_size: int = 8,
    bucket=(832, 1344),
):
    """V-COCO evaluation ("mAP all", "mAP thesis" and the per-action APs;
    reference engine.py's vcoco branch), as `evaluate_hoi` collects the
    results; the dataset's correct_mat, or all ones."""
    preds, targets = _collect_predictions(apply_fn, model, dataset, text_encoder, batch_size, bucket)
    correct_mat = dataset.correct_mat
    if correct_mat is None:
        correct_mat = np.ones((len(dataset.verb_text), len(dataset.object_text)), np.float64)
    return VCOCOEvaluator(preds, [_gt(t) for t in targets], correct_mat).evaluate()


def evaluate_sgg(
    apply_fn,
    model: torch.nn.Module,
    dataset,
    cfg: ModelConfig,
    text_encoder: CachedTextEncoder,
    batch_size: int = 8,
    bucket=(832, 1344),
    use_nms_filter: bool = False,
):
    """Open Images v6 SGG evaluation at top-50 and top-100 with the
    composite `score_wtd` (reference engine.py:472-569,
    evaluate_sgg_with_text), as `evaluate_hoi` collects the results."""
    preds, targets = _collect_predictions(apply_fn, model, dataset, text_encoder, batch_size, bucket, sgg=True)
    gts = [_gt(t, "rels") for t in targets]
    r50 = OISGGEvaluator(preds, gts, topk=50, use_nms_filter=use_nms_filter).evaluate()
    r100 = OISGGEvaluator(preds, gts, topk=100, use_nms_filter=use_nms_filter).evaluate()
    return {**r50, **r100, **score_wtd(r50, r100)}


# the uniformity analysis' matcher weights (object class, verb class, L1,
# GIoU) and GT pairs an image, the JAX function's defaults
UNIFORMITY_COSTS = dict(cost_obj_class=1.0, cost_verb_class=1.0, cost_bbox=2.5, cost_giou=1.0)
UNIFORMITY_MAX_GT = 64


def uniformity_targets(targets: Sequence[dict], n_verb: int, device: torch.device, max_gt: int) -> HOITargets:
    """Val-format GTs (boxes, labels and hois in original pixels) padded
    into matcher targets: one slot per distinct (subject, object) pair, in
    the order of its first hoi, at most `max_gt` an image, with its object
    label, multi-hot verbs and normalized cxcywh boxes (JAX :421-466)."""
    B = len(targets)
    obj_l = np.zeros((B, max_gt), np.int64)
    verb_l = np.zeros((B, max_gt, n_verb), np.float32)
    sub_b = np.zeros((B, max_gt, 4), np.float32)
    obj_b = np.zeros((B, max_gt, 4), np.float32)
    valid = np.zeros((B, max_gt), bool)
    for b, t in enumerate(targets):
        h, w = (float(x) for x in t["orig_size"])
        boxes = np.asarray(t["boxes"], np.float32).reshape(-1, 4)
        if not boxes.size:
            continue
        cxcywh = np.stack([(boxes[:, 0] + boxes[:, 2]) / 2.0 / w, (boxes[:, 1] + boxes[:, 3]) / 2.0 / h,
                           (boxes[:, 2] - boxes[:, 0]) / w, (boxes[:, 3] - boxes[:, 1]) / h], axis=1)
        labels = np.asarray(t["labels"]).reshape(-1)
        pairs: dict = {}
        for s_, o, v in np.asarray(t["hois"]).reshape(-1, 3):
            key = (int(s_), int(o))
            if key not in pairs:
                if len(pairs) >= max_gt:
                    continue
                m = pairs[key] = len(pairs)
                obj_l[b, m], sub_b[b, m], obj_b[b, m], valid[b, m] = labels[key[1]], cxcywh[key[0]], cxcywh[key[1]], True
            verb_l[b, pairs[key], int(v)] = 1.0
    arrays = dict(obj_labels=obj_l, sub_labels=np.full((B, max_gt), SUBJECT_CATEGORY_ID, np.int64),
                  verb_labels=verb_l, sub_boxes=sub_b, obj_boxes=obj_b, valid=valid)
    return HOITargets(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})


def evaluate_hoi_matching_uniformity(
    apply_fn,
    model: torch.nn.Module,
    dataset,
    cfg: ModelConfig,
    text_encoder: CachedTextEncoder,
    batch_size: int = 8,
    bucket=(832, 1344),
    use_nms_filter: bool = False,
    save_path: Optional[str] = None,
):
    """`evaluate_hoi` that also Hungarian-matches each batch's predictions
    to its GT pairs (`uniformity_targets`, the port's matcher at
    UNIFORMITY_COSTS over every verb slot; at most UNIFORMITY_MAX_GT pairs
    an image, or the model's pair queries if fewer, which the JAX function
    would refuse) and collects the last verb
    decoder layer's state (`verb_decoder_out`) at each matched query under
    each of its GT verbs (JAX :355-555, reference engine.py:573-697).
    Returns (stats, analysis, class_features): the evaluator's stats, the
    Wang-Isola summary of `tools/uniformity.py::analyze` (zeros when no
    verb was matched) and {verb class: [feature (C,) float32, ...]},
    saved with `np.savez_compressed` under the key `verb_class_dict` (a
    pickled object array of {class: (n, C) array}) to `save_path` when
    given, as the JAX function writes it."""
    from rlipv2_tpu_torch.losses.matcher import assign, finite_costs, hoi_matching_costs
    from rlipv2_tpu_torch.tools.uniformity import analyze

    n_verb = len(dataset.verb_text)
    class_features: dict[int, list] = {v: [] for v in range(n_verb)}

    def collect(out, targets):
        if "verb_decoder_out" not in out:
            raise KeyError("the uniformity analysis reads the outputs' verb_decoder_out")
        logits = out["pred_obj_logits"]
        tgt = uniformity_targets(targets, n_verb, logits.device, min(UNIFORMITY_MAX_GT, logits.shape[1]))
        verb_valid = torch.ones((len(targets), n_verb), dtype=torch.bool, device=tgt.valid.device)
        costs = hoi_matching_costs(out, tgt, verb_valid, **UNIFORMITY_COSTS).total
        valid, verbs = tgt.valid.cpu().numpy(), tgt.verb_labels.cpu().numpy()
        match = assign(finite_costs(costs.float().cpu().numpy())[None], valid)[0]
        feats = out["verb_decoder_out"].float().cpu().numpy()
        for b in range(len(targets)):
            for m in np.flatnonzero(valid[b]):
                for v in np.flatnonzero(verbs[b, m]):
                    class_features[int(v)].append(feats[b, match[b, m]])

    preds, targets = _collect_predictions(apply_fn, model, dataset, text_encoder, batch_size, bucket,
                                          on_batch=collect)
    n_obj = len(dataset.object_text) + 1
    stats = _run_hico_evaluator(dataset, preds, [_gt(t) for t in targets], n_obj, n_verb, use_nms_filter)
    if save_path is not None:
        np.savez_compressed(save_path, verb_class_dict=np.asarray(
            {v: np.asarray(f) for v, f in class_features.items()}, dtype=object))
    nonempty = {v: np.stack(f) for v, f in class_features.items() if f}
    analysis = analyze(nonempty) if nonempty else {"uniformity": 0.0, "alignment": 0.0, "n_classes": 0,
                                                   "n_features": 0}
    return stats, analysis, class_features


def _run_hico_evaluator(dataset, preds, gts, n_obj, n_verb, use_nms_filter):
    correct_mat = dataset.correct_mat
    if correct_mat is None:
        correct_mat = np.ones((n_verb, n_obj - 1), np.float64)
    return HICOEvaluator(
        preds,
        gts,
        dataset.rare_triplets,
        dataset.non_rare_triplets,
        correct_mat,
        use_nms_filter=use_nms_filter,
    ).evaluate()
