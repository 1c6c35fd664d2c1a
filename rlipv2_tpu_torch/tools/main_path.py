"""The models of the port's main paths, built once for every tool that runs them.

Presets rlip_parseda_v2_r50 and rlip_parseda_v2_swin_l (Swin-L,
`swin_large_384`) at full width with HICO's text slots (81 object, 117
verb) and RoBERTa-base at 12 layers, as the JAX package's benchmark builds
them, with seeded random weights in the reference state-dict layout.
`chip_smoke.py` and `tools/profile_forward.py` take the inference models from
`main_path_model` (R50), `main_path_swin_model` (Swin-L) and
`main_path_int8_model` (R50 on the int8 inference path); `chip_smoke.py`
and `tools/profile_train.py` take the train step from `main_train_step` and
its data from `main_train_data`, so the profiled model is the smoke's model;
`chip_smoke.py` and `tools/profile_finetune.py` run the command line's
fine-tune on the tree that `main_finetune_tree` writes, and its VG and
mixed VG + COCO pre-training on the tree that `main_pretrain_tree` writes.
"""

from __future__ import annotations

import dataclasses
import subprocess

import torch

from rlipv2_tpu_torch.config import TextEncoderConfig, rlip_parseda_v2_r50, rlip_parseda_v2_swin
from rlipv2_tpu_torch.tools.golden_pack import synth_state_dict

BATCH, BUCKET = 8, (832, 1344)  # HICO val images resize to at most 800 x 1333
PRETRAINED_QUERIES = 100  # the fine-tune's pretrained.pth; the preset has 200, tiled at load
# the pre-training tree's VG, COCO and O365 images: 25 full groups an epoch
PRETRAIN_IMAGES = (200, 200, 0)
SEED = 0
# train images: HICO's multi-scale resize gives a short side up to 800 and a
# long side up to 1333; a width above 1024 puts every batch in BUCKET
TRAIN_MIN_SIZE, TRAIN_MAX_SIZE = (600, 1088), (800, 1333)


def gpu_name_and_power_limit() -> str:
    """The first card's `name, power.limit` as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def random_state_dict(model: torch.nn.Module) -> dict:
    """Weights for `model` drawn from SEED by `synth_state_dict` from the
    model's own state-dict manifest."""
    sd = model.state_dict()
    names = list(sd)
    arrays = synth_state_dict(
        names,
        [tuple(sd[k].shape) for k in names],
        [str(sd[k].dtype).replace("torch.", "") for k in names],
        seed=SEED,
    )
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _seeded_model(preset=rlip_parseda_v2_r50, msda_impl: str = "auto", int8_dense: bool = False):
    from rlipv2_tpu_torch.models.parseda import RLIPParSeDA

    base = preset()
    cfg = dataclasses.replace(
        base,
        text_encoder=TextEncoderConfig(num_layers=12),
        max_obj_texts=81,
        max_verb_texts=117,
        backbone=dataclasses.replace(base.backbone, int8_dense=int8_dense),
        transformer=dataclasses.replace(base.transformer, msda_impl=msda_impl, int8_dense=int8_dense),
    )
    model = RLIPParSeDA(cfg)
    model.load_state_dict(random_state_dict(model), strict=True)
    return cfg, model


def main_path_model(device="cuda"):
    """(cfg, model): the main path's RLIPParSeDA with seeded weights loaded
    strictly, on `device`, in eval mode."""
    cfg, model = _seeded_model()
    return cfg, model.to(device).eval()


def main_path_swin_model(device="cuda"):
    """(cfg, model): the same with the Swin-L backbone (preset
    rlip_parseda_v2_swin_l: `swin_large_384`, window 12)."""
    cfg, model = _seeded_model(rlip_parseda_v2_swin)
    return cfg, model.to(device).eval()


def main_path_int8_model(device="cuda", dense: bool = False):
    """(cfg, model): `main_path_model` on the quantized inference path, as
    the JAX CLI's `--msda_impl pallas_int8` sets it (the int8 MSDA kernel in
    all 12 MSDA calls), and with `dense` also `--int8_dense` (W8A8
    projections on the backbone and the transformer). The same seeded
    weights; inference only."""
    cfg, model = _seeded_model(msda_impl="pallas_int8", int8_dense=dense)
    return cfg, model.to(device).eval()


def main_train_model(device="cuda"):
    """(cfg, model): the same model in train mode (dropout on) with the
    reference's frozen parameters (backbone stem and layer1) set."""
    from rlipv2_tpu_torch.engine.optim import freeze_backbone_stem_and_layer1

    cfg, model = _seeded_model()
    freeze_backbone_stem_and_layer1(model)
    return cfg, model.to(device).train()


def main_train_step(device="cuda"):
    """(cfg, model, train_step): `main_train_model` with the default
    LossConfig and TrainConfig: SetCriterionHOI, the three-group AdamW and
    its schedule, and `engine/train.py::make_train_step`."""
    from rlipv2_tpu_torch.config import LossConfig, TrainConfig
    from rlipv2_tpu_torch.engine.optim import build_optimizer
    from rlipv2_tpu_torch.engine.train import make_train_step
    from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI

    cfg, model = main_train_model(device)
    tcfg = TrainConfig()
    optimizer, scheduler = build_optimizer(model, tcfg)
    return cfg, model, make_train_step(model, SetCriterionHOI(LossConfig()), optimizer, scheduler, tcfg)


def main_train_data(cfg, model, n_images: int):
    """(dataset, text_encoder): a seeded synthetic HICO train split whose
    batches of BATCH land in BUCKET, and a CachedTextEncoder that already
    holds the features of every text a slot can take (the 80 object and 117
    verb names, the no-object text and the '.' of a padded slot), encoded
    by the model's RoBERTa in eval mode from hash tokens."""
    from rlipv2_tpu_torch.data.synthetic import SyntheticHICODataset, hash_tokenize
    from rlipv2_tpu_torch.data.text import NO_OBJ_TEXT
    from rlipv2_tpu_torch.engine.loops import CachedTextEncoder

    device = next(model.parameters()).device
    dataset = SyntheticHICODataset(
        n_images, min_size=TRAIN_MIN_SIZE, max_size=TRAIN_MAX_SIZE, seed=SEED, image_set="train"
    )

    @torch.no_grad()
    def encode_fn(texts):
        ids, mask = hash_tokenize(texts, cfg.text_encoder.vocab_size, maxlen=16)
        return model.encode_text(torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)).cpu().numpy()

    text_encoder = CachedTextEncoder(encode_fn)
    was_training = model.training
    model.eval()
    text_encoder(list(dataset.object_text) + list(dataset.verb_text) + [NO_OBJ_TEXT, "."])
    model.train(was_training)
    return dataset, text_encoder


def main_finetune_tree(root, n_train: int, n_val: int):
    """Write, under `root`, what scripts/finetune_hico_parseda_r50.sh reads:
    a HICO-DET tree over the JPEG fixture (`tools/hico_tree.py`; the train
    split takes the landscape files, so its batches land in phase 7's
    832x1344 bucket unless a crop turns one, the val split all six), a
    byte-level tokenizer learned from the label texts, and pretrained.pth:
    the main path's seeded weights for preset rlip_parseda_v2_r50 in the
    reference layout with PRETRAINED_QUERIES query embeddings.

    Returns (flags, initial): the script's flags for `cli.main` with these
    paths (no --output_dir, --epochs or --max_steps), and the state dict
    the run starts from (`write_pretrained`)."""
    from pathlib import Path

    from rlipv2_tpu_torch.data.text import NO_OBJ_TEXT
    from rlipv2_tpu_torch.data.vocab import HICO_OBJECT_NAMES, HICO_VERB_NAMES
    from rlipv2_tpu_torch.tools.hico_fixture import FIXTURE_DIR, FIXTURES
    from rlipv2_tpu_torch.tools.hico_tree import write_hico_tree, write_label_tokenizer

    root = Path(root)
    landscape = [(FIXTURE_DIR / f.name, f.height, f.width) for f in FIXTURES if f.width > f.height]
    every = [(FIXTURE_DIR / f.name, f.height, f.width) for f in FIXTURES]
    write_hico_tree(root / "hico", (landscape * n_train)[:n_train], (every * n_val)[:n_val])
    write_label_tokenizer(root / "roberta", list(HICO_OBJECT_NAMES) + [NO_OBJ_TEXT] + list(HICO_VERB_NAMES) + ["."])
    initial = write_pretrained(root / "pretrained.pth")
    flags = ["--preset", "rlip_parseda_v2_r50", "--dataset_file", "hico", "--hoi_path", str(root / "hico"),
             "--pretrained", str(root / "pretrained.pth"), "--giou_verb_label", "--pseudo_verb",
             "--negative_text_sampling", "500", "--sampling_strategy", "freq", "--use_nms_filter",
             "--tokenizer_dir", str(root / "roberta"), "--batch_size", str(BATCH)]
    return flags, initial


def write_pretrained(path) -> dict:
    """Write `path`, the main path's seeded weights for preset
    rlip_parseda_v2_r50 in the reference layout with PRETRAINED_QUERIES
    query embeddings, and return the state dict a run starts from (the
    queries tiled, each box head shared by two names holding the value
    loaded last)."""
    from rlipv2_tpu_torch.config import PRESETS
    from rlipv2_tpu_torch.engine.convert import QUERY_EMBEDDINGS, fit_query_embeddings
    from rlipv2_tpu_torch.models.parseda import RLIPParSeDA

    cfg = PRESETS["rlip_parseda_v2_r50"]()
    model = RLIPParSeDA(cfg)
    seeded = random_state_dict(model)
    pretrained = {k: (v[:PRETRAINED_QUERIES] if k in QUERY_EMBEDDINGS else v) for k, v in seeded.items()}
    torch.save({"model": pretrained}, path)
    model.load_state_dict(fit_query_embeddings(pretrained, cfg.num_queries), strict=True)
    return model.state_dict()


def main_pretrain_tree(root, mixed: bool = True):
    """Write, under `root`, what scripts/pretrain_mixed_vgcoco_parseda_r50.sh
    (or with `mixed` False scripts/pretrain_vg_parseda_r50.sh) reads: a
    VG-format tree (`tools/vg_tree.py`: VG and pseudo-labelled COCO
    annotations of PRETRAIN_IMAGES images over copies of the JPEG
    fixture's six files; 1200 object names and 320 predicates), a
    byte-level tokenizer learned from its label texts, and pretrained.pth
    (`write_pretrained`).

    Returns (flags, initial, tree): the script's flags for `cli.main` with
    these paths (no --output_dir, --epochs or --max_steps), the state dict
    the run starts from, and `write_vg_tree`'s paths."""
    from pathlib import Path

    from rlipv2_tpu_torch.data.text import NO_OBJ_TEXT
    from rlipv2_tpu_torch.tools.hico_fixture import FIXTURE_DIR, FIXTURES
    from rlipv2_tpu_torch.tools.hico_tree import write_label_tokenizer
    from rlipv2_tpu_torch.tools.vg_tree import write_vg_tree

    root = Path(root)
    tree = write_vg_tree(root / "tree", [(FIXTURE_DIR / f.name, f.height, f.width) for f in FIXTURES],
                         n_images=PRETRAIN_IMAGES, seed=SEED)
    write_label_tokenizer(root / "roberta", tree["texts"] + [NO_OBJ_TEXT, "."])
    initial = write_pretrained(root / "pretrained.pth")
    data = ["--pretrain_anno", str(tree["vg_anno"]), "--vg_folder", str(tree["vg_folder"])]
    if mixed:
        data = ["--pretrain_anno", f"{tree['vg_anno']},{tree['coco_anno']}", "--vg_folder", str(tree["vg_folder"]),
                "--coco2017_folder", str(tree["coco2017_folder"]), "--iterative_paradigm", "0,1",
                "--relation_threshold", "0.2", "--pair_overlap"]
    flags = ["--preset", "rlip_parseda_v2_r50", "--dataset_file", "pretrain", *data,
             "--negative_text_sampling", "500", "--sampling_strategy", "freq", "--giou_verb_label", "--pseudo_verb",
             "--triplet_filtering", "--tokenizer_dir", str(root / "roberta"),
             "--pretrained", str(root / "pretrained.pth"), "--batch_size", str(BATCH)]
    return flags, initial, tree
