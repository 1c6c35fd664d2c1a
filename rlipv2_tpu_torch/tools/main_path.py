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
`main_path_rlipv1_model` gives the RLIPv1 family at the R50 preset's
widths (RLIP-ParSeD v1, RLIP-ParSe, RLIP-ParSe v2, and RLIPParSeV1Joint
and RLIP-MDETR, whose pooled label features `pooled_text_encoder`
computes), `main_path_zoo_model` the closed-vocabulary zoo and
ParSe-DAB-DETR at the same widths, `main_path_warm_start_model`
RLIP-ParSeDA, RLIP-ParSeD or RLIP-ParSe v1 warm-started from a detector's
state dict through its converter, and `main_path_detector_model` the COCO
DETR detector;
`chip_smoke.py` and `tools/profile_finetune.py` run the command line's
fine-tunes (R50 and Swin-L on HICO-DET, R50 on V-COCO and on Open Images
v6 SGG, RLIP-ParSeD R50 on HICO-DET, and with --variant RLIP-ParSeD v1,
RLIP-ParSe and RLIP-ParSe v2; R50 on HICO-DET with RLIP-ParSeDA's loss and
head options) on the trees that `main_finetune_tree` writes
(`finetune_flags` runs another script of the same preset on a tree), and its pre-trainings (R50 on VG and on VG + COCO, Swin-L on VG +
COCO + O365) and the R-Tagger's training (RLIP-ParSeD R50 on VG) on the
tree that `main_pretrain_tree` writes.
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
PRETRAIN_IMAGES_O365 = (200, 200, 200)
# the command-line scripts the tools run on these trees: their presets and
# flags (the data's paths aside)
FINETUNE_SCRIPTS = {  # name: (preset, dataset, flags)
    "finetune_hico": ("rlip_parseda_v2_r50", "hico", [  # scripts/finetune_hico_parseda_r50.sh
        "--giou_verb_label", "--pseudo_verb", "--negative_text_sampling", "500", "--sampling_strategy", "freq",
        "--use_nms_filter"]),
    "finetune_hico_swinL": ("rlip_parseda_v2_swin_large", "hico", [  # scripts/finetune_hico_swinL.sh
        "--epochs", "20", "--lr_drop", "15", "--giou_verb_label", "--ema", "--remat_encoder"]),
    "finetune_vcoco": ("rlip_parseda_v2_r50", "vcoco", [  # scripts/finetune_vcoco_parseda_r50.sh
        "--negative_text_sampling", "500", "--sampling_strategy", "freq", "--epochs", "60", "--lr_drop", "40",
        "--use_nms_filter"]),
    "finetune_oisgg": ("rlip_parseda_v2_r50", "oi_sgg", [  # scripts/finetune_oisgg_parseda_r50.sh
        "--negative_text_sampling", "500", "--sampling_strategy", "freq", "--epochs", "40", "--lr_drop", "30"]),
    "finetune_hico_parsed": ("rlip_parsed_v2_r50", "hico", [  # scripts/finetune_hico_parsed_r50.sh
        "--negative_text_sampling", "500", "--sampling_strategy", "freq", "--epochs", "60", "--lr_drop", "40",
        "--use_nms_filter"]),
}
# the RLIPv1 variants: no script of scripts/ sets them; each is the JAX CLI's
# command for scripts/finetune_hico_parsed_r50.sh with --variant
FINETUNE_SCRIPTS.update({
    f"finetune_hico_{variant}": (FINETUNE_SCRIPTS["finetune_hico_parsed"][0], "hico",
                                 FINETUNE_SCRIPTS["finetune_hico_parsed"][2] + ["--variant", variant])
    for variant in ("rlip_parsed", "rlip_parse", "rlip_parse_v2")
})
# RLIP-ParSeDA's loss and head options: no script of scripts/ sets them;
# each is the JAX CLI's command for scripts/finetune_hico_parseda_r50.sh with
# them ("_heads": the curing and recon heads, the exponential aux decay and
# the focal / asymmetric BCE forms; "_matching": the same heads with the
# contrastive losses)
HEAD_FLAGS = ["--verb_curing", "--masked_entity_modeling", "--exponential_loss"]
FINETUNE_SCRIPTS.update({
    "finetune_hico_heads": ("rlip_parseda_v2_r50", "hico", FINETUNE_SCRIPTS["finetune_hico"][2] + HEAD_FLAGS + [
        "--obj_loss_type", "focal", "--verb_loss_type", "asymmetric_bce"]),
    "finetune_hico_matching": ("rlip_parseda_v2_r50", "hico", FINETUNE_SCRIPTS["finetune_hico"][2] + HEAD_FLAGS + [
        "--obj_loss_type", "cross_modal_matching", "--verb_loss_type", "cross_modal_matching"]),
})
PRETRAIN_SCRIPTS = {  # name: (preset, datasets, flags)
    "pretrain_mixed_vgcoco": ("rlip_parseda_v2_r50", 2, [  # scripts/pretrain_mixed_vgcoco_parseda_r50.sh
        "--iterative_paradigm", "0,1", "--relation_threshold", "0.2", "--pair_overlap",
        "--negative_text_sampling", "500", "--sampling_strategy", "freq", "--giou_verb_label", "--pseudo_verb",
        "--triplet_filtering"]),
    "vg": ("rlip_parseda_v2_r50", 1, [  # scripts/pretrain_vg_parseda_r50.sh
        "--negative_text_sampling", "500", "--sampling_strategy", "freq", "--giou_verb_label", "--pseudo_verb",
        "--triplet_filtering"]),
    "pretrain_mixed_vgcocoo365_swinL": ("rlip_parseda_v2_swin_large", 3, [  # its script of that name
        "--iterative_paradigm", "0,1,2", "--relation_threshold", "0.2", "--pair_overlap",
        "--negative_text_sampling", "500", "--sampling_strategy", "freq", "--giou_verb_label", "--pseudo_verb",
        "--pseudo_verb_mode", "online", "--triplet_filtering", "--remat_encoder", "--ema",
        "--epochs", "20", "--lr_drop", "15"]),
    "tagger_train_vg": ("rlip_parsed_v2_r50", 1, [  # scripts/tagger_train_vg.sh, on the VG file
        "--dataset_file", "vg", "--verb_tagger", "--label_noise_scale", "0.3", "--box_noise_scale", "0.6",
        "--verb_loss_type", "bce", "--epochs", "20", "--lr_drop", "15"]),
}
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


def _seeded_model(preset=rlip_parseda_v2_r50, msda_impl: str = "auto", int8_dense: bool = False,
                  remat: bool = False, variant: str | None = None):
    """(cfg, model): `preset` at HICO's slots with RoBERTa-base, as
    `variant` (default the preset's) builds it, with seeded weights."""
    from rlipv2_tpu_torch.models.factory import build_model

    base = preset()
    cfg = dataclasses.replace(
        base,
        variant=variant or base.variant,
        text_encoder=TextEncoderConfig(num_layers=12),
        max_obj_texts=81,
        max_verb_texts=117,
        backbone=dataclasses.replace(base.backbone, int8_dense=int8_dense, use_checkpoint=remat),
        transformer=dataclasses.replace(base.transformer, msda_impl=msda_impl, int8_dense=int8_dense,
                                        remat_encoder=remat),
    )
    model = build_model(cfg)
    model.load_state_dict(random_state_dict(model), strict=True)
    return model.cfg, model


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


def main_path_rlipv1_model(device="cuda", variant: str = "rlip_parse"):
    """(cfg, model): the RLIPv1 `variant` (rlip_parsed, rlip_parse,
    rlip_parse_v2, rlip_parse_v1_joint or rlip_mdetr; `models/factory.py`)
    at the R50 preset's widths (hidden 256, 6 encoder and 3 decoder layers,
    200 queries, bf16) with HICO's slots, seeded weights, in eval mode.
    RLIP-ParSeD v1 launches the MSDA forward 12 times a forward; the dense
    ParSe models none."""
    cfg, model = _seeded_model(variant=variant)
    return cfg, model.to(device).eval()


def main_path_zoo_model(device="cuda", variant: str = "qpic"):
    """(cfg, model): the closed-vocabulary `variant` (`models/closed_vocab.py`,
    or `parse_dab_detr`, `models/dab_detr.py`) at the R50 preset's widths (hidden 256, 6 encoder and 3 decoder
    layers, 200 queries, ResNet-50, bf16) with its head columns (96 object,
    160 verb), seeded weights loaded strictly, on `device`, in eval mode.
    QAHOI and QAHOI two-stage launch the MSDA forward 6 + 3 times a
    forward, SepDDETRHOIv3 and ParSe-DAB-DDETR 6 + 3 + 3, the dense models
    (ParSe-DAB-DETR among them) none."""
    from rlipv2_tpu_torch.models.factory import build_model

    cfg = dataclasses.replace(rlip_parseda_v2_r50(), variant=variant)
    model = build_model(cfg)
    model.load_state_dict(random_state_dict(model), strict=True)
    return cfg, model.to(device).eval()


def main_path_warm_start_model(detector: dict, device="cuda", variant: str = "rlip_parseda_v2"):
    """(cfg, model, partial, left): `variant` (rlip_parseda_v2, rlip_parsed_v2
    or rlip_parse_v1_joint) at the R50 preset's widths with HICO's slots and
    seeded weights, warm-started from `detector`, a detector's state dict in
    the reference key space its converter reads
    (`engine/convert.py::DETECTOR_CONVERTERS`: DAB-Deformable-DETR,
    Deformable-DETR, DETR): `partial` is the converter's output, loaded over
    the seeded init by `load_partial_state_dict`, and `left` the model's
    keys that kept the init (the text side). On `device`, in eval mode."""
    from rlipv2_tpu_torch.engine.convert import DETECTOR_CONVERTERS, load_partial_state_dict

    cfg, model = _seeded_model(variant=variant)
    partial = DETECTOR_CONVERTERS[variant](detector, cfg)
    left = load_partial_state_dict(model, partial)
    return cfg, model.to(device).eval(), partial, left


def main_path_detector_model(device="cuda", num_classes: int = 91):
    """(cfg, model): `models/detection.py::DETRDetector` with `num_classes`
    COCO classes at the R50 preset's widths (hidden 256, 6 encoder and 3
    decoder layers, 200 queries, ResNet-50, bf16), seeded weights loaded
    strictly, on `device`, in eval mode."""
    from rlipv2_tpu_torch.models.detection import DETRDetector

    cfg = rlip_parseda_v2_r50()
    model = DETRDetector(cfg, num_classes)
    model.load_state_dict(random_state_dict(model), strict=True)
    return cfg, model.to(device).eval()


def pooled_text_encoder(cfg, device="cuda"):
    """`encode_text(ids, mask) -> (N, 768)` pooled label features of a
    RoBERTa of `cfg.text_encoder` with weights drawn from SEED, bf16
    autocast as the config says: the cached text of a model without a
    text encoder of its own (RLIPParSeV1Joint)."""
    from rlipv2_tpu_torch.models.roberta import RobertaModel

    encoder = RobertaModel(cfg.text_encoder)
    encoder.load_state_dict(random_state_dict(encoder), strict=True)
    encoder = encoder.to(device).eval()

    @torch.no_grad()
    def encode_text(ids, mask):
        with torch.autocast(device_type=ids.device.type, dtype=torch.bfloat16, enabled=cfg.dtype == "bfloat16"):
            return encoder(ids, mask)[1].float()

    return encode_text


def with_swin_checkpoint(cfg, use_checkpoint: bool = True):
    """`cfg` with the Swin backbone's blocks rematerialized (or not): the
    config-only `backbone.use_checkpoint`, which no command-line flag sets."""
    return dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, use_checkpoint=use_checkpoint))


def main_train_model(device="cuda", swin: bool = False):
    """(cfg, model): the main path's model, R50 or with `swin` the Swin-L
    one (DropPath 0.2, its blocks and the encoder's layers
    rematerialized), in train mode (dropout on) with the reference's frozen
    parameters (ResNet stem and layer1) set."""
    from rlipv2_tpu_torch.engine.optim import freeze_parameters

    cfg, model = _seeded_model(rlip_parseda_v2_swin, remat=True) if swin else _seeded_model()
    freeze_parameters(model)
    return cfg, model.to(device).train()


def main_train_step(device="cuda", swin: bool = False):
    """(cfg, model, train_step): `main_train_model(device, swin)` with the
    default LossConfig and TrainConfig: SetCriterionHOI, the three-group
    AdamW and its schedule, and `engine/train.py::make_train_step`."""
    from rlipv2_tpu_torch.config import LossConfig, TrainConfig
    from rlipv2_tpu_torch.engine.optim import build_optimizer
    from rlipv2_tpu_torch.engine.train import make_train_step
    from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI

    cfg, model = main_train_model(device, swin)
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


def main_finetune_tree(root, n_train: int, n_val: int, script: str = "finetune_hico", shared=None):
    """Write, under `root`, what the fine-tune `script` (FINETUNE_SCRIPTS:
    scripts/finetune_hico_parseda_r50.sh, scripts/finetune_hico_swinL.sh for
    "finetune_hico_swinL", scripts/finetune_{vcoco,oisgg}_parseda_r50.sh for
    "finetune_vcoco" and "finetune_oisgg", scripts/finetune_hico_parsed_r50.sh
    for "finetune_hico_parsed", and with --variant for
    "finetune_hico_rlip_parsed", "_rlip_parse" and "_rlip_parse_v2") reads: the dataset's tree over
    the JPEG fixture (`tools/hico_tree.py`, `tools/vcoco_oisgg_tree.py`; the
    train split takes the landscape files, so its batches land in phase
    7's 832x1344 bucket unless a crop turns one, the val split all six), a
    byte-level tokenizer learned from the label texts, and pretrained.pth:
    the main path's seeded weights for the script's preset and variant in
    the model's layout (`write_pretrained`).

    `shared`, a directory that outlives the runs, holds each part once
    under a name that says what it is: the dataset's tree by its split
    sizes, the tokenizer by the dataset, pretrained.pth by preset and
    variant. A part found there is linked into `root`, one not found is
    written there first.

    Returns (flags, initial): the script's flags for `cli.main` with these
    paths (no --output_dir or --max_steps), and the state dict the run
    starts from (`write_pretrained`), None where pretrained.pth was
    already in `shared`."""
    from pathlib import Path

    from rlipv2_tpu_torch.data.text import NO_OBJ_TEXT
    from rlipv2_tpu_torch.data.vocab import HICO_OBJECT_NAMES, HICO_VERB_NAMES
    from rlipv2_tpu_torch.tools.hico_fixture import FIXTURE_DIR, FIXTURES
    from rlipv2_tpu_torch.tools.hico_tree import write_hico_tree, write_label_tokenizer
    from rlipv2_tpu_torch.tools.vcoco_oisgg_tree import write_oisgg_tree, write_vcoco_tree

    preset, dataset, script_flags = FINETUNE_SCRIPTS[script]
    root = Path(root)
    variant = script_flags[script_flags.index("--variant") + 1] if "--variant" in script_flags else None

    def part(name: str, shared_name: str, write):
        """write(path) at root/name, or at shared/shared_name linked there;
        None where the shared one was there already."""
        if shared is None:
            return write(root / name)
        path = Path(shared) / shared_name
        out = None if path.exists() else write(path)
        (root / name).symlink_to(path)
        return out

    def tree(path):
        landscape = [(FIXTURE_DIR / f.name, f.height, f.width) for f in FIXTURES if f.width > f.height]
        every = [(FIXTURE_DIR / f.name, f.height, f.width) for f in FIXTURES]
        splits = ((landscape * n_train)[:n_train], (every * n_val)[:n_val])
        if dataset == "vcoco":
            return write_vcoco_tree(path, *splits)
        if dataset == "oi_sgg":
            return write_oisgg_tree(path, *splits)
        write_hico_tree(path, *splits)
        return HICO_OBJECT_NAMES, HICO_VERB_NAMES

    root.mkdir(parents=True, exist_ok=True)
    labels = part(dataset, f"{dataset}_{n_train}_{n_val}", tree)
    part("roberta", f"roberta_{dataset}", lambda path: write_label_tokenizer(
        path, list(labels[0]) + [NO_OBJ_TEXT] + list(labels[1]) + ["."]))
    initial = part("pretrained.pth", f"pretrained_{preset}_{variant or 'preset'}.pth",
                   lambda path: write_pretrained(path, preset, variant))
    return finetune_flags(root, script), initial


def finetune_flags(root, script: str) -> list:
    """The flags for `cli.main` of the fine-tune `script` on the tree that
    `main_finetune_tree` wrote under `root`, for it or for another script
    of the same preset, dataset and variant (no --output_dir or
    --max_steps)."""
    from pathlib import Path

    preset, dataset, script_flags = FINETUNE_SCRIPTS[script]
    root = Path(root)
    return ["--preset", preset, "--dataset_file", dataset, "--hoi_path", str(root / dataset),
            "--pretrained", str(root / "pretrained.pth"), *script_flags,
            "--tokenizer_dir", str(root / "roberta"), "--batch_size", str(BATCH)]


def write_pretrained(path, preset: str = "rlip_parseda_v2_r50", variant: str | None = None) -> dict:
    """Write `path`, the main path's seeded weights for `preset` as
    `variant` (default the preset's) builds it, in that model's layout, and
    return the state dict a run starts from. The query embeddings that a
    load fits (`engine/convert.py::fit_query_embeddings`: the DAB and
    RLIP-ParSeD ones) are written with PRETRAINED_QUERIES rows and tiled at
    load; the dense ParSe models' at the model's count, the only one they
    load at. Each box head shared by two names holds the value loaded last.
    The model is without the R-Tagger's parameters, which a tagger run
    initialises."""
    from rlipv2_tpu_torch.config import PRESETS
    from rlipv2_tpu_torch.engine.convert import QUERY_EMBEDDINGS, fit_query_embeddings
    from rlipv2_tpu_torch.models.factory import build_model

    cfg = PRESETS[preset]()
    model = build_model(dataclasses.replace(cfg, variant=variant or cfg.variant))
    seeded = random_state_dict(model)
    fitted = "refpoint_embed.weight" in seeded
    pretrained = {k: (v[:PRETRAINED_QUERIES] if fitted and k in QUERY_EMBEDDINGS else v) for k, v in seeded.items()}
    torch.save({"model": pretrained}, path)
    model.load_state_dict(fit_query_embeddings(pretrained, cfg.num_queries), strict=True)
    return model.state_dict()


def main_pretrain_tree(root, script: str = "pretrain_mixed_vgcoco"):
    """Write, under `root`, what the pre-training `script` (PRETRAIN_SCRIPTS:
    scripts/pretrain_mixed_vgcoco_parseda_r50.sh, scripts/pretrain_vg_parseda_r50.sh
    for "vg", scripts/pretrain_mixed_vgcocoo365_swinL.sh, scripts/tagger_train_vg.sh
    for "tagger_train_vg", whose `--dataset_file vg` overrides) reads: a
    VG-format tree (`tools/vg_tree.py`: VG, pseudo-labelled COCO and, for
    the O365 script, pseudo-labelled O365 annotations of PRETRAIN_IMAGES or
    PRETRAIN_IMAGES_O365 images over copies of the JPEG fixture's six
    files; 1200 object names and 320 predicates), a byte-level tokenizer
    learned from its label texts, and pretrained.pth (`write_pretrained`
    for the script's preset).

    Returns (flags, initial, tree): the script's flags for `cli.main` with
    these paths (no --output_dir or --max_steps), the state dict the run
    starts from, and `write_vg_tree`'s paths."""
    from pathlib import Path

    from rlipv2_tpu_torch.data.text import NO_OBJ_TEXT
    from rlipv2_tpu_torch.tools.hico_fixture import FIXTURE_DIR, FIXTURES
    from rlipv2_tpu_torch.tools.hico_tree import write_label_tokenizer
    from rlipv2_tpu_torch.tools.vg_tree import write_vg_tree

    preset, n_datasets, script_flags = PRETRAIN_SCRIPTS[script]
    root = Path(root)
    tree = write_vg_tree(root / "tree", [(FIXTURE_DIR / f.name, f.height, f.width) for f in FIXTURES],
                         n_images=PRETRAIN_IMAGES_O365 if n_datasets == 3 else PRETRAIN_IMAGES, seed=SEED)
    write_label_tokenizer(root / "roberta", tree["texts"] + [NO_OBJ_TEXT, "."])
    initial = write_pretrained(root / "pretrained.pth", preset)
    annos = [tree["vg_anno"], tree["coco_anno"], tree["o365_anno"]][:n_datasets]
    folders = [("--vg_folder", "vg_folder"), ("--coco2017_folder", "coco2017_folder"),
               ("--o365_folder", "o365_folder")][:n_datasets]
    data = ["--pretrain_anno", ",".join(str(a) for a in annos)]
    for flag, key in folders:
        data += [flag, str(tree[key])]
    flags = ["--preset", preset, "--dataset_file", "pretrain", *data, *script_flags,
             "--tokenizer_dir", str(root / "roberta"), "--pretrained", str(root / "pretrained.pth"),
             "--batch_size", str(BATCH)]
    return flags, initial, tree
