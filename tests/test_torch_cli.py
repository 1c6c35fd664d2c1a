"""The port's command line, `rlipv2-torch`: its parser against the JAX
CLI's, every experiment script through it, the paths that are not ported
raising with their ROADMAP item, and CPU runs of `cli.main` on a tiny
config: over a HICO tree of PNGs, two steps of the fine-tune with RPL,
pseudo verbs, negative texts, the triplet NMS and in-graph text training,
a checkpoint, a resume, and an evaluation of the checkpoint; over a
VG-format tree of PNGs, the mixed VG + COCO pre-training (two accumulated
micro-batches a step, the triplet filter, 334 + 167 text slots) with a
checkpoint and a resume, and `--dataset_file vg`; over V-COCO and OI-SGG
trees of PNGs, their fine-tunes with a checkpoint, a resume that equals
the straight run bit for bit, and their evaluations; RLIP-ParSeDA's loss
and head options (the curing and recon heads, the exponential decay, the
contrastive losses) from a pretrained.pth without the heads, a resume
equal to the straight run, and `--eval --eval_uniformity`."""

import dataclasses
import json
import pathlib
import random
import re

import numpy as np
import pytest
import torch

from rlipv2_tpu.cli import get_parser as jax_get_parser
from rlipv2_tpu_torch import cli
from rlipv2_tpu_torch.config import (BackboneConfig, FusionConfig, ModelConfig, TextEncoderConfig,
                                     TransformerConfig)
from rlipv2_tpu_torch.data.image_io import encode_png
from rlipv2_tpu_torch.data.text import NO_OBJ_TEXT
from rlipv2_tpu_torch.data.transforms import HOITransform
from rlipv2_tpu_torch.data.vocab import HICO_OBJECT_NAMES, HICO_VERB_NAMES
from rlipv2_tpu_torch.engine.convert import load_reference_checkpoint
from rlipv2_tpu_torch.engine.optim import param_group_name
from rlipv2_tpu_torch.losses.matcher import triplet_filter
from rlipv2_tpu_torch.models.parsed import RLIPParSeD
from rlipv2_tpu_torch.models.parseda import RLIPParSeDA
from rlipv2_tpu_torch.tools import generate_relations
from rlipv2_tpu_torch.tools.coco_tree import write_coco_tree
from rlipv2_tpu_torch.tools.hico_fixture import FIXTURE_DIR, FIXTURES
from rlipv2_tpu_torch.tools.hico_tree import write_hico_tree, write_label_tokenizer
from rlipv2_tpu_torch.tools.main_path import random_state_dict
from rlipv2_tpu_torch.tools.vcoco_oisgg_tree import OI_OBJECTS, OI_RELATIONS, write_oisgg_tree, write_vcoco_tree
from rlipv2_tpu_torch.tools.vg_tree import write_vg_tree

torch.set_num_threads(2)  # the test workers share the host's cores

REPO = pathlib.Path(__file__).resolve().parents[1]
# the scripts that the port runs: the HICO-DET fine-tunes, few-shot and
# zero-shot runs and evaluations and the ParSeDA pre-trainings, with the
# R50 and the Swin backbones; every other script raises
PORTED_SCRIPTS = {
    "finetune_hico_parseda_r50.sh", "finetune_hico_r50.sh", "fewshot_hico_1pct.sh",
    "fewshot_hico_1pct_parseda_r50.sh", "fewshot_hico_10pct_parseda_r50.sh", "zeroshot_ucrf_parseda_r50.sh",
    "zeroshot_ucnf_parseda_r50.sh", "zeroshot_nf_parseda_r50.sh", "zeroshot_nf_eval.sh",
    "zeroshot_nf_parseda_swinL.sh", "zeroshot_nf_parseda_swinT.sh",
    "pretrain_vg_parseda_r50.sh", "pretrain_mixed_vgcoco_parseda_r50.sh", "pretrain_mixed_vgcocoo365_parseda_r50.sh",
    # the Swin training scripts
    "fewshot_hico_1pct_parseda_swinL.sh", "fewshot_hico_1pct_parseda_swinT.sh",
    "fewshot_hico_10pct_parseda_swinL.sh", "fewshot_hico_10pct_parseda_swinT.sh",
    "finetune_hico_parseda_swinL.sh", "finetune_hico_parseda_swinT.sh", "finetune_hico_swinL.sh",
    "zeroshot_ucrf_parseda_swinL.sh", "zeroshot_ucrf_parseda_swinT.sh",
    "zeroshot_ucnf_parseda_swinL.sh", "zeroshot_ucnf_parseda_swinT.sh",
    "pretrain_vg_parseda_swinL.sh", "pretrain_vg_parseda_swinT.sh",
    "pretrain_mixed_vgcoco_parseda_swinL.sh", "pretrain_mixed_vgcoco_parseda_swinT.sh",
    "pretrain_mixed_vgcocoo365_parseda_swinL.sh", "pretrain_mixed_vgcocoo365_parseda_swinT.sh",
    "pretrain_mixed_vgcocoo365_swinL.sh",
    # the V-COCO and Open Images v6 SGG fine-tunes
    "finetune_vcoco_parseda_r50.sh", "finetune_vcoco_parseda_swinL.sh", "finetune_vcoco_parseda_swinT.sh",
    "finetune_oisgg_parseda_r50.sh", "finetune_oisgg_parseda_swinL.sh", "finetune_oisgg_parseda_swinT.sh",
    # RLIP-ParSeD and the R-Tagger's training (its generation runs
    # tools/generate_relations.py, not main.py)
    "finetune_hico_parsed_r50.sh", "pretrain_vg_parsed_r50.sh", "tagger_train_vg.sh",
}
# HICO's slot texts: 80 objects and the no-object text, 117 verbs
CFG = ModelConfig(
    backbone=BackboneConfig(name="resnet_test", num_outputs=3),
    text_encoder=TextEncoderConfig(vocab_size=512, hidden_size=32, num_layers=1, num_heads=4,
                                   intermediate_size=64, max_position_embeddings=64),
    transformer=TransformerConfig(hidden_dim=64, nheads=4, enc_layers=2, dec_layers=2, dim_feedforward=64,
                                  fusion=FusionConfig(embed_dim=64, num_heads=4)),
    num_queries=8, max_obj_texts=81, max_verb_texts=117, dtype="float32")


def script_argv(sh: pathlib.Path, command: str = "python main.py") -> list:
    """The flags a script passes to `command`, its $VARIABLES as
    paths (as tests/test_cli.py reads them)."""
    text = sh.read_text()
    body = text[text.index(command):]
    argv = []
    for tok in re.findall(r'--[\w]+(?:\s+"?\$?\{?[\w./,-]*\}?"?)?', body):
        parts = tok.replace('"', "").split()
        argv.append(parts[0])
        if len(parts) > 1:
            argv.append("/dev/null" if parts[1].startswith("$") else parts[1])
    return argv


def test_parser_has_every_jax_flag_with_its_default():
    ours = {a.dest: a for a in cli.get_parser()._actions}
    theirs = {a.dest: a for a in jax_get_parser()._actions}
    # the port's own: the run's device, and torchrun's process-group backend
    assert set(ours) - set(theirs) == {"device", "dist_backend"} and set(theirs) <= set(ours)
    for dest, a in theirs.items():
        b = ours[dest]
        assert b.option_strings == a.option_strings, dest
        fields = ("default", "type", "choices", "nargs", "const")
        assert [getattr(b, f) for f in fields] == [getattr(a, f) for f in fields], dest
    assert ours["device"].default == "cuda"


def test_every_script_parses_and_runs_or_names_its_roadmap_item():
    """Every script of scripts/ runs through the port: the main.py ones
    pass `check_ported`, and the R-Tagger's generation parses with
    `tools/generate_relations.py`'s parser."""
    scripts = sorted((REPO / "scripts").glob("*.sh"))
    main_py = [sh for sh in scripts if "python main.py" in sh.read_text()]
    assert {sh.name for sh in main_py} == PORTED_SCRIPTS
    for sh in main_py:
        cli.check_ported(cli.get_parser().parse_args(script_argv(sh)))
    others = [sh for sh in scripts if sh not in main_py]
    assert [sh.name for sh in others] == ["tagger_generate_coco.sh"]
    args = generate_relations.get_parser().parse_args(script_argv(others[0], "python -m rlipv2_tpu.tools.generate_relations"))
    assert args.relation_threshold == 0.2 and args.device == "cuda"


@pytest.mark.parametrize("argv,variant,error,match", [
    # a variant of the JAX factory that no flag offers, set on the parsed args
    ([], "qpic", NotImplementedError, "item 20"),
    # the JAX CLI's --variant offers neither (rlipv2_tpu/cli.py:95-101)
    ([], "parse_dab_detr", NotImplementedError, "JAX CLI's --variant offers neither"),
    ([], "rlip_mdetr", NotImplementedError, "JAX CLI's --variant offers neither"),
    (["--variant", "rlip_parse", "--verb_tagger", "--dataset_file", "vg"], None, ValueError, "no R-Tagger"),
    # a model axis that does not divide the world (two ranks here); the JAX
    # CLI falls back to pure data parallelism without a word
    (["--fsdp", "3"], None, ValueError, "--fsdp 3 .* divide the world size 2"),
    # the analysis is an evaluation (the JAX CLI ignores the flag when it trains)
    (["--eval_uniformity"], None, ValueError, "with --eval"),
    # the JAX classes of these variants never call curing or recon heads
    (["--preset", "rlip_parsed_v2_r50", "--verb_curing"], None, ValueError, "JAX RLIPParSeD "),
    (["--preset", "rlip_parsed_v2_r50", "--variant", "rlip_parse", "--masked_entity_modeling"], None, ValueError,
     "JAX RLIPParSe "),
])
def test_unported_paths_raise_with_their_item(argv, variant, error, match):
    """Paths not ported raise NotImplementedError naming their ROADMAP item;
    options that would do nothing raise ValueError: the R-Tagger on a ParSe
    variant (it has none), the curing and recon heads on the variants whose
    JAX classes never call them, the uniformity analysis without --eval,
    a --fsdp that does not divide the world (of two ranks)."""
    args = cli.get_parser().parse_args(argv)
    if variant:
        args.variant = variant
    with pytest.raises(error, match=match):
        cli.check_ported(args, world=2)


@pytest.mark.parametrize("argv,model,loss", [
    (["--verb_curing", "--exponential_loss", "--exponential_hyper", "0.5"], dict(verb_curing=True),
     dict(exponential_loss=True, exponential_hyper=0.5)),
    (["--masked_entity_modeling", "--verb_loss_type", "cross_modal_matching", "--obj_loss_type", "focal"],
     dict(masked_entity_modeling=True, subject_class=True),
     dict(verb_loss_type="cross_modal_matching", obj_loss_type="focal")),
    (["--eval", "--eval_uniformity", "--verb_curing"], dict(verb_curing=True), {}),
])
def test_loss_and_head_options_pass_check_ported(argv, model, loss):
    """RLIP-ParSeDA's loss and head options pass `check_ported` and reach
    the model config (--masked_entity_modeling turns the subject head on,
    as in the JAX CLI) and the criterion."""
    args = cli.get_parser().parse_args(argv + ["--device", "cpu"])
    cli.check_ported(args)
    cfg = cli.model_config(args)
    assert all(getattr(cfg, k) == v for k, v in model.items())
    lcfg = cli.loss_config(args)
    assert all(getattr(lcfg, k) == v for k, v in loss.items())


@pytest.mark.parametrize("variant", ["rlip_parsed", "rlip_parse", "rlip_parse_v2"])
def test_rlipv1_variants_pass_check_ported(variant):
    args = cli.get_parser().parse_args(["--preset", "rlip_parsed_v2_r50", "--variant", variant])
    cli.check_ported(args)
    assert cli.model_config(args).variant == variant


@pytest.mark.parametrize("argv,slots", [
    (["--dataset_file", "vcoco"], (96, 160)), (["--dataset_file", "oi_sgg"], (289, 160)),
    (["--preset", "rlip_parseda_v2_swin_l", "--dataset_file", "vcoco", "--eval"], (96, 160)),
])
def test_vcoco_and_oisgg_paths_pass_check_ported(argv, slots):
    """V-COCO and OI-SGG are ported, with the Swin presets too; at 500
    negative texts OI's 288 objects and 30 relations take 289 object slots
    and the preset's 160 verb slots, V-COCO's 80 and 29 the preset's."""
    args = cli.get_parser().parse_args(argv + ["--negative_text_sampling", "500"])
    cli.check_ported(args)
    vocab = {"vcoco": (len(HICO_OBJECT_NAMES), 29), "oi_sgg": (OI_OBJECTS, OI_RELATIONS)}[args.dataset_file]
    cfg = cli.text_slots(cli.model_config(args), args.negative_text_sampling, *vocab)
    assert (cfg.max_obj_texts, cfg.max_verb_texts) == slots


@pytest.mark.parametrize("argv,backbone,regime,remat", [
    (["--frozen_vision"], "resnet50", "frozen_vision", False),
    (["--unfrozen_params"], "resnet50", "unfrozen_params", False),
    (["--frozen_detection"], "resnet50", "frozen_detection", False),
    (["--frozen_detection", "--unfrozen_params", "--frozen_vision"], "resnet50", "frozen_vision", False),
    (["--unfrozen_params", "--frozen_detection"], "resnet50", "unfrozen_params", False),
    (["--remat_encoder"], "resnet50", None, True),
    (["--preset", "rlip_parseda_v2_swin_l", "--remat_encoder", "--ema"], "swin_large_384", None, True),
    (["--preset", "rlip_parseda_v2_swin_large", "--frozen_vision"], "swin_large_384", "frozen_vision", False),
    (["--preset", "rlip_parseda_v2_swin_t"], "swin_tiny", None, False),
    (["--preset", "rlip_parseda_v2_swin_l", "--dataset_file", "pretrain", "--iterative_paradigm", "0,1,2",
      "--remat_encoder"], "swin_large_384", None, True),
    (["--preset", "rlip_parseda_v2_swin_t", "--dataset_file", "vg"], "swin_tiny", None, False),
])
def test_swin_training_remat_and_freeze_flags_pass_check_ported(argv, backbone, regime, remat):
    """The Swin training step, --remat_encoder and the freeze flags are
    ported: they pass `check_ported`, the first freeze flag in the JAX
    CLI's order gives `freeze_regime`, and --remat_encoder sets
    `transformer.remat_encoder` (also on a given config)."""
    args = cli.get_parser().parse_args(argv)
    cli.check_ported(args)
    assert cli.freeze_regime(args) == regime
    cfg = cli.model_config(args)
    assert (cfg.backbone.name, cfg.transformer.remat_encoder) == (backbone, remat)
    assert cfg.backbone.drop_path_rate == (0.2 if backbone.startswith("swin") else 0.0)
    assert cli.model_config(args, CFG).transformer.remat_encoder == remat


@pytest.mark.parametrize("argv,k_steps", [
    (["--dataset_file", "vg"], 1), (["--dataset_file", "pretrain"], 1),
    (["--dataset_file", "pretrain", "--iterative_paradigm", "0,1"], 2),
    (["--dataset_file", "pretrain", "--iterative_paradigm", "0,1,2", "--triplet_filtering"], 3),
    (["--dataset_file", "vg", "--iterative_paradigm", "0,1"], 1),
])
def test_pretraining_paths_pass_check_ported(argv, k_steps):
    """Pre-training is ported; an optimizer step accumulates one
    micro-batch per paradigm entry, for --dataset_file pretrain only; it
    trains, so --eval is refused."""
    args = cli.get_parser().parse_args(argv)
    cli.check_ported(args)
    assert cli.accumulation_steps(args) == k_steps
    with pytest.raises(ValueError, match="no evaluation"):
        cli.check_ported(cli.get_parser().parse_args(argv + ["--eval"]))


def test_int8_options_are_for_evaluation():
    with pytest.raises(ValueError, match="inference only"):
        cli.check_ported(cli.get_parser().parse_args(["--int8_dense"]))
    cli.check_ported(cli.get_parser().parse_args(["--int8_dense", "--eval", "--msda_impl", "pallas_int8"]))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A HICO tree of PNGs, label tokenizer files and a reference-layout
    pretrained.pth with half the model's queries."""
    root = tmp_path_factory.mktemp("cli")
    rs = np.random.RandomState(0)
    images = []
    for i, (h, w) in enumerate([(48, 64), (64, 48), (40, 60), (56, 72)]):
        path = root / f"img{i}.png"
        path.write_bytes(encode_png(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)))
        images.append((path, h, w))
    write_hico_tree(root / "hico", images * 2, images[:2], seed=0)
    write_label_tokenizer(root / "tok", list(HICO_OBJECT_NAMES) + [NO_OBJ_TEXT] + list(HICO_VERB_NAMES) + ["."])
    sd = random_state_dict(RLIPParSeDA(CFG))
    torch.save({"model": {k: v[:4] if k.endswith(("tgt_embed.weight", "refpoint_embed.weight")) else v
                          for k, v in sd.items()}}, root / "pretrained.pth")
    return root


def small_transforms():
    return {"train": HOITransform(True, scales=[64, 80], max_size=100, rng=random.Random(0)),
            "val": HOITransform(False, val_size=64, max_size=100)}


def test_cli_trains_saves_resumes_and_evaluates_on_the_cpu(tree):
    common = ["--device", "cpu", "--hoi_path", str(tree / "hico"), "--tokenizer_dir", str(tree / "tok"),
              "--batch_size", "2", "--giou_verb_label", "--pseudo_verb", "--negative_text_sampling", "500",
              "--use_nms_filter", "--num_workers", "2", "--lr_drop", "1", "--print_freq", "10",
              "--output_dir", str(tree / "out")]
    first = cli.main(common + ["--pretrained", str(tree / "pretrained.pth"), "--epochs", "1", "--max_steps", "2"],
                     model_cfg=CFG, transforms=small_transforms())
    assert [p.name for p in first.checkpoints] == ["checkpoint0000.pth"]
    assert first.state.lr_scheduler.last_epoch == 2 and first.resumed is None
    start = RLIPParSeDA(CFG)
    load_reference_checkpoint(start, tree / "pretrained.pth")
    start = dict(start.named_parameters())
    moved = {}
    for k, p in first.state.model.named_parameters():
        if p.requires_grad:
            moved[param_group_name(k)] = moved.get(param_group_name(k), False) or not torch.equal(p, start[k])
    assert moved == {"model": True, "backbone": True, "text_encoder": True}  # the text encoder trained in the graph
    saved_lr = {g["name"]: g["lr"] for g in first.state.optimizer.param_groups}
    assert saved_lr["model"] == pytest.approx(1e-5)  # dropped after the first epoch of 2 steps

    second = cli.main(common + ["--resume", str(tree / "out" / "ckpt"), "--epochs", "2", "--max_steps", "1"],
                      model_cfg=CFG, transforms=small_transforms())
    assert second.resumed == {"epoch": 0, "step": 2, "lr": saved_lr}
    assert second.state.lr_scheduler.last_epoch == 3 and second.state.epoch == 1
    log = [json.loads(x) for x in (tree / "out" / "log.txt").read_text().splitlines()]
    assert [x["epoch"] for x in log] == [0, 1]
    assert {"loss", "grad_norm", "host_wait_s"} <= set(log[0]["train"])

    evaluated = cli.main(common + ["--resume", str(tree / "out" / "ckpt" / "checkpoint0001.pth"), "--eval"],
                         model_cfg=CFG, transforms=small_transforms())
    assert evaluated.resumed == {"epoch": 1} and evaluated.checkpoints == []
    saved = torch.load(tree / "out" / "ckpt" / "checkpoint0001.pth", weights_only=True)["model"]
    got = evaluated.state.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in saved.items())
    assert set(evaluated.stats) == set(log[1]["test"]) and all(0.0 <= v <= 1.0 for v in evaluated.stats.values())


@pytest.fixture(scope="module")
def vg_tree(tree):
    """A VG, COCO and O365 tree over the HICO tree's PNGs (200 object
    names, 80 predicates) and a tokenizer learned from its labels."""
    images = [(tree / f"img{i}.png", h, w) for i, (h, w) in enumerate([(48, 64), (64, 48), (40, 60), (56, 72)])]
    out = write_vg_tree(tree / "vg", images, n_images=(6, 6, 2), n_object_names=200, n_predicates=80, seed=1)
    write_label_tokenizer(tree / "vgtok", out["texts"] + [NO_OBJ_TEXT, "."])
    return out


def pretrain_argv(tree, vg_tree, out):
    return ["--device", "cpu", "--dataset_file", "pretrain", "--pretrain_anno",
            f"{vg_tree['vg_anno']},{vg_tree['coco_anno']}", "--vg_folder", str(vg_tree["vg_folder"]),
            "--coco2017_folder", str(vg_tree["coco2017_folder"]), "--iterative_paradigm", "0,1",
            "--relation_threshold", "0.2", "--pair_overlap", "--negative_text_sampling", "500",
            "--sampling_strategy", "freq", "--giou_verb_label", "--pseudo_verb", "--triplet_filtering",
            "--tokenizer_dir", str(tree / "vgtok"), "--batch_size", "1", "--num_workers", "2", "--lr_drop", "1",
            "--print_freq", "10", "--output_dir", str(out)]


def test_cli_pretrains_saves_and_resumes_on_the_cpu(tree, vg_tree):
    """scripts/pretrain_mixed_vgcoco_parseda_r50.sh's flags: one step of
    a VG and a COCO micro-batch (of one image each: on the CPU every batch
    pads to a 512 x 512 bucket), each filtered, with 334 + 167 text slots;
    a checkpoint and a log line naming the slots; --resume for one more."""
    argv = pretrain_argv(tree, vg_tree, tree / "pre")
    before = dict(triplet_filter.counts)
    first = cli.main(argv + ["--pretrained", str(tree / "pretrained.pth"), "--epochs", "1", "--max_steps", "1"],
                     model_cfg=CFG, transforms=small_transforms())
    assert triplet_filter.counts["calls"] - before["calls"] == 2  # two micro-batches, one optimizer step
    assert 0 < triplet_filter.counts["kept"] - before["kept"] < triplet_filter.counts["valid"] - before["valid"]
    assert [p.name for p in first.checkpoints] == ["checkpoint0000.pth"] and first.stats is None
    assert first.state.lr_scheduler.last_epoch == 1
    cfg = first.state.model.cfg
    assert (cfg.max_obj_texts, cfg.max_verb_texts) == (334, 167)
    start = RLIPParSeDA(CFG)
    load_reference_checkpoint(start, tree / "pretrained.pth")
    start = dict(start.named_parameters())
    moved = {}
    for k, p in first.state.model.named_parameters():
        if p.requires_grad:
            moved[param_group_name(k)] = moved.get(param_group_name(k), False) or not torch.equal(p, start[k])
    assert moved == {"model": True, "backbone": True, "text_encoder": True}
    saved_lr = {g["name"]: g["lr"] for g in first.state.optimizer.param_groups}

    second = cli.main(argv + ["--resume", str(tree / "pre" / "ckpt"), "--epochs", "2", "--max_steps", "1"],
                      model_cfg=CFG, transforms=small_transforms())
    assert second.resumed == {"epoch": 0, "step": 1, "lr": saved_lr}
    assert second.state.lr_scheduler.last_epoch == 2 and second.state.epoch == 1
    log = [json.loads(x) for x in (tree / "pre" / "log.txt").read_text().splitlines()]
    assert [x["epoch"] for x in log] == [0, 1] and all("test" not in x for x in log)
    assert all(x["text_slots"] == {"obj": 334, "verb": 167} for x in log)
    assert {"loss", "grad_norm", "host_wait_s"} <= set(log[0]["train"])


def test_cli_trains_on_vg_on_the_cpu(tree, vg_tree):
    """--dataset_file vg (JAX run_vg without the tagger): one file of VG
    images, one micro-batch of one image a step; 300 negative texts take 201 object
    slots, above the config's 81, and 100 verb slots, which its 117 hold."""
    argv = ["--device", "cpu", "--dataset_file", "vg", "--pretrain_anno", str(vg_tree["vg_anno"]),
            "--vg_folder", str(vg_tree["vg_folder"]), "--negative_text_sampling", "300", "--triplet_filtering",
            "--tokenizer_dir", str(tree / "vgtok"), "--batch_size", "1", "--output_dir", str(tree / "vgrun"),
            "--pretrained", str(tree / "pretrained.pth"), "--epochs", "1", "--max_steps", "2"]
    before = triplet_filter.counts["calls"]
    run = cli.main(argv, model_cfg=CFG, transforms=small_transforms())
    assert triplet_filter.counts["calls"] - before == 2 and run.state.lr_scheduler.last_epoch == 2
    assert (run.state.model.cfg.max_obj_texts, run.state.model.cfg.max_verb_texts) == (201, 117)
    assert json.loads((tree / "vgrun" / "log.txt").read_text())["text_slots"] == {"obj": 201, "verb": 117}
    with pytest.raises(ValueError, match="--pretrain_anno"):
        cli.main(argv[:4] + argv[6:], model_cfg=CFG)
    mixed = pretrain_argv(tree, vg_tree, tree / "bad") + ["--pretrained", str(tree / "pretrained.pth")]
    with pytest.raises(ValueError, match="names a file beyond"):
        cli.main(mixed + ["--iterative_paradigm", "0,2"], model_cfg=CFG)


SWIN_CFG = dataclasses.replace(CFG, backbone=BackboneConfig(name="swin_test", num_outputs=3, drop_path_rate=0.2,
                                                             use_checkpoint=True))


def test_cli_trains_swin_with_remat_and_a_freeze_regime_on_the_cpu(tree, monkeypatch):
    """scripts/finetune_hico_swinL.sh's --remat_encoder --ema with
    --frozen_vision on a tiny Swin model (DropPath 0.2, its blocks
    rematerialized): one step, a checkpoint with the EMA, and a resume for
    one more. The Swin blocks and the encoder layers run checkpointed,
    DropPath draws from the step's generator, and frozen_vision freezes no
    Swin parameter."""
    from rlipv2_tpu_torch.models import deformable, swin

    sd = random_state_dict(RLIPParSeDA(SWIN_CFG))
    torch.save({"model": {k: v[:4] if k.endswith(("tgt_embed.weight", "refpoint_embed.weight")) else v
                          for k, v in sd.items()}}, tree / "swin_pretrained.pth")
    regions = {"swin": 0, "encoder": 0}
    for module, key in ((swin, "swin"), (deformable, "encoder")):
        def counted(*a, _fn=module.checkpoint, _key=key, **k):
            regions[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(module, "checkpoint", counted)
    argv = ["--device", "cpu", "--hoi_path", str(tree / "hico"), "--tokenizer_dir", str(tree / "tok"),
            "--batch_size", "2", "--giou_verb_label", "--remat_encoder", "--ema", "--frozen_vision",
            "--output_dir", str(tree / "swin"), "--max_steps", "1"]
    first = cli.main(argv + ["--pretrained", str(tree / "swin_pretrained.pth"), "--epochs", "1"],
                     model_cfg=SWIN_CFG, transforms=small_transforms())
    model = first.state.model
    assert model.cfg.transformer.remat_encoder and model.cfg.backbone.use_checkpoint
    assert all(p.requires_grad for p in model.parameters())  # the text encoder trains in the graph
    assert regions == {"swin": 4, "encoder": 2}  # one step: 4 blocks, 2 encoder layers
    saved = torch.load(first.checkpoints[0], weights_only=True)
    assert saved["ema"] is not None and set(saved["ema"]) == {k for k, _ in model.named_parameters()}
    second = cli.main(argv + ["--resume", str(tree / "swin" / "ckpt"), "--epochs", "2"],
                      model_cfg=SWIN_CFG, transforms=small_transforms())
    assert second.resumed["epoch"] == 0 and second.state.epoch == 1
    assert second.state.lr_scheduler.last_epoch == 2 and regions == {"swin": 8, "encoder": 4}


@pytest.fixture(scope="module")
def downstream_trees(tree):
    """V-COCO and OI-SGG trees over the HICO tree's PNGs, each with a
    tokenizer learned from its labels."""
    images = [(tree / f"img{i}.png", h, w) for i, (h, w) in enumerate([(48, 64), (64, 48), (40, 60), (56, 72)])]
    for name, write in (("vcoco", write_vcoco_tree), ("oi_sgg", write_oisgg_tree)):
        objects, verbs = write(tree / name, images * 2, images[:2], seed=2)
        write_label_tokenizer(tree / f"{name}_tok", list(objects) + [NO_OBJ_TEXT] + list(verbs) + ["."])
    return tree


def downstream_argv(tree, name, out):
    return ["--device", "cpu", "--dataset_file", name, "--hoi_path", str(tree / name),
            "--tokenizer_dir", str(tree / f"{name}_tok"), "--batch_size", "2", "--negative_text_sampling", "500",
            "--use_nms_filter", "--lr_drop", "1", "--print_freq", "10", "--output_dir", str(out)]


def test_cli_trains_vcoco_and_resumes_its_random_streams_on_the_cpu(downstream_trees, capsys):
    """scripts/finetune_vcoco_parseda_r50.sh's flags on a tiny model: two
    epochs of one step straight, and one epoch, a checkpoint and --resume
    for the second (no loader threads, so the augmentations draw in one
    order): the same weights bit for bit, since the checkpoint carries the
    random states; each epoch evaluates ("mAP_all", "mAP_thesis")."""
    tree = downstream_trees
    start = ["--pretrained", str(tree / "pretrained.pth"), "--max_steps", "1"]
    straight = cli.main(downstream_argv(tree, "vcoco", tree / "vc_straight") + start + ["--epochs", "2"],
                        model_cfg=CFG, transforms=small_transforms())
    first = cli.main(downstream_argv(tree, "vcoco", tree / "vc") + start + ["--epochs", "1"],
                     model_cfg=CFG, transforms=small_transforms())
    second = cli.main(downstream_argv(tree, "vcoco", tree / "vc") + ["--resume", str(tree / "vc" / "ckpt"),
                                                                       "--epochs", "2", "--max_steps", "1"],
                      model_cfg=CFG, transforms=small_transforms())
    assert second.resumed["epoch"] == 0 and second.state.rng_restored and second.state.epoch == 1
    assert "random states restored from the checkpoint" in capsys.readouterr().out
    got, want = second.state.model.state_dict(), straight.state.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    after_first = first.state.model.state_dict()
    assert any(not torch.equal(got[k], after_first[k]) for k in want)  # the second epoch trained
    log = [json.loads(x) for x in (tree / "vc" / "log.txt").read_text().splitlines()]
    assert [x["epoch"] for x in log] == [0, 1] and all(x["text_slots"] == {"obj": 81, "verb": 117} for x in log)
    assert {"mAP_all", "mAP_thesis"} <= set(log[1]["test"]) and set(log[1]["test"]) == set(straight.stats)
    assert all(0.0 <= v <= 1.0 for v in second.stats.values())


def test_cli_trains_oisgg_saves_resumes_and_evaluates_on_the_cpu(downstream_trees):
    """scripts/finetune_oisgg_parseda_r50.sh's flags: OI's 288 objects at
    500 negative texts take 289 object slots (above the tiny config's 81),
    its 30 relations the config's 117 verb slots; one step, a checkpoint
    and an evaluation at top-50 and top-100 with `score_wtd`, then --resume
    --eval of the checkpoint, which gives the same stats."""
    tree = downstream_trees
    argv = downstream_argv(tree, "oi_sgg", tree / "oi")
    first = cli.main(argv + ["--pretrained", str(tree / "pretrained.pth"), "--epochs", "1", "--max_steps", "1"],
                     model_cfg=CFG, transforms=small_transforms())
    assert (first.state.model.cfg.max_obj_texts, first.state.model.cfg.max_verb_texts) == (289, 117)
    assert first.state.lr_scheduler.last_epoch == 1 and [p.name for p in first.checkpoints] == ["checkpoint0000.pth"]
    assert {"mAP@50 (RelD)", "wmAP@100 (PhrD)", "score_wtd (mAP)", "score_wtd (wmAP)"} <= set(first.stats)
    log = [json.loads(x) for x in (tree / "oi" / "log.txt").read_text().splitlines()]
    assert [x["epoch"] for x in log] == [0] and log[0]["text_slots"] == {"obj": 289, "verb": 117}
    evaluated = cli.main(argv + ["--resume", str(tree / "oi" / "ckpt"), "--eval"], model_cfg=CFG,
                         transforms=small_transforms())
    assert evaluated.resumed["epoch"] == 0 and evaluated.state.rng_restored and evaluated.checkpoints == []
    assert evaluated.stats == first.stats and all(0.0 <= v <= 1.0 for v in evaluated.stats.values())


def test_cli_raises_on_jpeg_for_the_cpu_and_without_a_start(tree, tmp_path):
    jpeg = [(FIXTURE_DIR / FIXTURES[0].name, FIXTURES[0].height, FIXTURES[0].width)]
    write_hico_tree(tmp_path / "hico", jpeg, jpeg)
    argv = ["--device", "cpu", "--hoi_path", str(tmp_path / "hico"), "--tokenizer_dir", str(tree / "tok"),
            "--eval", "--output_dir", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="nvJPEG"):
        cli.main(argv + ["--pretrained", str(tree / "pretrained.pth")], model_cfg=CFG)
    with pytest.raises(NotImplementedError, match="--pretrained or --resume"):
        cli.main(argv, model_cfg=CFG)


def test_cli_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.build_everything(cli.get_parser().parse_args(["--hoi_path", "/nonexistent"]))


# ------------------------------------------------ RLIP-ParSeD and the R-Tagger

PARSED_CFG = dataclasses.replace(CFG, variant="rlip_parsed_v2")


@pytest.fixture(scope="module")
def parsed_pretrained(tree):
    """A reference-layout RLIP-ParSeD .pth (no tagger parameters) with half
    the model's queries."""
    sd = random_state_dict(RLIPParSeD(PARSED_CFG))
    path = tree / "parsed.pth"
    torch.save({"model": {k: v[:4] if k.endswith(("tgt_embed.weight", "refpoint_embed.weight", "query_embed.weight"))
                          else v for k, v in sd.items()}}, path)
    return path


def test_cli_runs_the_parsed_scripts_on_the_cpu(tree, vg_tree, parsed_pretrained):
    """scripts/finetune_hico_parsed_r50.sh (a step, a checkpoint and an
    evaluation) and scripts/pretrain_vg_parsed_r50.sh (a step) with their
    own flags on the tiny RLIP-ParSeD, warm-started from a RLIP-ParSeD .pth
    whose query_embed is tiled to the model's queries."""
    sh = REPO / "scripts" / "finetune_hico_parsed_r50.sh"
    run = cli.main(script_argv(sh) + [
        "--device", "cpu", "--hoi_path", str(tree / "hico"), "--tokenizer_dir", str(tree / "tok"),
        "--pretrained", str(parsed_pretrained), "--batch_size", "2", "--epochs", "1", "--max_steps", "1",
        "--output_dir", str(tree / "parsed_ft")], model_cfg=PARSED_CFG, transforms=small_transforms())
    assert type(run.state.model) is RLIPParSeD and run.state.lr_scheduler.last_epoch == 1
    assert set(run.stats) >= {"mAP"} and all(0.0 <= v <= 1.0 for v in run.stats.values())
    sh = REPO / "scripts" / "pretrain_vg_parsed_r50.sh"
    run = cli.main(script_argv(sh) + [
        "--device", "cpu", "--pretrain_anno", str(vg_tree["vg_anno"]), "--vg_folder", str(vg_tree["vg_folder"]),
        "--tokenizer_dir", str(tree / "vgtok"), "--pretrained", str(parsed_pretrained), "--batch_size", "1",
        "--epochs", "1", "--max_steps", "1", "--output_dir", str(tree / "parsed_pre")],
        model_cfg=PARSED_CFG, transforms=small_transforms())
    assert type(run.state.model) is RLIPParSeD and run.state.lr_scheduler.last_epoch == 1
    assert not run.state.model.tagger


def test_cli_trains_the_tagger_and_generates_relations_on_the_cpu(tree, vg_tree, parsed_pretrained, capsys):
    """scripts/tagger_train_vg.sh's flags: the tagger warm-started from a
    RLIP-ParSeD .pth (its own parameters initialised), a step and a
    checkpoint; then scripts/tagger_generate_coco.sh's flags through
    `generate_relations.main` on that checkpoint and a COCO tree: every
    confidence written reaches the threshold, and the file reads back as
    pseudo-labelled COCO for pre-training."""
    sh = REPO / "scripts" / "tagger_train_vg.sh"
    run = cli.main(script_argv(sh) + [
        "--device", "cpu", "--pretrain_anno", str(vg_tree["vg_anno"]), "--vg_folder", str(vg_tree["vg_folder"]),
        "--tokenizer_dir", str(tree / "vgtok"), "--pretrained", str(parsed_pretrained), "--batch_size", "2",
        "--epochs", "1", "--max_steps", "1", "--output_dir", str(tree / "tagger")],
        model_cfg=PARSED_CFG, transforms=small_transforms())
    model = run.state.model
    assert model.tagger and model.cfg.subject_class and run.state.lr_scheduler.last_epoch == 1
    assert "tagger tensors it lacks keep their initial values" in capsys.readouterr().out
    log = json.loads((tree / "tagger" / "log.txt").read_text())
    assert {"loss", "obj_ce", "verb_ce"} <= set(log["train"])

    images = [(tree / f"img{i}.png", h, w) for i, (h, w) in enumerate([(48, 64), (64, 48), (40, 60), (56, 72)])]
    coco = write_coco_tree(tree / "coco", images, n_images=6, n_predicates=10, seed=3)
    sh = REPO / "scripts" / "tagger_generate_coco.sh"
    out = tree / "pseudo.json"
    annos = generate_relations.main(script_argv(sh, "python -m rlipv2_tpu.tools.generate_relations") + [
        "--checkpoint", str(run.checkpoints[-1]), "--coco_img_folder", str(coco["img_folder"]),
        "--coco_ann_file", str(coco["ann_file"]), "--rel_candidates", str(coco["rel_candidates"]),
        "--relation_threshold", "0.01", "--out", str(out),
        "--device", "cpu"], model_cfg=PARSED_CFG, transforms=HOITransform(False, val_size=64, max_size=100))
    assert json.loads(out.read_text()) == annos and len(annos) > 0
    confs = [r["confidence"] for a in annos for r in a["relationships"]]
    assert confs and all(0.01 <= c <= 1.0 for c in confs)
    from rlipv2_tpu_torch.data.coco import build_coco_rlip

    ds = build_coco_rlip(out, {"coco2017": coco["coco2017_folder"]}, num_queries=8, device="cpu",
                         transforms=small_transforms()["val"], relation_threshold=0.01)
    assert len(ds) > 0 and len(ds[0][1]["obj_labels"]) > 0


# ------------------------------------------------ the RLIPv1 variants

def rlipv1_pretrained(tree, variant):
    """A reference-layout .pth of the tiny `variant` model: RLIP-ParSeD v1's
    with half the model's queries (fitted at load), the dense models' at the
    model's own (their embeddings are loaded only at their shape)."""
    from rlipv2_tpu_torch.models.factory import build_model

    sd = random_state_dict(build_model(dataclasses.replace(CFG, variant=variant)))
    if variant == "rlip_parsed":
        sd = {k: v[:4] if k.endswith(("tgt_embed.weight", "refpoint_embed.weight", "query_embed.weight")) else v
              for k, v in sd.items()}
    path = tree / f"{variant}.pth"
    torch.save({"model": sd}, path)
    return path


@pytest.mark.parametrize("variant,model_class", [("rlip_parsed", "RLIPParSeD"), ("rlip_parse", "RLIPParSe"),
                                                 ("rlip_parse_v2", "RLIPParSeV2")])
def test_cli_runs_the_rlipv1_variants_on_the_cpu(tree, variant, model_class):
    """scripts/finetune_hico_parsed_r50.sh's flags with --variant on the
    tiny config: one step, a checkpoint and an evaluation; RLIP-ParSeD v1
    runs the plain deformable encoder."""
    sh = REPO / "scripts" / "finetune_hico_parsed_r50.sh"
    out = tree / f"{variant}_ft"
    run = cli.main(script_argv(sh) + [
        "--variant", variant, "--device", "cpu", "--hoi_path", str(tree / "hico"), "--tokenizer_dir",
        str(tree / "tok"), "--pretrained", str(rlipv1_pretrained(tree, variant)), "--batch_size", "2",
        "--epochs", "1", "--max_steps", "1", "--output_dir", str(out)],
        model_cfg=CFG, transforms=small_transforms())
    model = run.state.model
    assert type(model).__name__ == model_class and model.cfg.variant == variant
    assert run.state.lr_scheduler.last_epoch == 1 and [p.name for p in run.checkpoints] == ["checkpoint0000.pth"]
    assert set(run.stats) >= {"mAP"} and all(0.0 <= v <= 1.0 for v in run.stats.values())
    assert (model.cfg.transformer.fusion.fusion_type == "no_fusion") == (variant == "rlip_parsed")
    saved = torch.load(run.checkpoints[0], weights_only=True)["model"]
    assert set(saved) == set(model.state_dict())


def test_cli_refuses_online_pseudo_verbs_on_rlip_parse(tree):
    """RLIP-ParSe returns no language states: --pseudo_verb in its default
    online mode raises ValueError when the step is built, naming the
    variant (the JAX step fails with a KeyError)."""
    args = cli.get_parser().parse_args([
        "--variant", "rlip_parse", "--pseudo_verb", "--device", "cpu", "--hoi_path", str(tree / "hico"),
        "--tokenizer_dir", str(tree / "tok"), "--batch_size", "2"])
    cli.check_ported(args)
    with pytest.raises(ValueError, match="variant rlip_parse.*lang_states"):
        cli.build_everything(args, model_cfg=CFG, transforms=small_transforms())


# ------------------------------------------------ RLIP-ParSeDA's loss and head options

# chip_smoke.py phase 14b's options: the curing and recon heads (their
# tensors not in pretrained.pth), the exponential aux decay and the
# contrastive object and verb losses
HEAD_OPTIONS = ["--verb_curing", "--masked_entity_modeling", "--exponential_loss", "--obj_loss_type",
                "cross_modal_matching", "--verb_loss_type", "cross_modal_matching"]
# the heads' tensors: sub_curing, obj_curing and recon_linear (weight and
# bias each), the two three-layer recon box MLPs
HEAD_TENSORS = 3 * 2 + 2 * 3 * 2


def heads_argv(tree, out):
    return ["--device", "cpu", "--hoi_path", str(tree / "hico"), "--tokenizer_dir", str(tree / "tok"),
            "--batch_size", "1", "--print_freq", "10", "--max_steps", "1", "--output_dir", str(out), *HEAD_OPTIONS]


def test_cli_trains_with_the_head_options_resumes_and_analyses_uniformity_on_the_cpu(tree, capsys):
    """Phase 14b's flags on the tiny model, from a pretrained.pth without
    the curing and recon heads (they keep their seeded values): two epochs
    of one step straight, and one epoch, a checkpoint and --resume for the
    second, which ends on the same weights bit for bit; each log line
    carries the two contrastive terms, and no loss reads the curing score,
    so the curing heads take no gradient (the optimizer holds no state for
    them) while the recon heads train. Then --eval --eval_uniformity of
    the checkpoint, which cures the verb scores, writes
    verb_class_features.npz and prints the analysis."""
    start = ["--pretrained", str(tree / "pretrained.pth")]
    straight = cli.main(heads_argv(tree, tree / "heads_straight") + start + ["--epochs", "2"], model_cfg=CFG,
                        transforms=small_transforms())
    assert f"{HEAD_TENSORS} curing and recon tensors it lacks keep their initial values" in capsys.readouterr().out
    cfg = straight.state.model.cfg
    assert cfg.verb_curing and cfg.masked_entity_modeling and cfg.subject_class
    stepped = {k for k, p in straight.state.model.named_parameters() if straight.state.optimizer.state.get(p)}
    assert not any(k.startswith(("sub_curing.", "obj_curing.")) for k in stepped)
    assert {"recon_linear.weight", "recon_sub_bbox.layers.2.bias"} <= stepped
    cli.main(heads_argv(tree, tree / "heads") + start + ["--epochs", "1"], model_cfg=CFG,
             transforms=small_transforms())
    resumed = cli.main(heads_argv(tree, tree / "heads") + ["--resume", str(tree / "heads" / "ckpt"), "--epochs", "2"],
                       model_cfg=CFG, transforms=small_transforms())
    assert resumed.resumed["epoch"] == 0 and resumed.state.rng_restored
    got, want = resumed.state.model.state_dict(), straight.state.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    log = [json.loads(x) for x in (tree / "heads" / "log.txt").read_text().splitlines()]
    assert [x["epoch"] for x in log] == [0, 1]
    assert all({"obj_matching", "verb_matching"} <= set(x["train"]) and "obj_ce" not in x["train"] for x in log)

    capsys.readouterr()
    evaluated = cli.main(heads_argv(tree, tree / "heads_eval") + [
        "--resume", str(tree / "heads" / "ckpt" / "checkpoint0001.pth"), "--eval", "--eval_uniformity"],
        model_cfg=CFG, transforms=small_transforms())
    assert set(evaluated.stats) == set(log[1]["test"]) and all(0.0 <= v <= 1.0 for v in evaluated.stats.values())
    analysis = evaluated.analysis
    assert str(analysis) in capsys.readouterr().out
    assert analysis["n_features"] > 0 and np.isfinite(analysis["uniformity"]) and analysis["alignment"] >= 0
    saved = np.load(tree / "heads_eval" / "verb_class_features.npz", allow_pickle=True)["verb_class_dict"].item()
    assert set(saved) == set(range(len(HICO_VERB_NAMES)))
    assert sum(len(f) for f in saved.values()) == analysis["n_features"]
    assert all(f.shape[1:] == (CFG.transformer.hidden_dim,) for f in saved.values() if len(f))
