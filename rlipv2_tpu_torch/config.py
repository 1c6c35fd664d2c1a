"""Typed configuration tree: frozen dataclasses and named presets.

The port keeps its own copy of `rlipv2_tpu/config.py` and imports nothing
of the JAX package. `tests/test_torch_config.py` holds every preset equal
in both packages, so the copy cannot drift; the field comments are the JAX
package's and may name its TPU-only options, which the port rejects
(`models/parseda.py::check_supported`, `engine/train.py`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class BackboneConfig:
    name: str = "resnet50"  # resnet50 | resnet101 | swin_tiny | swin_small | swin_base | swin_base_384 | swin_large | swin_large_384
    # indices of stages to expose as feature levels (DDETR uses strides 8/16/32)
    num_outputs: int = 3
    frozen_stages: int = 1  # resnet: freeze stem (+stage1) like DETR's lr=0 trick
    drop_path_rate: float = 0.0  # swin only
    use_checkpoint: bool = False  # remat swin blocks
    # W8A8 dynamic-quantized projections (ops/int8_dense.py) for the Swin
    # qkv/proj/MLP matmuls — INFERENCE-ONLY opt-in (the int8 matmul has no
    # useful gradient); ~2x MXU rate where the blocks are matmul-bound
    # (Swin-L stage 3, SURVEY §6)
    int8_dense: bool = False


@dataclass(frozen=True)
class TextEncoderConfig:
    name: str = "roberta-base"
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    freeze: bool = False


@dataclass(frozen=True)
class FusionConfig:
    """ALIF cross-modal fusion (reference: models/fuse_helper.py:983-1095,
    models/deformable_transformer.py:791-884)."""
    fusion_type: str = "GLIP_attn"  # GLIP_attn | MDETR_attn | no_fusion
    gating_mechanism: str = "VXAc"  # one of the 14 reference gating modes
    fusion_interval: int = 2
    fusion_last_vis: bool = True
    lang_aux_loss: bool = True
    embed_dim: int = 2048  # BiMHA inner dim
    num_heads: int = 8
    stable_softmax_2d: bool = False
    clamp_min_for_underflow: bool = True
    clamp_max_for_overflow: bool = True
    use_checkpoint_fusion: bool = False  # jax.checkpoint over VLFuse


@dataclass(frozen=True)
class TransformerConfig:
    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 3
    dim_feedforward: int = 1024
    dropout: float = 0.1
    num_feature_levels: int = 4
    enc_n_points: int = 4
    dec_n_points: int = 4
    verb_query_tgt_type: str = "vanilla_MBF"  # vanilla | MBF | vanilla_MBF
    # rematerialize deformable encoder layers in the backward (TPU
    # equivalent of the reference's --use_checkpoint family; required to
    # fit bs8 832x1344 training in 16 GB HBM)
    remat_encoder: bool = False
    # which tagged intermediates the remat policy saves
    # (jax.checkpoint_policies.save_only_these_names). Tags available:
    # "msda_out" (the deformable-attention output, ~8x the rest of the
    # layer to recompute), "msda_value" (the value projection feeding the
    # kernel), "enc_ffn_out" (the FFN branch output). Default measured in
    # tools/profile_train.py (SURVEY §6 remat-policy A/B).
    remat_save_names: tuple = ("msda_out",)
    # MSDA kernel implementation: auto | pallas | pallas_v5 (sub-slab
    # split + strip permutation; exact, measured slower than v4 — see
    # SURVEY §6) | pallas_int8 (opt-in quantized inference fast path,
    # ~1.3x, <~1% rel. error, fwd-only)
    msda_impl: str = "auto"
    # W8A8 dynamic-quantized dense stacks (ops/int8_dense.py): encoder /
    # decoder FFNs, MSDA value/output projections, BiMHA projections.
    # INFERENCE-ONLY opt-in, same contract as backbone.int8_dense.
    int8_dense: bool = False
    fusion: FusionConfig = field(default_factory=FusionConfig)


@dataclass(frozen=True)
class ModelConfig:
    """One config tree per model variant (BASELINE.json configs)."""
    variant: str = "rlip_parseda_v2"  # parse | rlip_parse | rlip_parsed | rlip_parsed_v2 | rlip_parseda_v2
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    text_encoder: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    num_queries: int = 200  # total ho queries; nq/2 (sub, obj) pairs
    aux_loss: bool = True
    with_box_refine: bool = True
    subject_class: bool = False
    pseudo_verb: bool = False
    # online = inter-verb similarity from the CURRENT forward's post-ALIF
    # language states (reference: models/hoi.py:2197-2207); offline = from
    # precomputed pooled text features (:2209-2216)
    pseudo_verb_mode: str = "online"
    # pair-quality curing heads whose sigmoid product suppresses verb
    # scores (reference: models/hoi.py:2953-2956, 3036-3037)
    verb_curing: bool = False
    # masked entity modeling: cross-reconstruct sub/obj states from the
    # partner + verb states and supervise with the standard class/box
    # losses (reference: models/hoi.py:2958-2966, 3204-3280)
    masked_entity_modeling: bool = False
    use_dab: bool = True
    random_refpoints_xy: bool = False
    # two-stage deformable DETR (reference:
    # models/deformable_transformer.py:106-134, 176-191): encoder output
    # proposals + top-k query initialization
    two_stage: bool = False
    two_stage_num_proposals: int = 300
    # static text-slot sizes (negative sampling pads to these; the reference
    # pads dynamically, e.g. 500 sampled negatives at engine.py:730-744)
    max_obj_texts: int = 96
    max_verb_texts: int = 160
    # compute dtype for the TPU path; params stay fp32
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    lr_backbone: float = 1e-5
    lr_text_encoder: float = 1e-5
    weight_decay: float = 1e-4
    clip_max_norm: float = 0.1
    epochs: int = 20
    lr_drop: int = 15
    schedule: str = "step"  # step | multistep | linear_with_warmup | all_linear_with_warmup
    warmup_steps: int = 0
    batch_size: int = 8
    ema: bool = False
    ema_decay: float = 0.9997
    seed: int = 42
    # fine-tune parameter-freezing regimes (reference: main.py:632-688):
    # "frozen_vision" freezes backbone stages 1-2; "unfrozen_params"
    # trains ONLY the text encoder; "frozen_detection" freezes backbone +
    # ALIF encoder + ho decoder + input projections. None = train all.
    freeze_regime: Optional[str] = None


@dataclass(frozen=True)
class LossConfig:
    # matcher costs (reference: models/matcher.py:272-288)
    set_cost_obj_class: float = 1.0
    set_cost_verb_class: float = 1.0
    set_cost_bbox: float = 2.5
    set_cost_giou: float = 1.0
    # loss weights (reference: models/detr.py:571-621)
    obj_loss_coef: float = 1.0
    verb_loss_coef: float = 1.0
    bbox_loss_coef: float = 2.5
    giou_loss_coef: float = 1.0
    obj_loss_type: str = "cross_entropy"  # cross_entropy | focal | cross_modal_matching
    # focal | bce | weighted_bce | asymmetric_bce | CB_focal_bce |
    # cross_modal_matching (reference: models/hoi.py:3635,3925-4034)
    verb_loss_type: str = "focal"
    eos_coef: float = 0.1
    focal_alpha: float = 0.25
    giou_verb_label: bool = False  # RPL: GIoU-soft verb labels
    triplet_filtering: bool = False
    naive_obj_smooth: float = 0.0
    naive_verb_smooth: float = 0.0
    # cross-modal contrastive align (reference: models/hoi.py:4497-4619)
    matching_symmetric: bool = True
    # masked entity modeling recon losses (reference: models/hoi.py:4119-4128)
    masked_loss_coef: float = 1.0
    # exponential per-layer aux decay (reference: models/detr.py:608-621)
    exponential_loss: bool = False
    exponential_hyper: float = 0.8
    # max GT triplets per image after padding (static shapes)
    max_triplets: int = 64


def rlip_parseda_v2_r50() -> ModelConfig:
    """Canonical RLIPv2-ParSeDA ResNet-50 preset (reference:
    scripts/RLIP_ParSeDA/train_RLIP_ParSeDA_v2_mixed_vgcocoo365_swinL.sh
    hyperparams: enc 6 / dec 3, nq 200, GLIP_attn, VXAc, vanilla_MBF,
    fusion_interval 2, fusion_last_vis, lang_aux_loss)."""
    return ModelConfig()


def rlip_parseda_v2_swin(size: str = "large_384") -> ModelConfig:
    return dataclasses.replace(
        rlip_parseda_v2_r50(),
        backbone=BackboneConfig(name=f"swin_{size}", drop_path_rate=0.2),
    )


def rlip_parsed_v2_r50() -> ModelConfig:
    """RLIP-ParSeD v2 (deformable non-DAB + ALIF) — the R-Tagger backbone
    config (reference: scripts/verb_tagger/train_vg_RLIP_ParSeD_v2_tagger_resnet.sh)."""
    return dataclasses.replace(rlip_parseda_v2_r50(), variant="rlip_parsed_v2")


PRESETS = {
    "rlip_parseda_v2_r50": rlip_parseda_v2_r50,
    "rlip_parseda_v2_swin_t": lambda: rlip_parseda_v2_swin("tiny"),
    "rlip_parseda_v2_swin_l": lambda: rlip_parseda_v2_swin("large_384"),
    # canonical long name used by the experiment scripts
    "rlip_parseda_v2_swin_large": lambda: rlip_parseda_v2_swin("large_384"),
    "rlip_parsed_v2_r50": rlip_parsed_v2_r50,
}
