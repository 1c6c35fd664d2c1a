"""Model factory: the config's `variant` -> the port's model class
(counterpart of rlipv2_tpu/models/factory.py:21-38, :97-100).

  rlip_parseda_v2      DAB-deformable + ALIF (RLIPParSeDA)
  rlip_parsed_v2       deformable non-DAB + ALIF (RLIPParSeD)
  rlip_parsed          deformable non-DAB, no ALIF: RLIPParSeD with
                       fusion_type "no_fusion" (RLIP-ParSeD v1)
  parse, rlip_parse    vanilla DETR with decode-time fusion (RLIPParSe)
  rlip_parse_v2        vanilla DETR + the dense ALIF encoder (RLIPParSeV2)
  rlip_parse_v1_joint  the reference-wired RLIP-ParSe v1 (RLIPParSeV1Joint;
                       no text encoder: pooled label features in)
  qpic, cdn, qahoi, ocn, sep_detr_hoi, sep_ddetr_hoi_v3, seq_detr_hoi,
  stochastic_detr_hoi, iterative_detr_hoi, detr_hoi_hm, coupled_detr_hoi,
  qahoi_two_stage, parse_dab_ddetr
                       the closed-vocabulary zoo (`models/closed_vocab.py`;
                       forward(pixels, pixel_valid), no text)
  parse_dab_detr       closed-vocabulary DAB-DETR (ParSeDABDETR,
                       `models/dab_detr.py`; forward(pixels, pixel_valid))
  rlip_mdetr           the MDETR joint image-text encoder with ParSe
                       decoding (RLIPMDETR; no text encoder: pooled label
                       features in)
The zoo, `parse_dab_detr` and `rlip_mdetr` are the JAX package's through its
factory only: its CLI offers none of them.

MODEL_CLASSES is the one table of variants, every variant of the JAX
factory: what a variant builds, and so whether it has an R-Tagger
(`forward_tagger`) and the verb-curing and masked-entity heads
(`HEAD_PREFIXES`, RLIP-ParSeDA's only).
"""

from __future__ import annotations

import dataclasses

from rlipv2_tpu_torch.config import ModelConfig
from rlipv2_tpu_torch.models import closed_vocab
from rlipv2_tpu_torch.models.dab_detr import ParSeDABDETR
from rlipv2_tpu_torch.models.mdetr import RLIPMDETR, RLIPParSeV1Joint
from rlipv2_tpu_torch.models.parse import RLIPParSe, RLIPParSeV2
from rlipv2_tpu_torch.models.parsed import RLIPParSeD
from rlipv2_tpu_torch.models.parseda import RLIPParSeDA

MODEL_CLASSES = {
    "rlip_parseda_v2": RLIPParSeDA,
    "rlip_parsed_v2": RLIPParSeD,
    "rlip_parsed": RLIPParSeD,
    "parse": RLIPParSe,
    "rlip_parse": RLIPParSe,
    "rlip_parse_v2": RLIPParSeV2,
    "rlip_parse_v1_joint": RLIPParSeV1Joint,
    "parse_dab_detr": ParSeDABDETR,
    "rlip_mdetr": RLIPMDETR,
}
CLOSED_VOCAB_CLASSES = {
    "qpic": closed_vocab.QPICModel,
    "cdn": closed_vocab.CDNModel,
    "qahoi": closed_vocab.QAHOIModel,
    "ocn": closed_vocab.OCNModel,
    "sep_detr_hoi": closed_vocab.SepDETRHOIModel,
    "sep_ddetr_hoi_v3": closed_vocab.SepDDETRHOIv3Model,
    "seq_detr_hoi": closed_vocab.SeqDETRHOIModel,
    "stochastic_detr_hoi": closed_vocab.StochasticDETRHOIModel,
    "iterative_detr_hoi": closed_vocab.IterativeDETRHOIModel,
    "detr_hoi_hm": closed_vocab.DETRHOIhmModel,
    "coupled_detr_hoi": closed_vocab.CoupledDETRHOIModel,
    "qahoi_two_stage": closed_vocab.QAHOITwoStageModel,
    "parse_dab_ddetr": closed_vocab.ParSeDABDDETRModel,
}
MODEL_CLASSES.update(CLOSED_VOCAB_CLASSES)
CLOSED_VOCAB_VARIANTS = tuple(CLOSED_VOCAB_CLASSES)
PORTED_VARIANTS = tuple(MODEL_CLASSES)
# the variants of the JAX factory that the JAX CLI's --variant does not offer
# (rlipv2_tpu/cli.py:95-101), besides the zoo
FACTORY_ONLY_VARIANTS = ("parse_dab_detr", "rlip_mdetr")
TAGGER_VARIANTS = tuple(v for v, cls in MODEL_CLASSES.items() if hasattr(cls, "forward_tagger"))
HEAD_OPTIONS = ("verb_curing", "masked_entity_modeling")


def check_heads(cfg: ModelConfig) -> None:
    """Raise ValueError when `cfg` sets verb_curing or masked_entity_modeling
    for a variant whose class has no such heads: its JAX class, of the same
    name, builds or calls none, so the option would silently do nothing."""
    cls = MODEL_CLASSES[cfg.variant]
    set_ = [k for k in HEAD_OPTIONS if getattr(cfg, k)]
    if set_ and not getattr(cls, "HEAD_PREFIXES", ()):
        raise ValueError(f"variant {cfg.variant}: {', '.join(set_)} would do nothing, since the JAX "
                         f"{cls.__name__} never calls such heads; RLIP-ParSeDA (rlip_parseda_v2) has them")


def build_model(cfg: ModelConfig, tagger: bool = False):
    """The model of `cfg.variant`; `tagger` adds the R-Tagger's parameters."""
    v = cfg.variant
    if v not in MODEL_CLASSES:
        raise ValueError(f"unknown variant: {v}; the variants: {PORTED_VARIANTS}")
    if tagger and v not in TAGGER_VARIANTS:
        raise ValueError(f"variant {v} has no R-Tagger (forward_tagger); the tagger's variants: {TAGGER_VARIANTS}")
    check_heads(cfg)
    if v == "rlip_parsed":  # v1: the same architecture without ALIF fusion
        fusion = dataclasses.replace(cfg.transformer.fusion, fusion_type="no_fusion")
        cfg = dataclasses.replace(cfg, transformer=dataclasses.replace(cfg.transformer, fusion=fusion))
    cls = MODEL_CLASSES[v]
    return cls(cfg, tagger=tagger) if v in TAGGER_VARIANTS else cls(cfg)
