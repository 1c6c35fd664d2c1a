"""Model factory: the config's `variant` -> the port's model class
(counterpart of rlipv2_tpu/models/factory.py:22-31).

  rlip_parseda_v2  DAB-deformable + ALIF (RLIPParSeDA)
  rlip_parsed_v2   deformable non-DAB + ALIF (RLIPParSeD)

Every other variant of the JAX factory raises: ROADMAP queue 1 item 20.
"""

from __future__ import annotations

from rlipv2_tpu_torch.config import ModelConfig

PORTED_VARIANTS = ("rlip_parseda_v2", "rlip_parsed_v2")


def build_model(cfg: ModelConfig, tagger: bool = False):
    """The model of `cfg.variant`; `tagger` adds the R-Tagger's parameters."""
    from rlipv2_tpu_torch.models.parsed import RLIPParSeD
    from rlipv2_tpu_torch.models.parseda import RLIPParSeDA

    if cfg.variant not in PORTED_VARIANTS:
        raise NotImplementedError(f"variant {cfg.variant} is not ported yet (ROADMAP queue 1 item 20); "
                                  f"ported: {PORTED_VARIANTS}")
    return (RLIPParSeD if cfg.variant == "rlip_parsed_v2" else RLIPParSeDA)(cfg, tagger=tagger)
