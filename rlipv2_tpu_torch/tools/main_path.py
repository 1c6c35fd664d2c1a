"""The model of the port's main paths, built once for every tool that runs it.

Preset rlip_parseda_v2_r50 at full width with HICO's text slots (81 object,
117 verb) and RoBERTa-base at 12 layers, as the JAX package's benchmark
builds it, with seeded random weights in the reference state-dict layout.
`chip_smoke.py` and `tools/profile_forward.py` take the inference model from
`main_path_model`; `chip_smoke.py` and `tools/profile_train.py` take the
train step from `main_train_step` and its data from `main_train_data`, so
the profiled model is the smoke's model.
"""

from __future__ import annotations

import dataclasses
import subprocess

import torch

from rlipv2_tpu_torch.config import TextEncoderConfig, rlip_parseda_v2_r50
from rlipv2_tpu_torch.tools.golden_pack import synth_state_dict

BATCH, BUCKET = 8, (832, 1344)  # HICO val images resize to at most 800 x 1333
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


def _seeded_model():
    from rlipv2_tpu_torch.models.parseda import RLIPParSeDA

    cfg = dataclasses.replace(
        rlip_parseda_v2_r50(),
        text_encoder=TextEncoderConfig(num_layers=12),
        max_obj_texts=81,
        max_verb_texts=117,
    )
    model = RLIPParSeDA(cfg)
    model.load_state_dict(random_state_dict(model), strict=True)
    return cfg, model


def main_path_model(device):
    """(cfg, model): the main path's RLIPParSeDA with seeded weights loaded
    strictly, on `device`, in eval mode."""
    cfg, model = _seeded_model()
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
