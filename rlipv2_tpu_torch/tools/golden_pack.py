"""Golden-pack check for the torch model (counterpart of
rlipv2_tpu/tools/golden_pack.py::check_pack).

The committed pack (tests/fixtures/golden_pack.npz) stores the reference
torch model's state-dict manifest, canned inputs and the reference outputs.
`check_pack` regenerates the weights from the manifest with
`synth_state_dict` (numpy only: the stream the pack's weights were drawn
from), loads them into the port's RLIPParSeDA with
`load_state_dict(strict=True)` (the keys are the reference's, so no
converter is involved) and compares the outputs, aux layers included. It
runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from rlipv2_tpu_torch.config import BackboneConfig, ModelConfig, TextEncoderConfig, TransformerConfig

PACK_PATH = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "golden_pack.npz"
# dims of the frozen scenario, as the pack was made
NQ, ENC, DEC = 8, 4, 2
N_OBJ, N_PRED = 4, 4


def synth_state_dict(names, shapes, dtypes, seed: int = 0) -> dict:
    """Deterministically regenerate a torch-layout state dict from its
    manifest: one numpy RandomState stream, values drawn per tensor in
    manifest order (the generator of the pack's weights):
      * `running_var`      -> U[0.75, 1.25)
      * `running_mean`     -> 0.1 * randn
      * other 1-D `weight` -> 1 + 0.1 * randn
      * everything float   -> 0.02 * randn
      * integer tensors    -> zeros
    """
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape, dt in zip(names, shapes, dtypes):
        shape = tuple(int(s) for s in shape)
        dt = np.dtype(dt)
        if not np.issubdtype(dt, np.floating):
            out[name] = np.zeros(shape, dt)
            continue
        if name.endswith("running_var"):
            v = rng.rand(*shape) * 0.5 + 0.75
        elif name.endswith("running_mean"):
            v = rng.randn(*shape) * 0.1
        elif len(shape) == 1 and name.endswith("weight"):
            v = 1.0 + rng.randn(*shape) * 0.1
        else:
            v = rng.randn(*shape) * 0.02
        out[name] = v.astype(dt)
    return out


def pack_config() -> ModelConfig:
    return ModelConfig(
        backbone=BackboneConfig(name="resnet_test", num_outputs=3),
        text_encoder=TextEncoderConfig(num_layers=1),
        transformer=TransformerConfig(enc_layers=ENC, dec_layers=DEC, dropout=0.0),
        num_queries=NQ, max_obj_texts=N_OBJ, max_verb_texts=N_PRED,
        dtype="float32",
    )


def load_pack(path=PACK_PATH):
    """(npz, manifest) of the committed pack."""
    z = np.load(path, allow_pickle=False)
    return z, json.loads(str(z["manifest_json"]))


OUTPUT_KEYS = ("pred_obj_logits", "pred_verb_logits", "pred_sub_boxes", "pred_obj_boxes")


def torch_pack_config():
    """The pack's config; its RoBERTa was built from the HF default config
    (type_vocab_size 2, max_position_embeddings 512), which sizes two
    embedding tables."""
    cfg = pack_config()
    return dataclasses.replace(
        cfg,
        text_encoder=dataclasses.replace(
            cfg.text_encoder, type_vocab_size=2, max_position_embeddings=512
        ),
    )


@torch.no_grad()
def check_pack(atol: float = 2e-3, device="cuda") -> dict:
    """Regenerate weights -> load strictly -> run on `device` -> compare
    with the frozen reference outputs. Returns {key: max_abs_delta}; raises
    AssertionError beyond `atol`. On a GPU the caller turns TF32 off."""
    from rlipv2_tpu_torch.models.parseda import RLIPParSeDA

    z, manifest = load_pack(PACK_PATH)
    sd = synth_state_dict(
        manifest["names"], manifest["shapes"], manifest["dtypes"], seed=int(manifest["seed"])
    )
    model = RLIPParSeDA(torch_pack_config())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    model.to(device).eval()
    inputs = [torch.from_numpy(z[k]).to(device) for k in ("pixels", "pixel_valid", "text_emb", "text_valid")]
    out = model(*inputs, N_OBJ)
    n_aux = int(z["n_aux"])
    if len(out["aux_outputs"]) != n_aux:
        raise AssertionError(f"aux layers {len(out['aux_outputs'])} != frozen {n_aux}")
    report = {}
    for tag, got in [("", out)] + [(f"aux{l}.", out["aux_outputs"][l]) for l in range(n_aux)]:
        for key in OUTPUT_KEYS:
            want = z[f"ref_{tag.replace('.', '_')}{key}"]
            d = float(np.abs(got[key].cpu().numpy() - want).max())
            report[f"{tag}{key}"] = d
            if not d <= atol:
                raise AssertionError(f"{tag}{key}: max delta {d} > {atol}")
    return report
