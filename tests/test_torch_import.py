"""The torch port stands alone: it imports neither JAX nor PIL (the machine
with the GPU has neither), and nothing of the JAX package `rlipv2_tpu`,
neither by import nor by a path into its directory."""

import ast
import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "rlipv2_tpu_torch"
# a file:line citation of the JAX package names a place to read, not a path
# the program opens
CITATION = re.compile(r"^rlipv2_tpu/[\w/]+\.py:\d+$")


def _port_modules():
    import rlipv2_tpu_torch

    names = ["rlipv2_tpu_torch"]
    for info in pkgutil.walk_packages(rlipv2_tpu_torch.__path__, "rlipv2_tpu_torch."):
        names.append(info.name)
    return names


def test_port_has_every_slice_module():
    names = set(_port_modules())
    for mod in (
        "structures", "config", "ops.boxes", "ops.positional", "ops.ms_deform_attn",
        "ops.cuda_build", "ops.window_attention", "models.resnet", "models.swin",
        "models.layers", "models.roberta", "models.fusion", "models.deformable",
        "models.dab_decoder", "models.parseda",
        "eval.postprocess", "eval.hico_eval", "eval.common", "engine.loops", "engine.convert",
        "engine.optim", "engine.train", "losses.matcher", "losses.criterion",
        "data.synthetic", "data.vocab", "data.loader", "data.transforms", "data.collate",
        "data.text", "data.pipeline", "utils.logging", "tools.golden_pack",
        "tools.main_path", "tools.profile_forward", "tools.profile_train", "tools.device_profile",
    ):
        assert f"rlipv2_tpu_torch.{mod}" in names, mod


def _docstring_nodes(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                yield body[0].value


def jax_package_references(source: str) -> list[str]:
    """Imports of `rlipv2_tpu` and strings that name it as a module or a
    path ('rlipv2_tpu', 'rlipv2_tpu.x', '.../rlipv2_tpu/...'), outside
    docstrings, comments and file:line citations."""
    tree = ast.parse(source)
    docstrings = {id(n) for n in _docstring_nodes(tree)}
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if a.name.split(".")[0] == "rlipv2_tpu"]
        elif isinstance(node, ast.ImportFrom) and node.module and node.module.split(".")[0] == "rlipv2_tpu":
            found.append(node.module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docstrings:
            s = node.value
            if CITATION.match(s):
                continue
            if s == "rlipv2_tpu" or s.startswith("rlipv2_tpu.") or re.search(r"(^|/)rlipv2_tpu(/|$)", s):
                found.append(s)
    return found


@pytest.mark.parametrize(
    "source,bad",
    [
        ("import rlipv2_tpu\n", True),
        ("from rlipv2_tpu.config import PRESETS\n", True),
        ("import rlipv2_tpu.data.vocab as v\n", True),
        ("from rlipv2_tpu import config\n", True),
        ("p = Path(__file__).parents[2] / 'rlipv2_tpu' / 'eval'\n", True),
        ("importlib.import_module('rlipv2_tpu.native')\n", True),
        ("p = '/root/x/rlipv2_tpu/eval/common.py'\n", True),
        ("from rlipv2_tpu_torch.config import PRESETS\n", False),
        ("'''Counterpart of rlipv2_tpu/engine/train.py.'''\n# rlipv2_tpu/config.py\n", False),
        ("REPLACES = 'rlipv2_tpu/ops/ms_deform_attn_v4.py:267'\n", False),
    ],
)
def test_static_scan_finds_jax_package_references(source, bad):
    assert bool(jax_package_references(source)) == bad


def test_port_sources_name_nothing_of_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    found = {str(f.relative_to(REPO)): jax_package_references(f.read_text()) for f in files}
    assert {k: v for k, v in found.items() if v} == {}


ISOLATION_RUN = """
import dataclasses, importlib, json, sys
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(2)  # the test workers share the host's cores
for m in {modules!r}:
    importlib.import_module(m)

from rlipv2_tpu_torch.config import (BackboneConfig, FusionConfig, LossConfig, ModelConfig,
    TextEncoderConfig, TrainConfig, TransformerConfig)
from rlipv2_tpu_torch.data.synthetic import SyntheticHICODataset
from rlipv2_tpu_torch.engine.loops import CachedTextEncoder, evaluate_hoi, train_one_epoch
from rlipv2_tpu_torch.engine.optim import build_optimizer, freeze_backbone_stem_and_layer1
from rlipv2_tpu_torch.engine.train import make_train_step
from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI
from rlipv2_tpu_torch.models.parseda import RLIPParSeDA
from rlipv2_tpu_torch.tools.main_path import random_state_dict

torch.manual_seed(0)
cfg = ModelConfig(
    backbone=BackboneConfig(name="resnet_test", num_outputs=3),
    text_encoder=TextEncoderConfig(vocab_size=128, hidden_size=32, num_layers=1, num_heads=4,
                                   intermediate_size=64, max_position_embeddings=64),
    transformer=TransformerConfig(hidden_dim=64, nheads=4, enc_layers=2, dec_layers=2,
                                  dim_feedforward=64, fusion=FusionConfig(embed_dim=64, num_heads=4)),
    num_queries=8, max_obj_texts=5, max_verb_texts=4, dtype="float32")
model = RLIPParSeDA(cfg)
model.load_state_dict(random_state_dict(model))
rs = np.random.RandomState(0)
text = CachedTextEncoder(lambda texts: rs.randn(len(texts), 32).astype(np.float32))
val = SyntheticHICODataset(2, min_size=(30, 40), max_size=(48, 64), n_obj_classes=4, n_verb_classes=4)
evaluate_hoi(lambda m, *a: m(*a), model.eval(), val, cfg, text, batch_size=2, bucket=(48, 64))
swin_cfg = dataclasses.replace(cfg, backbone=BackboneConfig(name="swin_test", num_outputs=3))
swin_model = RLIPParSeDA(swin_cfg)
swin_model.load_state_dict(random_state_dict(swin_model))
evaluate_hoi(lambda m, *a: m(*a), swin_model.eval(), val, swin_cfg, text, batch_size=2, bucket=(48, 64))
train = SyntheticHICODataset(4, min_size=(30, 40), max_size=(48, 64), n_obj_classes=4,
                             n_verb_classes=4, image_set="train")
freeze_backbone_stem_and_layer1(model)
tcfg = TrainConfig()
opt, sched = build_optimizer(model, tcfg)
step = make_train_step(model.train(), SetCriterionHOI(LossConfig()), opt, sched, tcfg)
train_one_epoch(step, model, train, list(range(4)), 2, cfg, text, print_freq=10)

repo_pkg = Path({jax_pkg!r})
loaded = sorted(k for k in sys.modules if k.split(".")[0] in ("rlipv2_tpu", "jax", "flax", "PIL"))
under = sorted(k for k, m in list(sys.modules.items())
               if getattr(m, "__file__", None) and repo_pkg in Path(m.__file__).resolve().parents)
print(json.dumps({{"loaded": loaded, "under": under}}))
"""


def test_import_pulls_in_no_jax_flax_or_pil():
    """Every port module imported, then a tiny CPU evaluate_hoi with a
    ResNet and with a Swin backbone and two CPU train steps in a fresh
    interpreter: no `rlipv2_tpu`, JAX, flax or PIL module is loaded, and no
    loaded module's file lies under rlipv2_tpu/."""
    code = ISOLATION_RUN.format(modules=_port_modules(), jax_pkg=str(REPO / "rlipv2_tpu"))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"loaded": [], "under": []}
