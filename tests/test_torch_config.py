"""The port keeps its own copy of the config tree; every preset, and every
default of the train and loss configs, is equal in both packages, so the
copy cannot drift."""

import dataclasses

import pytest

from rlipv2_tpu import config as jax_config
from rlipv2_tpu_torch import config


def test_same_presets():
    assert sorted(config.PRESETS) == sorted(jax_config.PRESETS)


@pytest.mark.parametrize("name", sorted(jax_config.PRESETS))
def test_preset_equal_in_both_packages(name):
    assert dataclasses.asdict(config.PRESETS[name]()) == dataclasses.asdict(jax_config.PRESETS[name]())


@pytest.mark.parametrize("cls", ["TrainConfig", "LossConfig", "ModelConfig"])
def test_config_defaults_equal_in_both_packages(cls):
    assert dataclasses.asdict(getattr(config, cls)()) == dataclasses.asdict(getattr(jax_config, cls)())
