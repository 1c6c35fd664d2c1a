"""The port's Swin backbone against the JAX one, in float32 on CPU.

The JAX params go through `engine/convert.py::swin` and load into the
port's SwinTransformer with strict=True; the three outputs agree within
1e-4 (float32, the same arithmetic summed in another order). Two specs:
`swin_test` (window 4, one block a stage, so no shifted block) at 72x104,
whose stage grids 18x26, 9x13, 5x7 and 3x4 all pad; and a narrow spec with
window 12 and two blocks a stage at 118x166, which is not a multiple of 4
(flax's "SAME" patch padding) and whose padded grids 36x48 and 24x24 shift
while 12x12 and 12x12 do not. The window helpers are held equal to the JAX
ones exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlipv2_tpu.models import swin as jax_swin
from rlipv2_tpu_torch.engine.convert import swin as swin_state_dict
from rlipv2_tpu_torch.models import swin
from test_torch_parseda import random_params

torch.set_num_threads(2)

ATOL = 1e-4
NARROW = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4), window_size=12)
CASES = {  # name: (spec fields, input size)
    "swin_test": (None, (72, 104)),
    "narrow_w12": (NARROW, (118, 166)),
}


def _specs(name):
    fields, _ = CASES[name]
    if fields is None:
        return jax_swin.SWIN_SPECS[name], swin.SWIN_SPECS[name]
    return jax_swin.SwinSpec(**fields), swin.SwinSpec(**fields)


@pytest.fixture(scope="module", params=sorted(CASES))
def swin_pair(request):
    """(input size, jitted jax apply, jax params, port model with the
    converted params) for one case; seeded random params, so the norms'
    biases and the padded tokens they make are not zero."""
    jspec, tspec = _specs(request.param)
    H, W = CASES[request.param][1]
    jm = jax_swin.SwinTransformer(jspec)
    params = random_params(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3))), seed=0)
    model = swin.SwinTransformer(tspec)
    sd = swin_state_dict(params["params"], tspec, "")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return (H, W), jax.jit(jm.apply), params, model.eval()


def test_swin_matches_jax(swin_pair):
    (H, W), jax_apply, params, model = swin_pair
    x = np.random.RandomState(1).randn(2, H, W, 3).astype(np.float32)
    want = jax_apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g, w, c in zip(got, want, model.out_channels):
        assert g.shape[1] == c
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_narrow_case_pads_and_runs_both_shift_branches():
    """The grids the narrow case reaches: every stage pads, two shift."""
    _, tspec = _specs("narrow_w12")
    ws = tspec.window_size
    H, W = (-(-s // 4) for s in CASES["narrow_w12"][1])
    shifts = []
    for _ in tspec.depths:
        Hp, Wp = H + (-H) % ws, W + (-W) % ws
        assert (Hp, Wp) != (H, W)
        shifts.append(min(Hp, Wp) > ws)
        H, W = -(-H // 2), -(-W // 2)
    assert shifts == [True, True, False, False]


@pytest.mark.parametrize("ws", [4, 7, 12])
def test_relative_position_index_matches_jax(ws):
    np.testing.assert_array_equal(swin.relative_position_index(ws), jax_swin.relative_position_index(ws))


@pytest.mark.parametrize("H,W,ws", [(8, 8, 4), (36, 48, 12), (14, 21, 7)])
def test_shifted_window_mask_matches_jax(H, W, ws):
    want = jax_swin.shifted_window_mask(H, W, ws, ws // 2)
    got = swin.shifted_window_mask(H, W, ws, ws // 2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_window_partition_matches_jax_and_round_trips():
    x = np.random.RandomState(0).randn(2, 8, 12, 5).astype(np.float32)
    wins = swin.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(jax_swin.window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(swin.window_reverse(wins, 4, 8, 12).numpy(), x)


def test_relative_position_index_is_not_in_the_state_dict():
    model = swin.SwinTransformer.from_name("swin_test")
    assert not any("relative_position_index" in k for k in model.state_dict())
    idx = model.layers[0].blocks[0].attn.relative_position_index
    np.testing.assert_array_equal(idx.numpy(), jax_swin.relative_position_index(4))


def test_drop_path_in_train_mode_raises():
    model = swin.SwinTransformer.from_name("swin_test", drop_path_rate=0.2)
    with pytest.raises(NotImplementedError, match="DropPath"):
        model.train()(torch.zeros(1, 32, 32, 3))
    assert len(model.eval()(torch.zeros(1, 32, 32, 3))) == 3
