"""Each module of the port against its flax counterpart, on the same weights.

The port module is initialised from a seeded ``torch.Generator``; its
``state_dict`` reaches JAX through the JAX package's own converters
(``ssde_tpu.checkpoint.convert_*``), and numpy inputs made from a seed go to
both sides in float32. Tolerances: 1e-5 per module (f32 sums in another
order), 1e-4 for the 20-conv ResNet18 encoder; the v10 block uses the JAX
package's own planar-vs-NHWC bound of 3e-5 (tests/test_recurrent.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssde_tpu.checkpoint import (convert_depth_decoder, convert_gru_blocks,
                                 convert_resnet_encoder)
from ssde_tpu.models import ResnetEncoder as FlaxEncoder
from ssde_tpu.models.common import ResidualConvUnit as FlaxRCU
from ssde_tpu.models.depth_decoder import DepthDecoder as FlaxDecoder
from ssde_tpu.models.fusion import GRUFusionBlock_v2 as FlaxFusion
from ssde_tpu.models.recurrent import ConvGRUBlocks as FlaxBlocks
from ssde_tpu.models.recurrent import ConvGRUCell as FlaxCell
from ssde_tpu.models.recurrent import make_gru as flax_make_gru
from ssde_tpu_torch.models import (ConvGRUCell, DepthDecoder, GRUFusionBlock_v2,
                                   ResidualConvUnit, ResnetEncoder, make_gru)
from ssde_tpu_torch.models.common import sample_, init_weights_
from ssde_tpu_torch.models.resnet import randomize_bn_stats_

H, W = 32, 64  # scale-0 resolution of the block tests (as tests/test_recurrent.py)
DEC_CH = (16, 32, 64, 128)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _np_sd(module, prefix=""):
    return {prefix + k: v.detach().numpy() for k, v in module.state_dict().items()}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return np.asarray(t.detach().numpy()).transpose(0, 2, 3, 1)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _close(port_nchw, flax_nhwc, tol, msg=""):
    np.testing.assert_allclose(_nhwc(port_nchw), np.asarray(flax_nhwc),
                               atol=tol, rtol=0, err_msg=msg)


def test_resnet18_encoder_features():
    enc = ResnetEncoder(18)
    enc.init_weights_(_gen(0))
    randomize_bn_stats_(enc, _gen(1))
    enc.eval()
    x = np.random.RandomState(0).rand(2, 64, 96, 3).astype(np.float32)
    params, stats, _ = convert_resnet_encoder(_np_sd(enc))
    want = FlaxEncoder(18).apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x), False)
    with torch.no_grad():
        got = enc(_nchw(x))
    assert len(got) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, 1e-4, f"feature {i}")


@pytest.mark.parametrize("pre_disp", [False, True])
def test_depth_decoder(pre_disp):
    rng = np.random.RandomState(1)
    num_ch_enc = [64, 64, 128, 256, 512]
    feats = [_rand(rng, 2, 32 >> i, 64 >> i, c) for i, c in enumerate(num_ch_enc)]
    dec = DepthDecoder(num_ch_enc)
    init_weights_(dec, _gen(2))
    params = convert_depth_decoder(_np_sd(dec))
    apply = jax.jit(lambda p, f: FlaxDecoder(scales=(0, 1, 2, 3)).apply(
        {"params": p}, f, pre_disp=pre_disp))  # one compile, not one per op
    want = apply(params, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = dec([_nchw(f) for f in feats], pre_disp=pre_disp)
    assert sorted(got) == sorted(want) == [f"disp/{s}" for s in range(4)]
    for k in want:
        assert got[k].shape[1] == (DEC_CH[int(k[-1])] if pre_disp else 1)
        _close(got[k], want[k], 1e-5, k)


@pytest.mark.parametrize("kernel", [False, True])
def test_conv_gru_cell(kernel):
    rng = np.random.RandomState(2)
    cx, hid = 12, 8
    x, h = _rand(rng, 2, 16, 24, cx), _rand(rng, 2, 16, 24, hid)
    cell = ConvGRUCell(cx, hid)
    init_weights_(cell, _gen(3))
    tree = convert_gru_blocks(_np_sd(cell, "cgru_0.cgru_1."))["cgru_0"]["cell"]
    want = FlaxCell(hid).apply({"params": tree}, jnp.asarray(x), jnp.asarray(h))
    with torch.no_grad():
        got = cell(_nchw(x), _nchw(h), kernel=kernel)
    _close(got, want, 1e-5)


def test_residual_conv_unit():
    rng = np.random.RandomState(3)
    x = _rand(rng, 2, 16, 24, 8)
    rcu = ResidualConvUnit(8)
    init_weights_(rcu, _gen(4))
    tree = convert_gru_blocks(_np_sd(rcu, "fusion_0.resConfUnit1."))
    want = FlaxRCU(8).apply({"params": tree["fusion_0"]["resConfUnit1"]},
                            jnp.asarray(x))
    with torch.no_grad():
        plain, kern = rcu(_nchw(x)), rcu(_nchw(x), kernel=True)
    _close(plain, want, 1e-5)
    _close(kern, want, 1e-5)


@pytest.mark.parametrize("up", [True, False])
def test_gru_fusion_block_v2(up):
    rng = np.random.RandomState(4)
    a, b = _rand(rng, 2, 16, 24, 8), _rand(rng, 2, 16, 24, 8)
    block = GRUFusionBlock_v2(8, up=up)
    init_weights_(block, _gen(5))
    tree = convert_gru_blocks(_np_sd(block, "fusion_1."))["fusion_1"]
    want = FlaxFusion(8, up=up, attention=False).apply(
        {"params": tree}, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got = block(_nchw(a), _nchw(b), kernel=True)
    if up:
        _close(got[0], want[0], 1e-5, "disp")
        assert got[1].shape == (2, 2, 32, 48)  # PixelShuffle(2) of 8 channels
        _close(got[1], want[1], 1e-5, "up")
    else:
        _close(got, want, 1e-5, "disp")


def _v10_block():
    block = make_gru("v10", H, W)
    init_weights_(block, _gen(6))
    g = _gen(7)
    for s in range(4):  # non-zero h0, so the initial state is checked too
        sample_(block.unit(s).h0_layer1, g, lambda t: t.normal_(0, 0.5, generator=g))
    return block


def _nhwc_hidden(h, planar):
    """JAX hidden state -> NHWC numpy (planar carries are (B, H, C, wp))."""
    h = np.asarray(h)
    return h.transpose(0, 1, 3, 2) if planar else h


@pytest.mark.parametrize("planar", [False, True])
def test_conv_gru_blocks_v10_step(monkeypatch, planar):
    """One v10 step against the JAX block: its NHWC XLA path, and its
    planar path through the Pallas kernel in interpret mode."""
    monkeypatch.setenv("SSDE_PLANAR_GRU", "1" if planar else "0")
    if planar:
        monkeypatch.setenv("SSDE_CONV_INTERPRET", "1")
    rng = np.random.RandomState(5)
    B = 2
    dec = {f"disp/{s}": _rand(rng, B, H >> s, W >> s, c) for s, c in enumerate(DEC_CH)}
    block = _v10_block()
    jblock = flax_make_gru("v10", H, W)
    variables = {"params": convert_gru_blocks(_np_sd(block))}
    h0 = jblock.apply(variables, B, method=FlaxBlocks.initial_state)
    new, disp = jblock.apply(variables, {k: jnp.asarray(v) for k, v in dec.items()}, h0)
    cfg = jblock.apply(variables, method=lambda m: m.planar_cfg)
    assert any(c[0] for c in cfg) == planar

    with torch.no_grad():
        ph0 = block.initial_state(B)
        pnew, pdisp = block({k: _nchw(v) for k, v in dec.items()}, ph0)
    for s in range(4):
        _close(ph0[s], _nhwc_hidden(h0[s], cfg[s][0])[:, :, :W >> s], 0, f"h0 {s}")
        _close(pnew[s], _nhwc_hidden(new[s], cfg[s][0])[:, :, :W >> s], 3e-5, f"h {s}")
        _close(pdisp[f"disp/{s}"], disp[f"disp/{s}"], 3e-5, f"disp/{s}")
