"""Weights carried between the port and the JAX package, and the port's copy
of the synthetic data generator.

``ssde_tpu.checkpoint.convert_*`` applied to a port ``state_dict`` must give
the flax tree of the JAX module exactly (every key, shape and dtype), and
``ssde_tpu_torch.checkpoint.*_from_flax`` must bring it back bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssde_tpu.checkpoint import (convert_depth_decoder, convert_gru_blocks,
                                 convert_resnet_encoder)
from ssde_tpu.data.synthetic import SyntheticSeqDataset as JaxSeqDataset
from ssde_tpu.models import ResnetEncoder as FlaxEncoder
from ssde_tpu.models.depth_decoder import DepthDecoder as FlaxDecoder
from ssde_tpu.models.recurrent import make_gru as flax_make_gru
from ssde_tpu_torch import checkpoint as ckpt
from ssde_tpu_torch.data.synthetic import SyntheticSeqDataset, scene_frames
from ssde_tpu_torch.models import DepthDecoder, ResnetEncoder, make_gru
from ssde_tpu_torch.models.common import init_weights_
from ssde_tpu_torch.models.resnet import randomize_bn_stats_
from ssde_tpu_torch.train.steps_gru import GRUModels

H, W = 32, 64
NUM_CH_ENC = [64, 64, 128, 256, 512]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _np_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: (tuple(a.shape), np.dtype(a.dtype)), tree)


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _encoder():
    enc = ResnetEncoder(18)
    enc.init_weights_(_gen(0))
    randomize_bn_stats_(enc, _gen(1))
    return enc


def _decoder():
    dec = DepthDecoder(NUM_CH_ENC)
    init_weights_(dec, _gen(2))
    return dec


def _gru():
    gru = make_gru("v10", H, W)
    init_weights_(gru, _gen(3))
    with torch.no_grad():
        for s in range(4):
            gru.unit(s).h0_layer1.normal_(generator=_gen(10 + s))
    return gru


def _flax_decoder_shapes(pre_disp):
    feats = [jnp.zeros((1, H >> i, W >> i, c)) for i, c in enumerate(NUM_CH_ENC)]
    init = lambda: FlaxDecoder(scales=(0, 1, 2, 3)).init(
        jax.random.PRNGKey(0), feats, pre_disp=pre_disp)
    return _shapes(jax.eval_shape(init)["params"])


def test_encoder_round_trip():
    enc = _encoder()
    params, stats, meta = convert_resnet_encoder(_np_sd(enc))
    want = jax.eval_shape(lambda: FlaxEncoder(18).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), True))
    assert _shapes(params) == _shapes(want["params"])
    assert _shapes(stats) == _shapes(want["batch_stats"])
    assert meta == {}
    _assert_same_state(ckpt.encoder_from_flax(params, stats), enc.state_dict())


def test_depth_decoder_round_trip():
    dec = _decoder()
    params = convert_depth_decoder(_np_sd(dec))
    assert _shapes(params) == _flax_decoder_shapes(pre_disp=False)
    _assert_same_state(ckpt.depth_from_flax(params), dec.state_dict())


def test_depth_decoder_pre_disp_tree_has_no_dispconv():
    """The JAX GRU trainer builds its decoder with pre_disp=True, whose tree
    has no dispconv_* entries: the converter and loader accept that and
    leave the port's own dispconv weights in place."""
    dec = _decoder()
    full = convert_depth_decoder(_np_sd(dec))
    pre = {k: v for k, v in full.items() if not k.startswith("dispconv")}
    assert _shapes(pre) == _flax_decoder_shapes(pre_disp=True)
    other = DepthDecoder(NUM_CH_ENC)
    init_weights_(other, _gen(9))
    before = {k: v.clone() for k, v in other.state_dict().items()}
    ckpt.load_depth(other, ckpt.depth_from_flax(pre))
    for k, v in other.state_dict().items():
        is_dispconv = int(k.split(".")[1]) >= 10  # decoder.10..13
        assert torch.equal(v, before[k] if is_dispconv else dec.state_dict()[k]), k
    with pytest.raises(KeyError):
        ckpt.load_depth(other, {"decoder.0.bogus": torch.zeros(1)})


def test_gru_round_trip():
    gru = _gru()
    params = convert_gru_blocks(_np_sd(gru))
    dec = {f"disp/{s}": jnp.zeros((1, H >> s, W >> s, c))
           for s, c in enumerate((16, 32, 64, 128))}
    hid = [jnp.zeros((1, H >> s, W >> s, c)) for s, c in enumerate((32, 64, 128, 256))]
    want = jax.eval_shape(lambda: flax_make_gru("v10", H, W).init(
        jax.random.PRNGKey(0), dec, hid))
    assert _shapes(params) == _shapes(want["params"])
    np.testing.assert_array_equal(
        params["cgru_1"]["h0"], gru.cgru_1.h0_layer1.detach().numpy().transpose(0, 2, 3, 1))
    _assert_same_state(ckpt.gru_from_flax(params), gru.state_dict())


def test_load_reference_folder(tmp_path):
    """A reference-format folder ({encoder,depth,gru}.pth, the encoder with
    its embedded height/width/use_stereo and classifier) loads strictly."""
    enc, dec, gru = _encoder(), _decoder(), _gru()
    enc_sd = dict(enc.state_dict())
    enc_sd.update(height=torch.tensor(H), width=torch.tensor(W),
                  use_stereo=torch.tensor(False))
    enc_sd["encoder.fc.weight"] = torch.zeros(1000, 512)
    enc_sd["encoder.fc.bias"] = torch.zeros(1000)
    torch.save(enc_sd, tmp_path / "encoder.pth")
    torch.save(dec.state_dict(), tmp_path / "depth.pth")
    torch.save(gru.state_dict(), tmp_path / "gru.pth")

    fresh = GRUModels(ResnetEncoder(18), DepthDecoder(NUM_CH_ENC),
                      make_gru("v10", H, W), None, None)
    meta = ckpt.load_reference_folder(str(tmp_path), fresh)
    assert meta == {"height": H, "width": W, "use_stereo": 0}
    for got, want in ((fresh.encoder, enc), (fresh.depth, dec), (fresh.gru, gru)):
        _assert_same_state(got.state_dict(), want.state_dict())


@pytest.mark.parametrize("hw", [(64, 128), (192, 640)])
def test_synthetic_frames_bit_identical(hw):
    h, w = hw
    ours, theirs = SyntheticSeqDataset(h, w, n=3, length=4), JaxSeqDataset(h, w, n=3, length=4)
    for i in range(4):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (i, k)
    frames = scene_frames(h, w, 3, batch=2)
    assert np.array_equal(frames[1][1], theirs[1]["color/0"][1])
