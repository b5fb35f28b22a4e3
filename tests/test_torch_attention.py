"""The port's windowed attention against the JAX package.

* ``attend3`` (its CPU path: the plain version under autograd) against the
  Pallas ``attend3`` in interpret mode, forward and the gradients of all
  four operands, at the cases of tests/test_attention_win.py (planar
  (B, H, C, W) there, transposed to NCHW here). Bounds as that file's:
  2e-5 forward, 2e-4 gradients.
* ``AttentionConv`` (per-channel and shared rel, bias on and off, both of
  its paths, a 1-row map), ``ResidualAttentionUnit`` and ``AttentionStem``
  against the flax modules on the port's weights converted by the JAX
  package's own ``_convert_attention_conv``: forward 2e-5 absolute on O(1)
  outputs; every gradient 2e-5 of the largest gradient of its module
  (float32 sums in another order; the key bias's true gradient is 0, since
  it shifts all 9 logits of a pixel alike, so only rounding is compared
  there). The flax module runs its streaming path, or its Pallas kernel
  path in interpret mode for the port's kernel path.
* The ``.pth`` round trip of a v9 block: the port's ``state_dict`` ->
  ``ssde_tpu.checkpoint.convert_gru_blocks`` -> the flax tree, and back
  through the port's ``gru_from_flax``, bit-identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssde_tpu.checkpoint import _convert_attention_conv, convert_gru_blocks
from ssde_tpu.models.attention import AttentionConv as FlaxAttentionConv
from ssde_tpu.models.attention import AttentionStem as FlaxStem
from ssde_tpu.models.attention import ResidualAttentionUnit as FlaxRAU
from ssde_tpu.models.recurrent import make_gru as flax_make_gru
from ssde_tpu.ops.pallas.attention_win import attend3 as pallas_attend3
from ssde_tpu_torch.checkpoint import gru_from_flax
from ssde_tpu_torch.models import make_gru
from ssde_tpu_torch.models.attention import AttentionConv, AttentionStem, ResidualAttentionUnit
from ssde_tpu_torch.models.common import init_weights_
from ssde_tpu_torch.ops.attention_win import (attend3, attend3_bwd, attend3_fwd,
                                              attend3_reference)

FWD_TOL, GRAD_TOL, MODULE_TOL = 2e-5, 2e-4, 2e-5


def _np(t):
    return t.detach().numpy().copy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return _np(t).transpose(0, 2, 3, 1)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# ----------------------------------------------------------------- attend3


@pytest.mark.parametrize("B,H,C,W", [(2, 6, 8, 126), (1, 5, 16, 40)])
def test_attend3_matches_pallas(B, H, C, W):
    rng = np.random.RandomState(0)
    q = rng.randn(B, H, C, W).astype(np.float32)
    kp = rng.randn(B, H + 2, C, W + 2).astype(np.float32)
    vp = rng.randn(B, H + 2, C, W + 2).astype(np.float32)
    rel = (rng.randn(9, C) * 0.3).astype(np.float32)
    g = rng.randn(B, H, C, W).astype(np.float32)

    planar = [jnp.asarray(a) for a in (q, kp, vp, rel)]
    want = pallas_attend3(*planar, interpret=True)
    jgrads = jax.grad(lambda a: jnp.sum(pallas_attend3(*a, interpret=True) * g))(planar)

    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))  # noqa
    ops = [nchw(q), nchw(kp), nchw(vp), torch.from_numpy(rel)]
    ops = [t.requires_grad_() for t in ops]
    got = attend3(*ops)
    (got * nchw(g)).sum().backward()
    np.testing.assert_allclose(_np(got).transpose(0, 2, 1, 3), np.asarray(want),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for name, t, w in zip(("dq", "dkp", "dvp", "drel"), ops, jgrads):
        a = _np(t.grad) if name == "drel" else _np(t.grad).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(a, np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_attend3_reference_is_the_window_softmax_in_float64():
    """The plain version against a float64 softmax over stacked windows
    (torch.softmax, no max subtraction by hand), with logits up to ~30."""
    g = torch.Generator().manual_seed(1)
    B, C, H, W = 2, 3, 4, 5
    q = torch.randn(B, C, H, W, generator=g, dtype=torch.float64) * 3
    kp = torch.randn(B, C, H + 2, W + 2, generator=g, dtype=torch.float64) * 3
    vp = torch.randn(B, C, H + 2, W + 2, generator=g, dtype=torch.float64)
    rel = torch.randn(9, C, generator=g, dtype=torch.float64)
    taps = [(kh, kw) for kh in range(3) for kw in range(3)]
    logits = torch.stack([q * (kp[:, :, kh:kh + H, kw:kw + W] + rel[i].view(1, C, 1, 1))
                          for i, (kh, kw) in enumerate(taps)])
    vals = torch.stack([vp[:, :, kh:kh + H, kw:kw + W] for kh, kw in taps])
    want = (torch.softmax(logits, 0) * vals).sum(0)
    torch.testing.assert_close(attend3_reference(q, kp, vp, rel), want, atol=1e-12, rtol=0)
    # float32 and bf16 operands compute in float32 and return their dtype
    for dt in (torch.float32, torch.bfloat16):
        out = attend3_reference(q.to(dt), kp.to(dt), vp.to(dt), rel.float())
        assert out.dtype == dt


def test_attend3_checks_its_operands():
    """What the kernels refuse is refused on the CPU too; the CPU path
    launches nothing, and the kernel wrappers have no CPU path."""
    q, kp, vp = torch.randn(1, 4, 3, 5), torch.randn(1, 4, 5, 7), torch.randn(1, 4, 5, 7)
    rel = torch.randn(9, 4)
    before = (attend3_fwd.launches, attend3_bwd.launches)
    attend3(q, kp, vp, rel)
    attend3(q.double(), kp.double(), vp.double(), rel.double())  # reference runs
    with pytest.raises(ValueError, match="kp and vp"):
        attend3(q, kp[:, :, :4], vp, rel)
    with pytest.raises(ValueError, match="rel"):
        attend3(q, kp, vp, rel[:8])
    with pytest.raises(TypeError, match="rel"):
        attend3(q, kp, vp, rel.bfloat16())
    with pytest.raises(TypeError):
        attend3(q.half(), kp.half(), vp.half(), rel)
    with pytest.raises(TypeError):
        attend3(q, kp.double(), vp, rel)
    with pytest.raises(ValueError, match="contiguous"):
        attend3(q.transpose(2, 3).contiguous().transpose(2, 3), kp, vp, rel)
    for fn, args in ((attend3_fwd, (q, kp, vp, rel)), (attend3_bwd, (q, kp, vp, rel, q))):
        with pytest.raises(ValueError, match="no kernel"):
            fn(*args)
    assert (attend3_fwd.launches, attend3_bwd.launches) == before


# ------------------------------------------------------------- the modules


def _conv_tree(sd, names):
    """Reference-layout 1x1 convs -> flax nn.Conv / _ConvParams leaves."""
    out = {}
    for port, flax in names:
        out[flax] = {"kernel": sd[f"{port}.weight"].transpose(2, 3, 1, 0)}
        if f"{port}.bias" in sd:
            out[flax]["bias"] = sd[f"{port}.bias"]
    return out


def _tree(tensors, kind):
    """The port's parameters (or their gradients), by name -> the flax
    tree: the attention convs through the JAX package's converter."""
    sd = {k: _np(v) for k, v in tensors.items()}
    out = {}
    if kind == "conv":
        _convert_attention_conv({f"m.{k}": v for k, v in sd.items()}, "m", out, "m")
        return out["m"]
    if kind == "unit":
        for i in (1, 2):
            _convert_attention_conv(sd, f"atten{i}", out, f"atten{i}")
        return out
    m = sum(1 for k in sd if k.startswith("value_conv.") and k.endswith("weight"))
    out = _conv_tree(sd, [("query_conv", "query_conv"), ("key_conv", "key_conv")]
                     + [(f"value_conv.{i}", f"value_conv_{i}") for i in range(m)])
    out.update({k: sd[k] for k in ("emb_a", "emb_b", "emb_mix")})
    return out


def _hold(port, kind, flax_mod, x, monkeypatch, kernel=None):
    """The port module and the flax module on the port's weights: the
    forward, and the gradients of sum(out * r) for every parameter and
    the input. flax runs its streaming path, or its Pallas kernel path in
    interpret mode when ``kernel``."""
    params = _tree(dict(port.state_dict()), kind)
    init = flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    assert jax.tree.map(np.shape, init) == jax.tree.map(np.shape, params)
    monkeypatch.setenv("SSDE_ATTN_KERNEL", "1" if kernel else "0")
    if kernel:
        monkeypatch.setenv("SSDE_CONV_INTERPRET", "1")
    xt = _nchw(x).requires_grad_()
    out = port(xt) if kernel is None else port(xt, kernel)
    r = np.random.RandomState(9).randn(*_nhwc(out).shape).astype(np.float32)
    (out * _nchw(r)).sum().backward()

    def loss(p, xx):
        y = flax_mod.apply({"params": p}, xx)
        return jnp.sum(y * r), y

    (_, want), (jgp, jgx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), atol=FWD_TOL, rtol=0)
    got, want = _leaves(_tree({k: p.grad for k, p in port.named_parameters()}, kind)), \
        _leaves(jgp)
    assert got.keys() == want.keys()
    scale = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=MODULE_TOL * scale, rtol=0, err_msg=k)
    jgx = np.asarray(jgx)
    np.testing.assert_allclose(_nhwc(xt.grad), jgx, atol=MODULE_TOL * np.abs(jgx).max(),
                               rtol=0)


def _seeded(module, seed):
    init_weights_(torch.nn.ModuleList([module]), torch.Generator().manual_seed(seed))
    return module


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("shared_rel,use_bias,B,H,W", [
    (False, True, 2, 6, 30), (True, True, 2, 6, 30), (False, False, 2, 6, 30),
    (False, True, 1, 1, 12),  # a 1-row map: its taps above and below are the ring
])
def test_attention_conv_matches_flax(monkeypatch, kernel, shared_rel, use_bias, B, H, W):
    port = _seeded(AttentionConv(6, 8, 3, use_bias=use_bias, shared_rel=shared_rel), 3)
    x = np.random.RandomState(4).randn(B, H, W, 6).astype(np.float32)
    _hold(port, "conv", FlaxAttentionConv(8, 3, use_bias=use_bias, shared_rel=shared_rel),
          x, monkeypatch, kernel)


@pytest.mark.parametrize("kernel", [False, True])
def test_residual_attention_unit_matches_flax(monkeypatch, kernel):
    """The GRU blocks' unit: per-channel rel, biased convs, relu(x) residual."""
    port = _seeded(ResidualAttentionUnit(8, shared_rel=False), 5)
    x = np.random.RandomState(6).randn(2, 5, 9, 8).astype(np.float32)
    _hold(port, "unit", FlaxRAU(8, shared_rel=False), x, monkeypatch, kernel)


@pytest.mark.parametrize("use_bias", [False, True])
def test_attention_stem_matches_flax(monkeypatch, use_bias):
    port = _seeded(AttentionStem(5, 8, 3, groups=2, m=4, use_bias=use_bias), 7)
    x = np.random.RandomState(8).randn(2, 6, 7, 5).astype(np.float32)
    _hold(port, "stem", FlaxStem(8, 3, groups=2, m=4, use_bias=use_bias), x, monkeypatch)


def test_v9_block_pth_round_trip():
    """The port's v9 state_dict is the reference's .pth layout: the JAX
    package's converter reads it into the flax v9 tree, and the port's
    ``gru_from_flax`` gives the same state_dict back."""
    block = make_gru("v9", 16, 32)
    init_weights_(block, torch.Generator().manual_seed(2))
    sd = block.state_dict()
    params = convert_gru_blocks({k: _np(v) for k, v in sd.items()})
    dec = {f"disp/{s}": jnp.zeros((1, 16 >> s, 32 >> s, c)) for s, c in enumerate((16, 32, 64, 128))}
    jm = flax_make_gru("v9", 16, 32)
    h0 = [jnp.zeros((1, 16 >> s, 32 >> s, c)) for s, c in enumerate((32, 64, 128, 256))]
    init = jax.eval_shape(jm.init, jax.random.PRNGKey(0), dec, h0)["params"]
    assert jax.tree.map(np.shape, init) == jax.tree.map(np.shape, params)
    back = gru_from_flax(params)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert back[k].shape == v.shape and torch.equal(back[k], v), k
    assert sd["fusion_0.resConfUnit1.atten1.rel_h"].shape == (16, 1, 1, 3, 1)
    assert sd["fusion_3.resConfUnit2.atten2.rel_w"].shape == (128, 1, 1, 1, 3)
    make_gru("v9", 16, 32).load_state_dict(back)  # strict
