"""The port's attention encoders against the JAX package's, on the CPU.

* ``AttentionConv(k=7, groups=8)``, ``ResnetEncoderAttention`` (ResNet18)
  and ``AttentionResNet18`` at 64x96, B=2: the JAX module's tree from
  ``jax.eval_shape``, filled with seeded float32 values (kernels
  N(0, 1/fan_in), BatchNorm variances in [0.5, 1.5)), carried into the
  port by ``attention_encoder_from_flax``. In train mode (batch
  statistics; flax's two-pass batch variance) the outputs in float32
  within 1e-4 of each map's max (AttentionResNet18's last map, after 8
  attention blocks and 26 batch normalisations over 2 images, is 3.2e-5
  off), and in float64 the outputs within 1e-9
  and the gradient of sum(out * r) over every output with respect to
  every parameter and the input within 1e-6 of each tensor's max (an
  attention conv's key weight, whose true gradient through a window
  softmax is tiny, within 1e-6 of its conv's largest). ``groups`` is
  stored as the JAX module has it and changes nothing.

JAX's 7x7 attention runs its streaming path (the Pallas kernel takes 3x3
windows only), as the port's does. The mono loss with this encoder is held
to the JAX step in tests/test_torch_attention_encoder_step.py.
"""

import functools

import flax.linen
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssde_tpu.models.attention import AttentionConv as FlaxAttentionConv
from ssde_tpu.models.attention_resnet import AttentionResNet18 as FlaxAttentionResNet18
from ssde_tpu.models.attention_resnet import ResnetEncoderAttention as FlaxEncoderAttention
from ssde_tpu_torch.checkpoint import attention_encoder_from_flax
from ssde_tpu_torch.models import (AttentionConv, AttentionResNet, AttentionResNet18,
                                   AttentionResNet26, AttentionResNet38, AttentionResNet50,
                                   ResnetEncoderAttention)

H, W, B = 64, 96, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as in tests/test_torch_mono_step.py (which says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_plain_paths(monkeypatch):
    """The JAX modules on their plain CPU paths."""
    for env in ("SSDE_CONV_INTERPRET", "SSDE_ATTN_KERNEL"):
        monkeypatch.delenv(env, raising=False)


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64`` (as in
    tests/test_torch_gru_step.py)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _compile(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` without XLA's fusion pass: the
    gradient of a 7x7 window's 49 shifted views fuses into loops whose CPU
    compile takes minutes an encoder; unfused, the same arithmetic compiles
    in a fraction of that and still runs in seconds."""
    return jax.jit(fn).lower(*args).compile({"xla_disable_hlo_passes": "fusion"})


def _np(t):
    return t.detach().numpy().copy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return _np(t).transpose(0, 2, 3, 1)


def _filled(module, x, seed, stateful=True):
    """``module``'s (params, batch_stats) from eval_shape, filled with seeded
    float32 values held as float64."""
    args = (jnp.asarray(x), True) if stateful else (jnp.asarray(x),)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rs = np.random.RandomState(seed)

    def fill(path, s):
        name, shape = jax.tree_util.keystr(path), s.shape
        if name.endswith("['var']"):
            v = rs.uniform(0.5, 1.5, shape)
        elif name.endswith("['scale']"):
            v = 1 + 0.1 * rs.randn(*shape)
        elif name.endswith("['kernel']"):
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith(("['rel_h']", "['rel_w']")):
            v = rs.randn(*shape)  # the init's N(0, 1)
        else:
            v = 0.05 * rs.randn(*shape)
        return v.astype(np.float32).astype(np.float64)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return v["params"], v.get("batch_stats", {})


def _in_port_layout(params, stats, monkeypatch):
    """A JAX tree in the port's keys and layout, float64 kept, as numpy."""
    import ssde_tpu_torch.checkpoint

    monkeypatch.setattr(ssde_tpu_torch.checkpoint, "_t",
                        lambda a: torch.from_numpy(np.array(a, dtype=np.float64)))
    sd = attention_encoder_from_flax(params, stats)
    monkeypatch.undo()
    return {k: v.numpy() for k, v in sd.items()}


def _close(got, want, tol, what):
    """Each tensor within ``tol`` of its max, an attention conv's key
    weight within ``tol`` of its conv's largest (its true gradient is a
    small difference of large terms)."""
    assert got.keys() == want.keys(), what
    conv_max = {}
    for k, w in want.items():
        if ".key_conv." in k or ".query_conv." in k or ".value_conv." in k:
            c = k.rsplit(".", 2)[0]
            conv_max[c] = max(conv_max.get(c, 0.0), np.abs(w).max())
    for k, w in want.items():
        scale = conv_max[k.rsplit(".", 2)[0]] if ".key_conv." in k else np.abs(w).max()
        assert scale > 0, f"{what}{k}"
        np.testing.assert_allclose(got[k], w, atol=tol * scale, rtol=0, err_msg=f"{what}{k}")


MODULES = {
    "attention_conv": (lambda: FlaxAttentionConv(32, 7, groups=8),
                       lambda: AttentionConv(16, 32, 7, groups=8), 16, False),
    "resnet_encoder_attention": (lambda: FlaxEncoderAttention(18),
                                 lambda: ResnetEncoderAttention(18), 3, True),
    "attention_resnet18": (lambda: FlaxAttentionResNet18(), lambda: AttentionResNet18(), 3,
                           True),
}


def _apply(module, p, s, x, stateful):
    if not stateful:
        return module.apply({"params": p}, x)
    return module.apply({"params": p, "batch_stats": s}, x, True, mutable=["batch_stats"])[0]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name, monkeypatch):
    import ssde_tpu.models.attention

    make_jax, make_port, cin, stateful = MODULES[name]
    rs = np.random.RandomState(11)
    x = rs.rand(B, H, W, cin).astype(np.float32).astype(np.float64)
    jmod = make_jax()
    params, stats = _filled(jmod, x, 12, stateful)
    assert jmod.groups == 8 if name == "attention_conv" else True
    port = make_port()
    port.load_state_dict(attention_encoder_from_flax(params, stats))
    port.train()
    assert all(m.groups == 8 for m in port.modules() if isinstance(m, AttentionConv))

    monkeypatch.setattr(flax.linen, "BatchNorm",
                        functools.partial(flax.linen.BatchNorm, use_fast_variance=False))
    # float32: JAX's 32-bit run against the port's
    j32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), (params, stats))
    want32 = jax.jit(lambda p, s, x: _apply(jmod, p, s, x, stateful))(
        *j32, jnp.asarray(x, jnp.float32))
    want32 = [np.asarray(w) for w in (want32 if isinstance(want32, list) else [want32])]
    with torch.no_grad():
        got32 = port(_nchw(x).float())
    got32 = got32 if isinstance(got32, list) else [got32]
    assert len(got32) == len(want32) == (1 if name == "attention_conv" else 5)
    for i, (g, w) in enumerate(zip(got32, want32)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_nhwc(g), w, atol=1e-4 * np.abs(w).max(), rtol=0,
                                   err_msg=f"float32 output {i}")

    # float64: outputs and every gradient
    port = port.double()
    r = [rs.randn(*w.shape) for w in want32]
    xt = _nchw(x).requires_grad_()
    out = port(xt)
    out = out if isinstance(out, list) else [out]
    sum((o * _nchw(ri)).sum() for o, ri in zip(out, r)).backward()

    monkeypatch.setattr(ssde_tpu.models.attention, "jnp", _Float64Numpy())
    with jax.enable_x64(True):
        def loss(p, xx):
            y = _apply(jmod, p, stats, xx, stateful)
            y = y if isinstance(y, list) else [y]
            return sum(jnp.sum(a * ri) for a, ri in zip(y, r)), y

        args = (jax.tree.map(jnp.asarray, params), jnp.asarray(x))
        (_, want), (jgp, jgx) = _compile(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
                                         *args)(*args)
        want, jgp, jgx = jax.tree.map(np.asarray, (want, jgp, jgx))
    for i, (g, w) in enumerate(zip(out, want)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(_nhwc(g), w, atol=1e-9 * np.abs(w).max(), rtol=0,
                                   err_msg=f"float64 output {i}")
    got = {k: _np(p.grad) for k, p in port.named_parameters()}
    _close(got, {k: v for k, v in _in_port_layout(jgp, stats, monkeypatch).items()
                 if k in got}, 1e-6, "")
    np.testing.assert_allclose(_nhwc(xt.grad), jgx, atol=1e-6 * np.abs(jgx).max(), rtol=0)


def test_attention_resnet_presets():
    """The presets' blocks per stage, as the JAX functions give them; the
    stride of a stage's first block is an avg-pool after it."""
    for make, blocks in ((AttentionResNet18, (2, 2, 2, 2)), (AttentionResNet26, (1, 2, 4, 1)),
                         (AttentionResNet38, (2, 3, 5, 2)), (AttentionResNet50, (3, 4, 6, 3))):
        m = make()
        assert isinstance(m, AttentionResNet) and m.num_blocks == blocks
        assert [getattr(m, f"layer{s + 1}_0").stride for s in range(4)] == [1, 2, 2, 2]
    feats = AttentionResNet((1, 1, 1, 1)).eval()(torch.rand(1, 3, 64, 96))
    assert [tuple(f.shape[1:]) for f in feats] == [(64, 32, 48), (64, 16, 24), (128, 8, 12),
                                                   (256, 4, 6), (512, 2, 3)]
