"""The port's DPT-hybrid against the JAX package's, on the CPU.

The JAX ``DPTDepthModel`` has fixed widths (768-d tokens, 12 heads, 12
blocks, 256 features), so it runs at full width and a tiny size: 64x96, a
4x6 token grid, as tests/test_dpt.py does. Its ``init`` costs ~30 s on
the CPU, so the tree comes from ``jax.eval_shape`` and is filled with
seeded numpy values (kernels N(0, 1/fan_in), norm scales near 1, BatchNorm
variances in [0.5, 1.5)), carried into the port by ``dpt_from_flax``.

* The forward of ``disp/0``, ``inv_depth`` and the four attention maps:
  float32 in eval mode (BatchNorm from the running statistics) within 1e-4
  of each output's max, float64 in train mode (batch statistics; flax's
  two-pass batch variance) within 1e-6.
* In that float64 run, the gradient of sum(disp * r) + sum(inv_depth * s)
  + the attention maps weighted likewise, with respect to every parameter,
  within 1e-6 of each tensor's max; a tensor that is 0 in JAX is 0 in the
  port, and so are, on both sides, the rows of ``pos_embed`` that the
  resize to the token grid never samples.
* ``get_mean_attention_map`` against the JAX function: on the same maps
  within 1e-6 relative (a mean over 12 heads in another order), on each
  side's own float32 maps within 1e-6 absolute.
* ``visualize_attention`` writes its panel, and without matplotlib raises
  ``ImportError``.

``dpt_loss_fn`` is held to the JAX step in tests/test_torch_dpt_step.py.
"""

import builtins
import functools

import flax.linen
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssde_tpu.models.dpt import DPTDepthModel as FlaxDPT
from ssde_tpu.models.dpt import get_mean_attention_map as jax_mean_attention_map
from ssde_tpu_torch.checkpoint import dpt_from_flax
from ssde_tpu_torch.models.dpt import DPTDepthModel, get_mean_attention_map
from ssde_tpu_torch.viz import visualize_attention

H, W = 64, 96
ATTN = ("attn_1", "attn_2", "attn_3", "attn_4")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as in tests/test_torch_mono_step.py (which says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64`` (as in
    tests/test_torch_gru_step.py)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _np(t):
    return t.detach().numpy().copy()


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _close(got, want, tol, what):
    """Each tensor within ``tol`` of its max; a tensor that is 0 in JAX is 0
    in the port."""
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, f"{what}{k}"
        if not w.any():
            assert not g.any(), f"{what}{k}: 0 in JAX, not in the port"
        np.testing.assert_allclose(g, w, atol=tol * np.abs(w).max(), rtol=0,
                                   err_msg=f"{what}{k}")


@pytest.fixture(scope="module")
def tree():
    """The JAX DPT's (params, batch_stats), float64 numpy, from eval_shape."""
    shapes = jax.eval_shape(lambda: FlaxDPT().init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, H, W, 3)), True))
    rs = np.random.RandomState(0)

    def fill(path, s):
        name, shape = jax.tree_util.keystr(path), s.shape
        if name.endswith("['var']"):
            return rs.uniform(0.5, 1.5, shape)
        if name.endswith("['scale']"):
            return 1 + 0.1 * rs.randn(*shape)
        if name.endswith("['kernel']"):
            return rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        return 0.05 * rs.randn(*shape)  # biases, BN means, cls_token, pos_embed

    # float32 values: the port's state_dict holds float32, which a float64
    # run then widens
    v = jax.tree_util.tree_map_with_path(
        lambda p, s: fill(p, s).astype(np.float32).astype(np.float64), shapes)
    return v["params"], v["batch_stats"]


def _in_port_layout(params, stats, monkeypatch):
    """A JAX DPT tree in the port's keys and layout, float64 kept (the
    converter's float32 cast read as float64), as numpy."""
    import ssde_tpu_torch.checkpoint

    monkeypatch.setattr(ssde_tpu_torch.checkpoint, "_t",
                        lambda a: torch.from_numpy(np.array(a, dtype=np.float64)))
    sd = dpt_from_flax(params, stats)
    monkeypatch.undo()
    return {k: v.numpy() for k, v in sd.items()}


def _port(tree, dtype):
    model = DPTDepthModel()
    model.load_state_dict(dpt_from_flax(*tree))
    return model.to(dtype)


@pytest.fixture(scope="module")
def forward32(tree):
    """The float32 eval-mode outputs of both: (port's, JAX's, input)."""
    x = np.random.RandomState(1).rand(2, H, W, 3)
    v = {"params": tree[0], "batch_stats": tree[1]}
    v32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), v)
    xj = jnp.asarray(x, jnp.float32)
    want = jax.jit(lambda v, x: FlaxDPT().apply(v, x, False, capture_attention=True))(v32, xj)
    model = _port(tree, torch.float32).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).float(),
                    capture_attention=True)
    return got, jax.tree.map(np.asarray, want), x


def _outputs(got, want):
    """{name: (port's, JAX's)} in JAX's layout."""
    pairs = {"disp/0": (_np(got["disp/0"]).transpose(0, 2, 3, 1), want["disp/0"]),
             "inv_depth": (_np(got["inv_depth"]), want["inv_depth"])}
    pairs.update({k: (_np(got["attention"][k]), want["attention"][k]) for k in ATTN})
    return pairs


def test_forward_matches_jax_in_float32(forward32):
    got, want, _ = forward32
    assert got["disp/0"].shape == (2, 1, H, W) and got["inv_depth"].shape == (2, H, W)
    for k, (g, w) in _outputs(got, want).items():
        assert g.dtype == np.float32 and g.shape == w.shape, k
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=k)
    for k in ATTN:
        assert want["attention"][k].shape == (2, 12, 25, 25)
        np.testing.assert_allclose(_np(got["attention"][k]).sum(-1), 1.0, atol=1e-5)


def test_mean_attention_map_matches_jax(forward32):
    got, want, _ = forward32
    for k in ATTN:
        for token in (1, 0, -1, 7):
            m = get_mean_attention_map(got["attention"][k], token, (H // 16, W // 16))
            w = np.asarray(jax_mean_attention_map(want["attention"][k], token,
                                                  (H // 16, W // 16)))
            assert m.shape == (2, H // 16, W // 16)
            np.testing.assert_allclose(_np(m), w, atol=1e-6, rtol=0, err_msg=f"{k} {token}")
            m = get_mean_attention_map(torch.from_numpy(want["attention"][k].copy()), token,
                                       (H // 16, W // 16))
            np.testing.assert_allclose(_np(m), w, rtol=1e-6, atol=0, err_msg=f"{k} {token}")


def test_forward_and_gradients_match_jax_in_float64(tree, monkeypatch):
    """In train mode, float64: the outputs within 1e-6 of each one's max and
    the gradient of every parameter within 1e-6 of its max."""
    import ssde_tpu.models.dpt
    import ssde_tpu.ops.image

    rs = np.random.RandomState(2)
    x = rs.rand(2, H, W, 3)
    r = {"disp/0": rs.randn(2, H, W, 1), "inv_depth": rs.randn(2, H, W),
         **{k: rs.randn(2, 12, 25, 25) for k in ATTN}}
    monkeypatch.setattr(flax.linen, "BatchNorm",
                        functools.partial(flax.linen.BatchNorm, use_fast_variance=False))
    for mod in (ssde_tpu.models.dpt, ssde_tpu.ops.image):
        monkeypatch.setattr(mod, "jnp", _Float64Numpy())
    with jax.enable_x64(True):
        dpt = FlaxDPT()

        def loss(p, s, x):
            out, _ = dpt.apply({"params": p, "batch_stats": s}, x, True,
                               capture_attention=True, mutable=["batch_stats"])
            return ((out["disp/0"] * r["disp/0"]).sum() + (out["inv_depth"] * r["inv_depth"]).sum()
                    + sum((out["attention"][k] * r[k]).sum() for k in ATTN)), out

        params, stats = jax.tree.map(jnp.asarray, tree)
        (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params, stats, jnp.asarray(x))
        want, jgrads = jax.tree.map(np.asarray, (want, jgrads))
    monkeypatch.undo()

    model = _port(tree, torch.float64).train()
    out = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), capture_attention=True)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    ((out["disp/0"] * t(r["disp/0"].transpose(0, 3, 1, 2).copy())).sum()
     + (out["inv_depth"] * t(r["inv_depth"])).sum()
     + sum((out["attention"][k] * t(r[k])).sum() for k in ATTN)).backward()
    for k, (g, w) in _outputs(out, want).items():
        assert g.dtype == np.float64, k
        np.testing.assert_allclose(g, w, atol=1e-6 * np.abs(w).max(), rtol=0, err_msg=k)
    got = {k: _np(p.grad) for k, p in model.named_parameters()}
    want = _in_port_layout(jgrads, tree[1], monkeypatch)
    _close(got, {k: want[k] for k in got}, 1e-6, "")
    # the rows of pos_embed no token samples: 24 -> 4 rows and 24 -> 6
    # columns read source rows {2, 3, 8, 9, 14, 15, 20, 21} and columns
    # {1, 2, 5, 6, 9, 10, 13, 14, 17, 18, 21, 22}; the rest have no gradient
    rows, cols = [2, 3, 8, 9, 14, 15, 20, 21], [1, 2, 5, 6, 9, 10, 13, 14, 17, 18, 21, 22]
    dead = np.ones((24, 24), bool)
    dead[np.ix_(rows, cols)] = False
    for side in (want, got):
        pos = side["pos_embed"][0, 1:].reshape(24, 24, 768)
        assert np.all(pos[dead] == 0) and np.all(np.abs(pos[~dead]).max(-1) > 0)


# ---------------------------------------------------------------- viz

def test_visualize_attention_writes_its_panel(forward32, tmp_path):
    pytest.importorskip("matplotlib")
    got, _, x = forward32
    path = tmp_path / "attention.png"
    visualize_attention(x[0].transpose(2, 0, 1), got["attention"], got["inv_depth"][0],
                        (H // 16, W // 16), save_path=str(path))
    assert path.stat().st_size > 0


def test_visualize_attention_without_matplotlib_raises(forward32, monkeypatch, tmp_path):
    """The GPU machine has no matplotlib: the panel raises ImportError,
    naming it, and writes nothing."""
    real = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(f"No module named {name!r}")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    got, _, x = forward32
    with pytest.raises(ImportError, match="matplotlib"):
        visualize_attention(x[0].transpose(2, 0, 1), got["attention"], got["inv_depth"][0],
                            (H // 16, W // 16), save_path=str(tmp_path / "attention.png"))
    assert not (tmp_path / "attention.png").exists()
