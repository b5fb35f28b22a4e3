"""The model axis of the port (``ssde_tpu_torch.parallel``: ``make_mesh_2d``,
``model_sharded_params``, the column-parallel layers) against the JAX
package's (``ssde_tpu/parallel/mesh.py:102-142``) and against one process,
on the CPU over gloo ranks. One launch a mesh shape, module-scoped: (2, 2)
and (1, 2).

(a) ``make_mesh_2d``'s rank order against JAX's ``make_mesh_2d(...).devices``
    on the 8 virtual devices of tests/conftest.py, by device id.
(b) The rule, leaf by leaf, at m = 2: the conv and dense kernels that JAX's
    ``model_sharded_params`` shards (spec not ``P()``) on ``jax.eval_shape``
    trees, through the converters, against the layers the port shards, for
    ResnetEncoder(18) and (50), DepthDecoder, PoseDecoder and the v10 and v1
    blocks.
    The differences are listed: the JAX rule also shards the recurrent
    units' ``h0`` (its trailing axis divides) and v1's ``conv_gates`` (2
    channels; its ``conv_can`` has 1), the port keeps both whole.
(c) tests/test_model_parallel.py's computation (ResnetEncoder(18) +
    DepthDecoder(scales=(0,)), BatchNorm in eval mode, mean(disp**2), B=2,
    32x64) on four ranks at (2, 2) against the JAX computation unsharded and
    jitted (and, ``slow``, sharded on JAX's own 2x2 mesh), at the JAX test's
    tolerances: loss rtol 1e-5, gradients atol 2e-5 and rtol 1e-3.
(d) One Adam step of the mono ``train_step`` (64x128, B=2) at (2, 2) and of
    the GRU v10 step (64x128, B=1, T=2, ``--gru_remat 1``) at (1, 2), the
    networks in float64, against the one-process step: losses, gradients,
    BatchNorm statistics and parameters after the step at 1e-9 of each
    tensor's max, every rank the same after ``unshard_params``; a model
    group's slices concatenate to the one-process parameter, and each rank's
    Adam moments cover its slices alone.
(e) The traps: the GRU and LSTM cells' split convs at m = 2 against the
    unsharded cell; every covered block version (float64; v10 also on the
    kernel route in float32) against the unsharded block, v1's width-1
    cells and a ``Cout = 1`` head left whole; BatchNorm at (1, 2)
    over the data group equal to one process (and over the world group as
    well: the doubled count cancels the doubled gradient sum);
    ``model_sharded_params`` raising for the families it does not cover.

The rank functions live here, in a module that imports no JAX at its top
(tests/test_torch_parallel.py says why).
"""

import numpy as np
import pytest
import torch

from ssde_tpu_torch import parallel
from ssde_tpu_torch.config import Options
from ssde_tpu_torch.models import DepthDecoder, Head, PoseDecoder, ResnetEncoder, make_gru
from ssde_tpu_torch.models import resnet
from ssde_tpu_torch.models.common import init_weights_, sample_
from ssde_tpu_torch.models.recurrent import ConvGRUCell, ConvLSTMCell, block_version
from ssde_tpu_torch.parallel.tensor import is_sharded
from ssde_tpu_torch.train import steps, steps_gru
from ssde_tpu_torch.train.state import TrainState
from test_torch_parallel import (_bn_run, _one_torch_thread,  # noqa: F401
                                 check_against_one_process, summary)
from test_torch_parallel_step import _batch as _mono_batch
from test_torch_parallel_step import _opts as _mono_opts

CPU = torch.device("cpu")
JAX_HW, JAX_B = (32, 64), 2
STEP_HW = (64, 128)
GRU_B, GRU_T = 1, 2
BLOCK_HW = (32, 64)
BLOCK_VERSIONS = ("v1", "v3", "v4", "v5", "v7", "v10", "v2_wo_att")
CELLS = ("gru", "lstm", "linear")
DEC_CH = (16, 32, 64, 128)
ENC_CH = (64, 64, 128, 256, 512)
REL = 1e-9  # float64 steps: each tensor's max


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _here():
    """This rank's mesh (its devices and shape)."""
    return parallel.make_mesh_2d(*parallel.mesh_shape(), parallel.current_mesh())


def _shard(modules):
    """Shard ``modules`` on a rank; nothing in one process."""
    return parallel.model_sharded_params(modules, _here()) if parallel.in_group() else []


def _rows(n):
    return parallel.shard_rows(n, parallel.data_rank(), parallel.data_world())


def _mean_over_data(tensors):
    if parallel.data_world() > 1:
        parallel.all_reduce_mean_(tensors, parallel.data_group())


# ------------------------------------------------------------- (a) mesh
@pytest.mark.parametrize("data,model", [(2, 2), (0, 2), (0, 4), (1, 8), (0, 3), (2, 1)])
def test_make_mesh_2d_places_ranks_as_jax_places_devices(data, model):
    import jax

    from ssde_tpu.parallel import make_mesh_2d as jax_make_mesh_2d

    assert len(jax.devices()) == 8
    jm = jax_make_mesh_2d(data=data, model=model)
    mesh = parallel.make_mesh_2d(data, model, [torch.device("cuda", i) for i in range(8)])
    assert mesh.shape == jm.devices.shape == tuple(jm.shape.values())
    assert tuple(jm.shape) == (parallel.DATA_AXIS, parallel.MODEL_AXIS)
    for r, device in enumerate(mesh):
        assert jm.devices[mesh.position(r)].id == device.index, r
    with pytest.raises(ValueError, match="needs"):
        parallel.make_mesh_2d(3, 3, [CPU] * 8)


# ----------------------------------------------------- the rank functions
def _rule_modules():
    """(b): the families whose rule is held to JAX's, built small."""
    h, w = BLOCK_HW
    enc = ResnetEncoder(18)
    return {"encoder": enc, "encoder50": ResnetEncoder(50),
            "depth": DepthDecoder(enc.num_ch_enc, scales=(0,)),
            "pose": PoseDecoder(enc.num_ch_enc, 1, 2),
            "gru_v10": make_gru("v10", h, w), "gru_v1": make_gru("v1", h, w)}


def _sharded_names(module):
    return sorted(f"{n}.weight" for n, m in module.named_modules() if is_sharded(m))


def jax_computation(x):
    """(c): tests/test_model_parallel.py's loss on this rank's rows of ``x``
    (NCHW float32) with its seeded weights sharded on a rank: the loss and
    the gradients of the encoder and decoder, their mean over the data
    group, gathered (rank 0 returns the gradients)."""
    enc = ResnetEncoder(18)
    enc.init_weights_(_gen(0))
    resnet.randomize_bn_stats_(enc, _gen(1))
    dec = DepthDecoder(enc.num_ch_enc, scales=(0,))
    init_weights_(dec, _gen(2))
    enc.eval(), dec.eval()
    _shard([enc, dec])
    disp = dec(enc(torch.from_numpy(x[_rows(len(x))])))["disp/0"]
    loss = (disp ** 2).mean()
    loss.backward()
    grads = {f"{g}.{n}": p for g, m in (("encoder", enc), ("depth", dec))
             for n, p in m.named_parameters()}
    _mean_over_data([loss.detach()] + [p.grad for p in grads.values()])
    if parallel.in_group():
        parallel.unshard_params([enc, dec])
    out = {"loss": float(loss.detach())}
    if parallel.rank() == 0:
        out["grads"] = {k: p.grad.clone() for k, p in grads.items()}
    return out


# the layers whose slices (d) puts together, by step
SLICE_LAYERS = {"mono": ("encoder.encoder.conv1", "depth.decoder.9.conv.conv", "pose.net.3"),
                "gru": ("gru.cgru_0.cgru_1.conv_gates", "gru.cgru_0.cgru_1.conv_can",
                        "gru.fusion_0.resConfUnit1.conv1")}


def _named_modules(models, which):
    names = (("encoder", "depth", "pose_encoder", "pose") if which == "mono" else
             ("encoder", "depth", "gru", "pose_encoder", "pose"))
    return dict(zip(names, models.modules()))


def _step_batch(which):
    if which == "mono":
        return _mono_batch()
    from ssde_tpu_torch.data.pipeline import collate
    from ssde_tpu_torch.data.synthetic import SyntheticSeqDataset

    h, w = STEP_HW
    ds = SyntheticSeqDataset(h, w, n=GRU_T, length=GRU_B)
    batch = {k: v.astype(np.float64) for k, v in collate([ds[i] for i in range(GRU_B)]).items()}
    rs = np.random.RandomState(7)
    for i in (0, -1, 1):
        batch[f"color/{i}"] = rs.rand(GRU_B, GRU_T, h, w, 3)
    batch["jitter"] = np.array([[1.1, 0.9, 1.15, 0.05]])
    return batch


def train_step(which, batch):
    """(d): one Adam step of the mono (``which`` "mono") or GRU v10 ("gru")
    step on this process's rows of ``batch``, the networks in float64,
    sharded on a rank; its summary after ``unshard_params``, and on a rank
    the slices of :data:`SLICE_LAYERS` and what its Adam moments held."""
    if which == "mono":
        models = steps.build_mono_models(_mono_opts(), "cpu", _gen(0))
        step, gen = steps.train_step, None
    else:
        h, w = STEP_HW
        opts = Options(height=h, width=w, batch_size=GRU_B, len_sequence=GRU_T,
                       gru_version="v10", compute_dtype="float32", gru_remat="1",
                       frame_ids=[0, -1, 1])
        models = steps_gru.build_gru_models(opts, "cpu", _gen(0))
        models.gru.kernel_scales = (False,) * 4  # the plain convs: conv3x3 takes no float64
        g = _gen(1)
        for p in models.h0_parameters():  # a non-zero learned initial state
            sample_(p, g, lambda t: t.normal_(0.0, 0.1, generator=g))
        step, gen = steps_gru.train_step, _gen(11)
    for m in models.modules():
        m.double()
    named = _named_modules(models, which)
    sharded = _shard(list(named.values()))
    state = TrainState(models.parameters(), 1e-4, 15, 1)
    rows = parallel.shard_batch(batch, parallel.data_rank(), parallel.data_world())
    losses = step(models, state, {k: torch.from_numpy(v) for k, v in rows.items()}, gen)
    _mean_over_data(list(losses.values()))
    sharded_ids = {id(p) for layer in sharded for p in layer.parameters()}
    params = state.optimizer.param_groups[0]["params"]
    extra = {"numel": {"sharded": sum(p.numel() for p in params if id(p) in sharded_ids),
                       "replicated": sum(p.numel() for p in params if id(p) not in sharded_ids)},
             "moments_cover_slices": all(state.optimizer.state[p][k].shape == p.shape
                                         for p in params for k in ("exp_avg", "exp_avg_sq"))}
    if parallel.in_group():
        layers = {f"{g}.{n}": m for g, mod in named.items() for n, m in mod.named_modules()}
        extra["slices"] = {k: layers[k].weight.detach().clone() for k in SLICE_LAYERS[which]}
        parallel.unshard_params(list(named.values()), state.optimizer)
    return {**summary(models, state, losses), **extra}


def _cell_inputs():
    rs = np.random.RandomState(2)
    return [rs.randn(*s) for s in ((2, 3, 5, 6), (2, 4, 5, 6), (2, 4, 5, 6),
                                   (2, 4, 5, 6))]


def cell_step(kind, inputs):
    """(e): a GRU or LSTM cell (3 -> 4 channels, float64) sharded on a rank,
    or two linears (3 -> 4 -> 4 features on the last axis, sharded through
    the module hooks): the output and the gradients of sum(out * cot) for
    x, h and every parameter (gathered)."""
    x, h, c, cot = (torch.from_numpy(a) for a in inputs)
    if kind == "linear":
        torch.manual_seed(3)
        cell = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 4)).double()
    else:
        cell = (ConvGRUCell if kind == "gru" else ConvLSTMCell)(3, 4).double()
        init_weights_(cell, _gen(3))
    _shard([cell])
    x.requires_grad_(), h.requires_grad_()
    if kind == "linear":
        out = cell(x.transpose(1, 3)).transpose(1, 3)
    else:
        out = cell(x, h) if kind == "gru" else cell(x, (h, c))[0]
    (out * cot).sum().backward()
    if parallel.in_group():
        parallel.unshard_params([cell])
    return {"out": out.detach(), "dx": x.grad, "dh": h.grad,
            **{n: p.grad for n, p in cell.named_parameters()}}


def _block_inputs(version, rng):
    h, w = BLOCK_HW
    v = block_version(version)
    if v == "v5":
        return [rng.randn(1, c, h >> (s + 1), w >> (s + 1)) for s, c in enumerate(ENC_CH)]
    ch = (1,) * 4 if v in ("v1", "v2") else DEC_CH
    return {f"disp/{s}": rng.randn(1, c, h >> s, w >> s) for s, c in enumerate(ch)}


def block_step(version, kernel=False):
    """(e): the block of ``version`` at 32x64 (float64; float32 on the
    kernel route, ``kernel``, which the CPU runs through the kernels' plain
    versions) over 2 steps from a non-zero learned initial state, sharded
    on a rank: outputs and the gradients of a seeded scalar of them, every
    parameter and input (gathered); the sharded layers."""
    dtype = torch.float32 if kernel else torch.float64
    h, w = BLOCK_HW
    block = make_gru(version, h, w, attention=False)
    init_weights_(block, _gen(4))
    g = _gen(5)
    for p in block.initial_parameters():
        sample_(p, g, lambda t: t.normal_(0.0, 0.5, generator=g))
    block.to(dtype)
    block.kernel_scales = (kernel,) * block.n_scales
    _shard([block])
    names = _sharded_names(block)
    rng = np.random.RandomState(6)
    leaf = lambda a: torch.from_numpy(a).to(dtype).requires_grad_()  # noqa: E731
    ins = []
    hidden, outs, loss = block.initial_state(1), {}, 0.0
    for t in range(2):
        d = _block_inputs(version, rng)
        d = [leaf(a) for a in d] if isinstance(d, list) else {k: leaf(a) for k, a in d.items()}
        ins.append(d)
        hidden, disp = block(d, hidden)
        for k, v in (disp or {}).items():
            outs[f"t{t} {k}"] = v
    for i, s in enumerate(hidden):
        for j, x in enumerate(s if isinstance(s, tuple) else (s,)):
            outs[f"hidden {i}.{j}"] = x
    for k, v in outs.items():
        loss = loss + (v * torch.from_numpy(rng.randn(*v.shape)).to(dtype)).sum()
    loss.backward()
    if parallel.in_group():
        parallel.unshard_params([block])
    grads = {n: p.grad for n, p in block.named_parameters()}
    for t, d in enumerate(ins):
        for k, v in (enumerate(d) if isinstance(d, list) else d.items()):
            grads[f"d t{t} {k}"] = v.grad
    return {"outs": {k: v.detach() for k, v in outs.items()}, "grads": grads, "sharded": names}


def bn_trap():
    """(e): BatchNorm2d in training mode on the whole batch (a (1, 2) mesh:
    every rank of the model group holds it) over its data group, and over
    the world group as the data axis alone would take it."""
    out = {"data": _bn_run()}
    mp = pytest.MonkeyPatch()
    mp.setattr(resnet, "data_world", parallel.world_size)
    mp.setattr(resnet, "data_group", lambda: None)
    try:
        out["world"] = _bn_run()
    finally:
        mp.undo()
    return out


def ranks_22(x, mono):
    """Everything the (2, 2) mesh runs: (c) and the mono step of (d)."""
    return {"jax": jax_computation(x), "mono": train_step("mono", mono),
            "shape": parallel.mesh_shape(),
            "groups": (parallel.data_rank(), parallel.data_world(), parallel.model_rank(),
                       parallel.model_world())}


def ranks_12(gru, cells):
    """Everything the (1, 2) mesh runs: the port's side of (b), the GRU step
    of (d) and the traps of (e)."""
    rule = {}
    for name, module in _rule_modules().items():
        parallel.model_sharded_params([module], _here())
        rule[name] = _sharded_names(module)
    head = Head((16, 32, 64, 128))
    return {"rule": rule, "gru": train_step("gru", gru),
            "cells": {k: cell_step(k, cells) for k in CELLS},
            "blocks": {v: block_step(v) for v in BLOCK_VERSIONS},
            "kernel_block": block_step("v10", kernel=True),
            "head_sharded": len(parallel.model_sharded_params([head], _here())),
            "bn": bn_trap()}


def _jax_x():
    return np.random.RandomState(0).rand(JAX_B, 3, *JAX_HW).astype(np.float32)


@pytest.fixture(scope="module")
def runs_22():
    """The (2, 2) mesh's ranks; the one-process mono step."""
    mono = _mono_batch()
    ranks = parallel.launch(ranks_22, parallel.make_mesh_2d(2, 2, [CPU] * 4), _jax_x(), mono)
    return ranks, train_step("mono", mono)


@pytest.fixture(scope="module")
def runs_12():
    """The (1, 2) mesh's ranks; the one-process GRU step, cells and blocks."""
    gru, cells = _step_batch("gru"), _cell_inputs()
    ranks = parallel.launch(ranks_12, parallel.make_mesh_2d(1, 2, [CPU] * 2), gru, cells)
    want = {"gru": train_step("gru", gru),
            "cells": {k: cell_step(k, cells) for k in CELLS},
            "blocks": {v: block_step(v) for v in BLOCK_VERSIONS},
            "kernel_block": block_step("v10", kernel=True), "bn": _bn_run()}
    return ranks, want


def test_ranks_sit_on_the_mesh(runs_22):
    ranks, _ = runs_22
    assert [r["shape"] for r in ranks] == [(2, 2)] * 4
    assert [r["groups"] for r in ranks] == [(0, 2, 0, 2), (0, 2, 1, 2), (1, 2, 0, 2),
                                            (1, 2, 1, 2)]
    assert parallel.mesh_shape() == (1, 1)  # the caller: no group


# ------------------------------------------------------ (b) the rule
def _jax_tree(family):
    """(JAX params of ``family`` from eval_shape, the port's converter of
    such a tree to a state dict)."""
    import jax
    import jax.numpy as jnp

    from ssde_tpu.models import DepthDecoder as FlaxDecoder
    from ssde_tpu.models import PoseDecoder as FlaxPose
    from ssde_tpu.models import ResnetEncoder as FlaxEncoder
    from ssde_tpu.models.recurrent import make_gru as flax_make_gru
    from ssde_tpu_torch import checkpoint
    from ssde_tpu_torch.models.recurrent import GRU_HIDDEN_SPECS

    h, w = BLOCK_HW
    key = jax.random.PRNGKey(0)
    feats = [jnp.zeros((1, h >> (i + 1), w >> (i + 1), c)) for i, c in enumerate(ENC_CH)]
    if family.startswith("encoder"):
        layers = int(family[7:] or 18)
        tree = jax.eval_shape(
            lambda: FlaxEncoder(layers).init(key, jnp.zeros((1, h, w, 3)), False))
        return tree["params"], lambda p: checkpoint.encoder_from_flax(
            p, jax.tree.map(np.asarray, _zeros(tree["batch_stats"])))
    if family == "depth":
        tree = jax.eval_shape(lambda: FlaxDecoder(scales=(0,)).init(key, feats))
        return tree["params"], lambda p: checkpoint.depth_from_flax(p, scales=(0,))
    if family == "pose":
        tree = jax.eval_shape(lambda: FlaxPose(1, 2).init(key, [feats]))
        return tree["params"], checkpoint.pose_decoder_from_flax
    version = family[4:]
    spec = GRU_HIDDEN_SPECS[version]
    dec = {f"disp/{s}": jnp.zeros((1, h >> s, w >> s, c))
           for s, c in enumerate((1,) * 4 if version == "v1" else DEC_CH)}
    hid = [jnp.zeros((1, h >> s, w >> s, c)) for s, c in enumerate(spec["hid"])]
    tree = jax.eval_shape(lambda: flax_make_gru(version, h, w).init(key, dec, hid))
    return tree["params"], checkpoint.gru_from_flax


def _zeros(tree):
    import jax

    return jax.tree.map(lambda a: np.zeros(a.shape, np.float32), tree)


@pytest.mark.parametrize("family", ["encoder", "encoder50", "depth", "pose", "gru_v10", "gru_v1"])
def test_the_sharding_rule_is_the_jax_rule(runs_12, family):
    """The kernels JAX's model_sharded_params places with a model spec (at
    m = 2, on its 2x2 mesh of virtual devices), marked 1 through the
    converter, against the layers whose weight the port shards: the same,
    but for ``h0`` and a GRU cell's ``conv_gates`` whose ``conv_can`` does
    not divide."""
    import jax
    from jax.sharding import PartitionSpec as P

    from ssde_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
    from ssde_tpu.parallel import model_sharded_params as jax_model_sharded_params

    params, to_torch = _jax_tree(family)
    placed = jax_model_sharded_params(_zeros(params), jax_make_mesh_2d(data=2, model=2))
    marks = jax.tree.map(lambda a: np.full(a.shape, float(a.sharding.spec != P()), np.float32),
                         placed)
    jax_sharded = {k for k, v in to_torch(marks).items()
                   if v.is_floating_point() and v.numel() and float(v.reshape(-1)[0]) == 1}
    port = set(runs_12[0][0]["rule"][family])
    assert runs_12[0][1]["rule"][family] == runs_12[0][0]["rule"][family]
    # the listed differences
    h0 = {k for k in jax_sharded if k.endswith("h0_layer1")}
    gates = {k for k in jax_sharded if k.endswith("conv_gates.weight")
             and k.replace("conv_gates", "conv_can") not in jax_sharded}
    assert jax_sharded - h0 - gates == port
    if family == "gru_v10":
        assert h0 == {f"cgru_{s}.h0_layer1" for s in range(4)} and not gates
    if family == "gru_v1":  # JAX splits the 2 gates; the port keeps the width-1 cells whole
        assert not h0 and not port
        assert gates == {f"cgru_{s}.cgru_1.conv_gates.weight" for s in range(4)}
    else:
        assert port and not gates
    if family == "depth":
        assert not any("decoder.10" in k for k in port)  # dispconv_0: Cout = 1


# ------------------------------------------- (c) the JAX test's computation
def _jax_grads(sharded):
    """The JAX computation of tests/test_model_parallel.py on the port's
    seeded weights, unsharded (or sharded on JAX's 2x2 mesh): (loss,
    encoder gradients, decoder gradients) as numpy trees."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ssde_tpu.checkpoint import convert_depth_decoder, convert_resnet_encoder
    from ssde_tpu.models import DepthDecoder as FlaxDecoder
    from ssde_tpu.models import ResnetEncoder as FlaxEncoder
    from ssde_tpu.parallel import DATA_AXIS, make_mesh_2d, model_sharded_params

    enc = ResnetEncoder(18)
    enc.init_weights_(_gen(0))
    resnet.randomize_bn_stats_(enc, _gen(1))
    dec = DepthDecoder(enc.num_ch_enc, scales=(0,))
    init_weights_(dec, _gen(2))
    np_sd = lambda m: {k: v.detach().numpy() for k, v in m.state_dict().items()}  # noqa: E731
    ep, es, _ = convert_resnet_encoder(np_sd(enc))
    dp = convert_depth_decoder(np_sd(dec), scales=(0,))
    fe, fd = FlaxEncoder(18), FlaxDecoder(scales=(0,))
    x = jnp.asarray(_jax_x().transpose(0, 2, 3, 1))

    def loss_fn(ep, dp, x):
        feats = fe.apply({"params": ep, "batch_stats": es}, x, False)
        return jnp.mean(fd.apply({"params": dp}, feats)["disp/0"] ** 2)

    if sharded:
        mesh = make_mesh_2d(data=2, model=2)
        ep, dp = model_sharded_params(ep, mesh), model_sharded_params(dp, mesh)
        x = jax.device_put(x, NamedSharding(mesh, P(DATA_AXIS)))
    loss, (ge, gd) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(ep, dp, x)
    return float(loss), jax.tree.map(np.asarray, ge), jax.tree.map(np.asarray, gd)


@pytest.mark.parametrize("sharded", [False, pytest.param(True, marks=pytest.mark.slow)])
def test_the_jax_model_parallel_computation(runs_22, sharded):
    from ssde_tpu.checkpoint import convert_depth_decoder, convert_resnet_encoder
    from test_torch_mono_step import _leaves

    ranks, _ = runs_22
    loss, ge, gd = _jax_grads(sharded)
    assert {r["jax"]["loss"] for r in ranks} == {ranks[0]["jax"]["loss"]}
    np.testing.assert_allclose(ranks[0]["jax"]["loss"], loss, rtol=1e-5)
    grads = ranks[0]["jax"]["grads"]
    part = lambda g: {k[len(g) + 1:]: v.numpy() for k, v in grads.items()  # noqa: E731
                      if k.startswith(g + ".")}
    have = (convert_resnet_encoder(part("encoder"))[0],
            convert_depth_decoder(part("depth"), scales=(0,)))
    for got, want in zip(have, (ge, gd)):
        got, want = _leaves(got), _leaves(want)
        assert got.keys() == want.keys() and want
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, atol=2e-5, rtol=1e-3, err_msg=k)


# ----------------------------------------------------- (d) the train steps
def _hold_step(ranks, want, which, m):
    """Every rank of a step's run against the one-process step; each model
    group's slices of :data:`SLICE_LAYERS` (m rows apart) against the
    one-process parameters; the parameters each rank's Adam holds."""
    check_against_one_process(ranks, want, rel=REL)
    assert all(np.isfinite(v) for v in want["losses"].values())
    for r in range(0, len(ranks), m):
        group = ranks[r:r + m]
        for k in SLICE_LAYERS[which]:
            whole = want["by_name"][k]
            parts = [g["slices"][k] for g in group]
            assert all(p.shape[0] * m == whole.shape[0] for p in parts), k
            np.testing.assert_allclose(torch.cat(parts).numpy(), whole.numpy(), rtol=0,
                                       atol=REL * whole.abs().max().item(), err_msg=k)
    assert all(r["moments_cover_slices"] for r in ranks)
    one = want["numel"]
    assert one["sharded"] == 0
    for r in ranks:
        assert r["numel"]["sharded"] > r["numel"]["replicated"] > 0
        assert r["numel"]["replicated"] + m * r["numel"]["sharded"] == one["replicated"]


def _by_name(which, want):
    """The one-process summary's parameters after the step, by the weight
    names of :data:`SLICE_LAYERS`."""
    if which == "mono":
        models = steps.build_mono_models(_mono_opts(), "cpu", _gen(0))
    else:
        h, w = STEP_HW
        models = steps_gru.build_gru_models(Options(height=h, width=w, gru_version="v10"),
                                            "cpu", _gen(0))
    named = _named_modules(models, which)
    params = [p for m in models.modules() for p in m.parameters()]
    index = {id(p): i for i, p in enumerate(params)}
    layers = {f"{g}.{n}": m for g, mod in named.items() for n, m in mod.named_modules()}
    return {k: want["params"][index[id(layers[k].weight)]] for k in SLICE_LAYERS[which]}


def test_mono_step_at_2x2_is_the_one_process_step(runs_22):
    ranks, want = runs_22
    _hold_step([r["mono"] for r in ranks], {**want, "by_name": _by_name("mono", want)}, "mono",
               2)


def test_gru_step_at_1x2_is_the_one_process_step(runs_12):
    ranks, want = runs_12
    want = want["gru"]
    _hold_step([r["gru"] for r in ranks], {**want, "by_name": _by_name("gru", want)}, "gru", 2)
    assert sum(g is not None and bool(g.abs().max() > 0) for g in want["grads"]) > 100


# ------------------------------------------------------------ (e) the traps
def _hold(got, want, rel, what):
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        assert (got[k] is None) == (w is None), f"{what} {k}"
        if w is not None:
            np.testing.assert_allclose(got[k].double().numpy(), w.double().numpy(), rtol=0,
                                       atol=rel * max(w.abs().max().item(), 1e-30),
                                       err_msg=f"{what} {k}")


@pytest.mark.parametrize("kind", CELLS)
def test_split_convs_of_a_sharded_cell(runs_12, kind):
    ranks, want = runs_12
    for r in ranks:
        _hold(r["cells"][kind], want["cells"][kind], 1e-12, kind)


@pytest.mark.parametrize("version", BLOCK_VERSIONS)
def test_a_sharded_block_is_the_block(runs_12, version):
    ranks, want = runs_12
    for r in ranks:
        got = r["blocks"][version]
        _hold(got["outs"], want["blocks"][version]["outs"], 1e-12, version)
        _hold(got["grads"], want["blocks"][version]["grads"], 1e-10, version)
    sharded = ranks[0]["blocks"][version]["sharded"]
    assert want["blocks"][version]["sharded"] == []
    # heads of one channel stay whole
    assert not any(k.startswith("conv3x3_") or "conv3x3.conv" in k for k in sharded), sharded
    # v1's width-1 cells stay whole at m = 2 (their candidate conv does not divide), and
    # its heads have one channel: nothing of v1 is split
    assert (sharded == []) == (version == "v1"), sharded


def test_a_sharded_block_on_the_kernel_route(runs_12):
    """v10's kernel convs (the plain versions on the CPU) on the slices,
    float32."""
    ranks, want = runs_12
    for r in ranks:
        _hold(r["kernel_block"]["outs"], want["kernel_block"]["outs"], 1e-5, "outs")
        _hold(r["kernel_block"]["grads"], want["kernel_block"]["grads"], 1e-4, "grads")


def test_a_one_channel_head_stays_whole(runs_12):
    assert [r["head_sharded"] for r in runs_12[0]] == [0, 0]


def test_batchnorm_over_the_data_group(runs_12):
    """At (1, 2) both ranks hold the whole batch. Over the data group (this
    rank alone) BatchNorm is the one-process BatchNorm, bit for bit, with no
    collective. Over the world group, as the data axis alone would take it,
    it also comes out right, forward and backward: the backward's sum over
    the ranks counts each row's loss gradient m times, but the statistics'
    count is m times too, and the two cancel. So the data group is the
    JAX semantics at 1/m of the world's bytes, not a repair of the numbers."""
    ranks, want = runs_12
    want = want["bn"]
    for r in ranks:
        got = r["bn"]["data"]
        for k in ("out", "dx", "dw", "db", "frozen"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        world = r["bn"]["world"]
        for k in ("out", "dx", "dw", "db", "frozen"):
            np.testing.assert_allclose(world[k], want[k], rtol=0,
                                       atol=1e-12 * np.abs(want[k]).max(), err_msg=k)


@pytest.mark.parametrize("family", ["v9", "v2", "v8", "posecnn", "fusion_v3", "attention_encoder"])
def test_model_sharded_params_refuses_what_it_does_not_cover(family):
    from ssde_tpu_torch.models import Fusion_v3, PoseCNN, ResnetEncoderAttention

    build = {"posecnn": lambda: PoseCNN(2), "fusion_v3": Fusion_v3,
             "attention_encoder": lambda: ResnetEncoderAttention(18)}
    module = build[family]() if family in build else make_gru(family, *BLOCK_HW)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    with pytest.raises(NotImplementedError, match="item 12c"):
        parallel.model_sharded_params([module], parallel.make_mesh_2d(1, 2, [CPU] * 2))
    after = module.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())  # nothing changed


def test_model_sharded_params_needs_a_rank_of_the_mesh():
    with pytest.raises(RuntimeError, match="not a rank"):
        parallel.model_sharded_params([Head()], parallel.make_mesh_2d(1, 2, [CPU] * 2))
