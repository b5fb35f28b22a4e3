"""The float32 conv body (3xTF32 on the tensor cores), on the CPU, and the
port's repairs that came with it.

The float32 kernels of ``csrc/conv3x3_tf32.cu`` split each operand into
tf32 hi + lo (``cvt.rna.tf32.f32``) and take x * w as lo*w_hi + hi*w_lo +
hi*w_hi in float32. ``tf32_split`` is that rounding in plain torch (held
here to hand-picked bit patterns), ``conv3x3_tf32x3_reference`` that
arithmetic as three implicit GEMMs; it is held against the Pallas kernel
it replaces, ``ssde_tpu/ops/pallas/conv3x3.py`` (``_conv_rows`` through
``conv3x3`` and ``conv3x3_zero_chain``) in interpret mode, at 1e-5 absolute
on O(1) outputs: the split products are within about 2^-21 of float32's,
and every side sums at most 9 * 7 of them. Then the kernels' host side:
the packed hi/lo weights, packing once per weight version, the float32
tile choices, grid refusals and weight-gradient partitions. The kernels
themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

The repairs: the trainers refuse the weights the JAX trainers would load
(``--load_weights_folder``, the ``--mono_pretrained`` warm start from
``models/mono_640x192``) instead of training from random weights, the
evaluator's ``main()`` requires ``--load_weights_folder``, and the GRU
step's checkpointing (the counterpart of the JAX ``_remat_mode``) changes
no loss, gradient or BatchNorm statistic: in float64 at 64x128 within
1e-6 of each gradient's max.
"""

import copy
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssde_tpu.ops.pallas.conv3x3 import conv3x3 as pallas_reflect
from ssde_tpu.ops.pallas.conv3x3 import conv3x3_zero_chain
from ssde_tpu.train.steps_gru import _remat_mode as jax_remat_mode
from ssde_tpu_torch.config import MonodepthOptions, Options
from ssde_tpu_torch.data.kitti import KITTI_K
from ssde_tpu_torch.models.common import sample_
from ssde_tpu_torch.ops.conv3x3 import (ACTS, PADS, conv3x3, conv3x3_reference,
                                        conv3x3_tf32x3_reference, dw_partitions, dw_tile_m,
                                        fwd_tiles, pack_weights, packed_weights, tf32_split)
from ssde_tpu_torch import checkpoint
from ssde_tpu_torch.scripts import evaluate_depth_gru_fusion, train_dpt, train_gru
from ssde_tpu_torch.train import steps_gru

B, H = 2, 6
TOL = 1e-5
F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: beside the other workers of a parallel pytest run a
    thread pool in every process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(*words):
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.int32)).view(F32)


def _words(t):
    return [int(v) for v in t.view(torch.int32).numpy().view(np.uint32)]


# ------------------------------------------------------------- tf32_split


def test_tf32_split_rounds_as_cvt_rna():
    """Nearest, ties away from zero, on the 13 bits below tf32's 10-bit
    mantissa; subnormals round the same way; a carry can reach infinity;
    infinities and NaNs pass through."""
    cases = {
        0x3F800000: 0x3F800000,  # 1.0: exact
        0x3F800FFF: 0x3F800000,  # below the tie: down
        0x3F801000: 0x3F802000,  # tie, even mantissa below: away (nearest-even: down)
        0x3F805000: 0x3F806000,  # tie, odd above the even: away (nearest-even: down too)
        0x3F803000: 0x3F804000,  # tie: away
        0x3F801001: 0x3F802000,  # above the tie: up
        0xBF805000: 0xBF806000,  # negative tie: away from zero
        0xBF800FFF: 0xBF800000,
        0x3FFFF000: 0x40000000,  # the carry reaches the exponent
        0x00001000: 0x00002000,  # subnormal tie: away
        0x00000FFF: 0x00000000,  # subnormal: down to zero
        0x80001000: 0x80002000,  # negative subnormal tie
        0x7F7FFFFF: 0x7F800000,  # the largest float rounds to infinity
        0x7F800000: 0x7F800000,  # +inf
        0xFF800000: 0xFF800000,  # -inf
        0x7FC00001: 0x7FC00001,  # NaN, payload kept
        0xFFFFFFFF: 0xFFFFFFFF,  # negative NaN
        0x00000000: 0x00000000,
        0x80000000: 0x80000000,  # -0
    }
    hi, lo = tf32_split(_bits(*cases))
    assert _words(hi) == list(cases.values())
    # lo is x - hi rounded the same way: 0xFFF units of 2^-23 round to 2^-11
    assert _words(lo)[1] == 0x3A000000 and lo[0] == 0 and torch.isnan(lo[13:17]).all()
    with pytest.raises(TypeError):
        tf32_split(torch.zeros(2, dtype=torch.float64))


@pytest.mark.parametrize("scale", [1e-30, 1e-20, 1.0, 3e7, 1e35])
def test_tf32_split_reconstructs_x(scale):
    """hi and lo are tf32 (their low 13 bits are 0) and hi + lo is x within
    2^-21 of |x| (normal numbers; subnormals keep fewer bits)."""
    x = (torch.from_numpy(np.random.RandomState(7).randn(4096)) * scale).to(F32)
    hi, lo = tf32_split(x)
    assert not ((hi.view(torch.int32) & 0x1FFF).any() or (lo.view(torch.int32) & 0x1FFF).any())
    normal = x.abs() >= torch.finfo(F32).tiny
    err = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs())[normal]
    assert normal.any() and err.max() <= 2.0 ** -21
    if scale == 1.0:  # lo is x - hi to within tf32: below 2^-11 of |x|
        assert (lo.abs() <= x.abs() * 2.0 ** -11).all()


# ------------------------------------------- the arithmetic, against Pallas


def _inputs(cin, cout, width, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, cin, H, width).astype(np.float32)
    w = (rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin)).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("pad", PADS)
def test_3xtf32_arithmetic_matches_pallas_kernel(pad, act, bias):
    planar = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    hwio = lambda a: jnp.asarray(a.transpose(2, 3, 1, 0))  # noqa: E731
    cin, cout = 5, 7
    if pad == "zero":
        # the chain variant at physical width 128 and logical width 100:
        # columns past wl are zero fill and column wl-1 is the right edge
        x, w, b = _inputs(cin, cout, 128)
        x[..., 100:] = 0.0
        got = conv3x3_zero_chain(planar(x), hwio(w), jnp.asarray(b) if bias else None, act,
                                 wl=100, interpret=True)
        got = np.asarray(got).transpose(0, 2, 1, 3)[..., :100]
        x = np.ascontiguousarray(x[..., :100])
    else:
        x, w, b = _inputs(cin, cout, 40)
        bj = jnp.asarray(b if bias else np.zeros_like(b))
        got = np.asarray(pallas_reflect(planar(x), hwio(w), bj, act,
                                        interpret=True)).transpose(0, 2, 1, 3)
    want = conv3x3_tf32x3_reference(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b) if bias else None, pad, act)
    assert want.dtype == F32
    np.testing.assert_allclose(want.numpy(), got, atol=TOL, rtol=0)


@pytest.mark.parametrize("cin,cout", [(3, 1), (32, 96), (64, 192), (1, 32)])
def test_3xtf32_arithmetic_matches_the_plain_conv(cin, cout):
    """At the GRU widths (and the heads and their 1-channel dx) the split
    arithmetic stays within 1e-5 of the plain float32 conv, and within 3x
    its error against float64 (the card is held to 4x, chip_smoke.py)."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(cin, cout, 37, seed=cin + cout))
    for pad, act in itertools.product(PADS, ("none", "sigmoid")):
        got = conv3x3_tf32x3_reference(x, w, b, pad, act)
        plain = conv3x3_reference(x, w, b, pad, act)
        ref64 = conv3x3_reference(x.double(), w.double(), b.double(), pad, act)
        assert (got - plain).abs().max() <= TOL, (pad, act)
        e_got, e_plain = ((t.double() - ref64).abs().max().item() for t in (got, plain))
        assert e_got <= 3 * max(e_plain, 2.0 ** -24), (pad, act, e_got, e_plain)


# ------------------------------------------------------ the packed operand


@pytest.mark.parametrize("cin,cout", [(3, 1), (5, 17), (32, 96), (64, 192), (1, 32)])
def test_float32_packed_weights_are_hi_and_lo_planes(cin, cout):
    """(2, N_pad, 9, Cin_pad): plane 0 the tf32 hi of pack_weights' layout
    (K = tap * Cin_pad + ci, tap = 3 ky + kx), plane 1 its lo, zero past Cout
    and Cin; N_pad and Cin_pad multiples of the float32 kernel's BN and CC."""
    w = torch.randn(cout, cin, 3, 3)
    cc, bn = fwd_tiles(cin, cout, F32)
    wp = packed_weights(w, cc, bn)
    plain = pack_weights(w, cc, bn)
    assert wp.dtype == F32 and wp.shape == (2,) + plain.shape and wp.is_contiguous()
    n_pad, taps, cin_pad = plain.shape
    assert taps == 9 and n_pad % bn == 0 and cin_pad % cc == 0
    hi, lo = tf32_split(plain)
    assert torch.equal(wp[0], hi) and torch.equal(wp[1], lo)
    for co, ci, ky, kx in itertools.product(range(cout), range(cin), range(3), range(3)):
        v = w[co, ci, ky, kx].item()
        got = wp[0, co, 3 * ky + kx, ci].double() + wp[1, co, 3 * ky + kx, ci].double()
        assert abs(got.item() - v) <= 2.0 ** -21 * abs(v)
    assert not wp[:, cout:].any() and not wp[:, :, :, cin:].any()


def test_weights_are_packed_once_per_version():
    """The packed operand is kept on the weight tensor and reused until the
    tensor changes: an in-place update or load_state_dict bumps its version
    and repacks; a new tensor (a cast, a rotation) packs anew; inference
    tensors have no version counter and pack every time; bf16 packs one
    plane."""
    conv = torch.nn.Conv2d(32, 64, 3)
    w = conv.weight
    n = packed_weights.packs
    first = packed_weights(w, 16, 64)
    assert packed_weights(w, 16, 64) is first and packed_weights.packs == n + 1
    assert packed_weights(w, 16, 32) is not first and packed_weights.packs == n + 2  # other tiles
    with torch.no_grad():
        w.mul_(2.0)
    again = packed_weights(w, 16, 64)
    assert again is not first and torch.equal(again, 2 * first) and packed_weights.packs == n + 3
    conv.load_state_dict({"weight": torch.ones_like(w), "bias": conv.bias.detach()})
    assert torch.equal(packed_weights(w, 16, 64)[0, :64, :, :32], torch.ones(64, 9, 32))
    assert packed_weights.packs == n + 4
    bf = w.detach().to(torch.bfloat16)
    assert packed_weights(bf, 32, 64).shape == (64, 9, 32)
    with torch.inference_mode():
        frozen = torch.randn(8, 4, 3, 3)
    packed_weights(frozen, 8, 8)
    packed_weights(frozen, 8, 8)
    assert packed_weights.packs == n + 7


# ------------------------------------------------- tiles, grid, partitions


def test_float32_tile_choices():
    # (CC, BN) of the float32 forward: K steps of 8, n8 fragments, at most 32
    # output channels a block
    assert [fwd_tiles(cin, cout, F32) for cin, cout in
            ((32, 1), (1, 32), (32, 96), (64, 192), (64, 128), (5, 17), (192, 64), (8, 8),
             (9, 9), (32, 32))] == [
        (16, 8), (8, 32), (16, 32), (16, 32), (16, 32), (8, 32), (16, 32), (8, 8),
        (16, 32), (16, 32)]
    # the bf16 choices are untouched (K steps of 16)
    assert fwd_tiles(32, 96) == fwd_tiles(32, 96, torch.bfloat16) == (32, 32)
    # output channels per block of the float32 weight gradient; 1 = the head path
    assert [dw_tile_m(c, F32) for c in (1, 17, 32, 64, 96, 192)] == [1, 32, 32, 32, 32, 32]


def test_wrapper_refuses_a_grid_the_float32_kernel_cannot_launch():
    """gridDim.z = B x output-channel blocks and gridDim.y = row tiles of 4
    must stay within 65535; the CPU path raises as the card would."""
    w = torch.zeros(1, 1, 3, 3)
    with pytest.raises(ValueError, match="grid"):
        conv3x3(torch.zeros(65536, 1, 1, 2), w)  # 65536 images of one block each
    conv3x3(torch.zeros(65535, 1, 1, 2), w)
    with pytest.raises(ValueError, match="grid"):
        conv3x3(torch.zeros(1, 1, 4 * 65535 + 1, 1), w)  # 65536 row tiles
    conv3x3(torch.zeros(1, 1, 4 * 65535, 1), w)
    # the backward's dx is a conv from Cout to Cin channels: 65 -> 9 needs 2
    # blocks of 32 per image, 9 -> 65 (the forward) 3
    w = torch.zeros(9, 65, 3, 3)
    with pytest.raises(ValueError, match="grid"):
        conv3x3(torch.zeros(21846, 65, 1, 1), w)  # dx: 21846 x 3 blocks
    conv3x3(torch.zeros(21845, 65, 1, 1), w)


def test_float32_weight_gradient_partitions():
    # GRU v10 scale 0 at B=8 (640x192): 32 -> 96 has 3 x 1 channel blocks of
    # 32 x 32, 2 blocks per SM (96.6 KB of shared memory each) on 132 SMs
    assert dw_partitions(8, 192, 640, 32, 96, 132, F32) == 88
    # 64 -> 192 at scale 1: 6 x 2 blocks
    assert dw_partitions(8, 96, 320, 64, 192, 132, F32) == 22
    # the heads' CUDA-core path: 2 blocks of 32 input channels, 3 per SM
    assert dw_partitions(8, 96, 320, 64, 1, 132, F32) == 198
    assert dw_partitions(1, 8, 32, 16, 16, 132, F32) == 2  # never more than the 4x64 tiles
    assert dw_partitions(1, 1, 1, 1, 2, 132, F32) == 1


# ------------------------------------------------------------ weights to load


def _argv(*extra):
    return ["--synthetic_data", "--height", "64", "--width", "128", "--batch_size", "1",
            "--num_epochs", "1", "--save_frequency", "2", "--num_workers", "1",
            "--compute_dtype", "float32", "--no_cuda", *extra]


_TRAINERS = {"train_dpt": (train_dpt, ("--model", "monodepth2")),
             "train_gru": (train_gru, ("--gru_version", "v10", "--len_sequence", "2"))}


def _build(script, *extra):
    module, flags = _TRAINERS[script]
    return module.build_trainer(MonodepthOptions().parse(_argv(*flags, *extra)))


def _perturbed_folder(script, folder, log_dir):
    """A trainer's seeded weights moved off the seed, saved to ``folder``
    (the modules only); returns the modules' state dicts."""
    tr = _build(script, "--mono_pretrained", "0", "--log_dir", str(log_dir))
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in tr.models.parameters():
            p.add_(torch.randn(p.shape, generator=g))
    checkpoint.save_folder(str(folder), tr.models, height=64, width=128)
    return {name: {k: v.clone() for k, v in getattr(tr.models, name).state_dict().items()}
            for name in checkpoint.MODULE_NAMES if getattr(tr.models, name, None) is not None}


def _holds(models, want):
    return all(torch.equal(v, want[name][k]) for name in want
               for k, v in getattr(models, name).state_dict().items())


@pytest.mark.parametrize("script", sorted(_TRAINERS))
def test_trainers_load_a_weights_folder(script, tmp_path):
    """--load_weights_folder loads every module file of the folder into the
    trainer (no adam.pth: fresh moments)."""
    want = _perturbed_folder(script, tmp_path / "w", tmp_path)
    tr = _build(script, "--load_weights_folder", str(tmp_path / "w"), "--log_dir", str(tmp_path))
    assert _holds(tr.models, want) and tr.state.step == 0
    assert not _holds(_build(script, "--log_dir", str(tmp_path)).models, want)


@pytest.mark.parametrize("script", sorted(_TRAINERS))
def test_trainers_warm_start_from_mono_640x192(script, tmp_path, monkeypatch):
    """--mono_pretrained (on by default) with models/mono_640x192 in the
    working directory loads the module files there, as the JAX trainers
    do; with --mono_pretrained 0, or with a folder to load, it does not."""
    monkeypatch.chdir(tmp_path)
    assert MonodepthOptions().parse(_argv(*_TRAINERS[script][1])).mono_pretrained
    want = _perturbed_folder(script, tmp_path / "models" / "mono_640x192", tmp_path)
    assert _holds(_build(script, "--log_dir", str(tmp_path)).models, want)
    assert not _holds(_build(script, "--mono_pretrained", "0", "--log_dir",
                             str(tmp_path)).models, want)


def test_evaluator_main_requires_a_weights_folder():
    with pytest.raises(ValueError, match="--load_weights_folder"):
        evaluate_depth_gru_fusion.main(["--device", "cpu", "--gru_version", "v10",
                                        "--height", "64", "--width", "128"])


# ------------------------------------------------- checkpointing the GRU step


@pytest.mark.parametrize("B,T,mode", [(b, t, m) for b, t in
                                      ((1, 2), (8, 3), (4, 6), (2, 16), (11, 3), (12, 10))
                                      for m in ("auto", "0", "1", "scan")])
def test_remat_mode_matches_jax(B, T, mode):
    """The same choice as the JAX step's ``_remat_mode`` at every B*T."""
    opts = Options(batch_size=B, len_sequence=T, gru_remat=mode)
    assert steps_gru.remat_mode(opts) == jax_remat_mode(opts)


def _gru_models(version):
    models = steps_gru.build_gru_models(
        Options(height=64, width=128, batch_size=1, len_sequence=2, gru_version=version,
                compute_dtype="float32"), "cpu", torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    for p in models.h0_parameters():
        sample_(p, g, lambda t: t.normal_(0, 0.1, generator=g))
    for m in models.modules():
        m.double()
    models.gru.kernel_scales = (False,) * 4  # the plain convs: conv3x3 takes no float64
    return models


def _gru_step(models, remat):
    """(losses, gradients, BatchNorm statistics, encoder forward calls) of
    one float64 GRU step at 64x128, B=1, T=2 under ``--gru_remat remat``."""
    models = copy.deepcopy(models)
    models.opts = copy.copy(models.opts)
    models.opts.gru_remat = remat
    rng = np.random.RandomState(5)
    batch = {f"color/{i}": torch.from_numpy(rng.rand(1, 2, 64, 128, 3)) for i in (0, -1, 1)}
    batch["K"] = torch.from_numpy(np.stack([KITTI_K]).astype(np.float64))
    inputs, B, T = steps_gru.preprocess_gru_batch(batch, models.opts)
    calls = []
    # a pre-hook: the recompute stops as soon as it has what the backward needs
    models.encoder.register_forward_pre_hook(lambda *_: calls.append(1))
    models.train()
    _, losses, _ = steps_gru.gru_loss_fn(models, inputs, B, T)
    losses["loss"].backward()
    grads = {f"{i}.{k}": p.grad for i, m in enumerate(models.modules())
             for k, p in m.named_parameters() if p.grad is not None}
    stats = {k: v.clone() for k, v in models.encoder.state_dict().items() if "running" in k}
    return {k: v.item() for k, v in losses.items()}, grads, stats, len(calls)


@pytest.fixture(scope="module")
def plain_step():
    """(models, the plain step's results) per GRU version, made once."""
    made = {}

    def get(version):
        if version not in made:
            models = _gru_models(version)
            made[version] = models, _gru_step(models, "0")
        return made[version]
    return get


@pytest.mark.parametrize("version,remat", [("v10", "1"), ("v10", "scan"), ("v9", "1")])
def test_checkpointed_gru_step_changes_nothing(plain_step, version, remat):
    """Each gradient within 1e-6 of its max; an attention conv's key bias
    (true gradient 0: it shifts all 9 logits of a pixel alike) within 1e-6
    of the largest gradient of its conv."""
    models, (want_losses, want_grads, want_stats, want_calls) = plain_step(version)
    losses, grads, stats, calls = _gru_step(models, remat)
    assert want_calls == 1 and calls == (2 if remat == "1" else 1)  # the recompute ran
    assert losses.keys() == want_losses.keys() and grads.keys() == want_grads.keys()
    for k, v in want_losses.items():
        assert losses[k] == pytest.approx(v, rel=1e-12, abs=0), k
    scale = {k: v.abs().max().item() for k, v in want_grads.items()}
    for k in scale:
        if k.endswith("key_conv.bias"):
            conv = k[:-len("key_conv.bias")]
            scale[k] = max(v for n, v in scale.items() if n.startswith(conv))
    for k, v in want_grads.items():
        assert scale[k] > 0, k
        assert (grads[k] - v).abs().max() <= 1e-6 * scale[k], k
    # the recompute did not move BatchNorm's running statistics a second time
    assert all(torch.equal(stats[k], v) for k, v in want_stats.items())
