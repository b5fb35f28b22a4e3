"""Data parallelism of the port (``ssde_tpu_torch.parallel``) against the
JAX mesh (``ssde_tpu/parallel/mesh.py``), on the CPU over gloo.

* ``make_mesh``'s rule against ``ssde_tpu.parallel.make_mesh`` on the 8
  virtual CPU devices of tests/conftest.py, and the trainers' mesh of
  ``--num_devices`` under ``--no_cuda``;
* the Loader's shards, put together, against the one-process batches, bit
  for bit, augmentation on, over two epochs;
* ``device_prefetch``: tests/test_device_prefetch.py's cases (the world-1
  passthrough, order and placement of the double buffer, a short
  iterator, the trainer's loop routed through it) and the double buffer
  that a group of two ranks takes by default;
* ``BatchNorm2d`` over 2 ranks against one process on the concatenated
  batch, float64: output, input and affine gradients, running statistics,
  also under ``running_stats_frozen``;
* one data-parallel GRU v10 step (float64, 2 ranks of one sequence each,
  ``--gru_remat 1`` so that the checkpointed recompute runs BatchNorm's
  collectives in the backward, the automask noise drawn over the global
  batch) against the port's one-process step at 1e-9 of each tensor's max,
  the ranks bit-identical;
* ``launch`` ends with an error, within a bounded time, when a rank raises
  or hangs.

Each spawned rank runs one torch thread (``launch`` splits the caller's,
which the fixture sets to one). The rank functions live here, in a module
that imports no JAX at its top, so that a spawned rank imports torch and
the port alone; tests/test_torch_parallel_step.py holds the mono step
against the JAX 2-device mesh.
"""

import hashlib
import inspect
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ssde_tpu_torch import parallel
from ssde_tpu_torch.config import Options
from ssde_tpu_torch.data.pipeline import Loader, collate
from ssde_tpu_torch.data.synthetic import SyntheticKittiDataset, SyntheticSeqDataset
from ssde_tpu_torch.models.resnet import BatchNorm2d, running_stats_frozen
from ssde_tpu_torch.train import steps, steps_gru
from ssde_tpu_torch.train.state import TrainState
from ssde_tpu_torch.train.trainer import TrainerBase, train_mesh

CPU2 = [torch.device("cpu")] * 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here and in each spawned rank (tests/test_torch_mono_step.py
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy().copy()


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize("batch_size", [2, 4, 6, 12])
@pytest.mark.parametrize("num_devices", [0, 1, 2, 3, 8])
def test_make_mesh_follows_the_jax_rule(num_devices, batch_size):
    import jax

    from ssde_tpu.parallel import make_mesh as jax_make_mesh

    assert len(jax.devices()) == 8
    want = jax_make_mesh(num_devices, batch_size=batch_size).devices.size
    got = parallel.make_mesh(num_devices, parallel.cpu_devices(8), batch_size=batch_size)
    assert len(got) == want and got == [torch.device("cpu")] * want


@pytest.mark.parametrize("num_devices,batch_size,want", [(0, 2, 1), (1, 4, 1), (2, 2, 2),
                                                         (3, 4, 2), (8, 2, 2), (8, 12, 6)])
def test_trainer_mesh_on_the_cpu(num_devices, batch_size, want):
    """``--no_cuda``: ``--num_devices`` CPU ranks (0: one), clamped by the
    batch; a trainer given its device runs on that device alone, and then
    more than one device is an error."""
    opts = Options(no_cuda=True, num_devices=num_devices, batch_size=batch_size)
    assert train_mesh(opts) == [torch.device("cpu")] * want
    if num_devices > 1:
        with pytest.raises(ValueError, match="main"):
            train_mesh(opts, "cpu")
    else:
        assert train_mesh(opts, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="num_devices"):
        train_mesh(Options(no_cuda=True, num_devices=-1))


def test_shard_rows_and_batch():
    batch = {"x": np.arange(12).reshape(6, 2), "y": np.arange(6)}
    parts = [parallel.shard_batch(batch, r, 3) for r in range(3)]
    for k in batch:
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), batch[k])
    assert parts[1]["y"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="does not split"):
        parallel.shard_rows(5, 0, 2)


# ---------------------------------------------------------------- loader
def test_loader_shards_make_the_one_process_batches():
    """Two ranks draw the same order and decode their rows of each batch;
    put together they are the one-process batches, bit for bit, with the
    augmentation of every (seed, epoch, index), over two epochs."""
    ds = SyntheticKittiDataset(32, 64, length=12, frame_idxs=[0, -1, 1])
    whole = Loader(ds, 4, num_workers=2)
    shards = [Loader(ds, 4, num_workers=2, shard=(r, 2)) for r in range(2)]
    assert len(whole) == len(shards[0]) == 3
    jitter = []
    for epoch in range(2):
        ds.set_epoch(epoch)
        got = [list(s) for s in shards]
        for i, want in enumerate(whole):
            assert got[0][i]["color/0"].shape[0] == 2
            for k, v in want.items():
                np.testing.assert_array_equal(
                    np.concatenate([got[0][i][k], got[1][i][k]]), v, err_msg=f"{epoch} {i} {k}")
            jitter.append(want["jitter"])
    jitter = np.concatenate(jitter)
    assert len(np.unique(jitter, axis=0)) > len(jitter) // 2  # augmentation on, per item
    with pytest.raises(ValueError, match="does not split"):
        Loader(ds, 3, shard=(0, 2))


# -------------------------------------------------------- device_prefetch
def _batches(n, b=4):
    return [{"x": np.full((b, 2), i, np.float32)} for i in range(n)]


def test_prefetch_world_1_passes_host_batches():
    out = list(parallel.device_prefetch(iter(_batches(3)), "cpu"))
    assert len(out) == 3
    for i, b in enumerate(out):
        assert isinstance(b["x"], np.ndarray)  # host array: the step's own copy
        assert b["x"][0, 0] == i


def test_prefetch_double_buffer_orders_and_places():
    seen = []

    def source():
        for b in _batches(5):
            seen.append(int(b["x"][0, 0]))
            yield b

    it = parallel.device_prefetch(source(), "cpu", size=2, explicit=True)
    first = next(it)
    assert seen == [0, 1]  # batch 1 is sent before batch 0 is handed out
    out = [first] + list(it)
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        assert float(b["x"][0, 0]) == i  # order preserved


def test_prefetch_short_iterator():
    batches = [{"x": np.zeros((2,), np.float32)}]
    assert len(list(parallel.device_prefetch(iter(batches), "cpu", size=2,
                                             explicit=True))) == 1


def test_trainer_uses_prefetch():
    assert "device_prefetch" in inspect.getsource(TrainerBase.run_epoch)


# ------------------------------------------------------------- BatchNorm
BN_C = 5


def _bn_inputs():
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(4, BN_C, 3, 5) * 2 + 0.5)
    cot = torch.from_numpy(rs.randn(4, BN_C, 3, 5))
    return x, cot


def _bn_run(rows=slice(None)):
    """BatchNorm2d (float64, affine from a seed) in training mode on the
    ``rows`` of the batch: out, x / weight / bias gradients of
    sum(out * cot), the running statistics after, then the same under
    ``running_stats_frozen`` (out, statistics unchanged)."""
    x, cot = _bn_inputs()
    bn = BatchNorm2d(BN_C).double()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, BN_C))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, BN_C))
        bn.running_var.fill_(2.0)
    x = x[rows].clone().requires_grad_(True)
    out = bn(x)
    (out * cot[rows]).sum().backward()
    stats = {k: _np(v) for k, v in bn.state_dict().items()}
    with running_stats_frozen(bn):
        frozen = bn(x.detach())
    after = {k: _np(v) for k, v in bn.state_dict().items()}
    return {"out": _np(out), "dx": _np(x.grad), "dw": _np(bn.weight.grad),
            "db": _np(bn.bias.grad), "stats": stats, "frozen": _np(frozen),
            "frozen_stats": after}


def _group_rank():
    """The checks that need a group of two ranks: BatchNorm on the rank's
    rows, the default double buffer of device_prefetch, and the world."""
    r, n = parallel.rank(), parallel.world_size()
    out = _bn_run(parallel.shard_rows(4, r, n))
    out["prefetched"] = [type(b["x"]).__name__ for b in
                         parallel.device_prefetch(iter(_batches(3)), "cpu")]
    out["world"] = (r, n, parallel.backend(), [str(d) for d in parallel.current_mesh()])
    # each rank's own parameters and buffers, float32 and int64; then rank 0's
    bn = BatchNorm2d(3)
    with torch.no_grad():
        bn.weight.fill_(r + 1.0)
        bn.running_mean.fill_(10.0 * r)
    bn.num_batches_tracked.fill_(7 + r)
    parallel.replicate_([bn])
    out["replicated"] = {k: v.clone() for k, v in bn.state_dict().items()}
    return out


@pytest.fixture(scope="module")
def group_runs():
    return parallel.launch(_group_rank, CPU2)


def test_launch_runs_one_rank_per_device(group_runs):
    assert [g["world"] for g in group_runs] == [(0, 2, "gloo", ["cpu", "cpu"]),
                                                (1, 2, "gloo", ["cpu", "cpu"])]
    assert parallel.world_size() == 1 and parallel.rank() == 0  # the caller: no group


def test_replicate_takes_rank_0s_parameters_and_buffers(group_runs):
    for g in group_runs:
        got = g["replicated"]
        assert torch.equal(got["weight"], torch.ones(3))
        assert torch.equal(got["running_mean"], torch.zeros(3))
        assert int(got["num_batches_tracked"]) == 7


def test_prefetch_double_buffers_in_a_group(group_runs):
    assert all(g["prefetched"] == ["Tensor"] * 3 for g in group_runs)


def test_batchnorm_over_two_ranks_is_one_process(group_runs):
    want = _bn_run()
    for k in ("out", "dx", "frozen"):
        got = np.concatenate([g[k] for g in group_runs])
        np.testing.assert_allclose(got, want[k], atol=1e-12 * np.abs(want[k]).max(), rtol=0,
                                   err_msg=k)
    for k in ("dw", "db"):  # the loss is the ranks' sum: so is each affine gradient
        got = group_runs[0][k] + group_runs[1][k]
        np.testing.assert_allclose(got, want[k], atol=1e-12 * np.abs(want[k]).max(), rtol=0,
                                   err_msg=k)
    for g in group_runs:
        for which in ("stats", "frozen_stats"):
            for k, v in want[which].items():
                np.testing.assert_allclose(g[which][k], v, rtol=1e-13, atol=0,
                                           err_msg=f"{which} {k}")
        # the frozen pass moved nothing, and the ranks' statistics are one
        for k in want["stats"]:
            np.testing.assert_array_equal(g["stats"][k], g["frozen_stats"][k])
            np.testing.assert_array_equal(g["stats"][k], group_runs[0]["stats"][k])
    assert int(want["stats"]["num_batches_tracked"]) == 1


# ---------------------------------------------------------- the GRU step
GRU_H, GRU_W, GRU_B, GRU_T = 32, 64, 2, 2


def _gru_opts():
    return Options(height=GRU_H, width=GRU_W, batch_size=GRU_B, len_sequence=GRU_T,
                   gru_version="v10", compute_dtype="float32", gru_remat="1",
                   frame_ids=[0, -1, 1])


def _gru_batch():
    """A (B, T) batch of per-pixel noise frames (float64) with jitter on."""
    ds = SyntheticSeqDataset(GRU_H, GRU_W, n=GRU_T, length=GRU_B)
    batch = {k: v.astype(np.float64) for k, v in collate([ds[i] for i in range(GRU_B)]).items()}
    rs = np.random.RandomState(7)
    for i in (0, -1, 1):
        batch[f"color/{i}"] = rs.rand(GRU_B, GRU_T, GRU_H, GRU_W, 3)
    batch["jitter"] = np.array([[1.1, 0.9, 1.15, 0.05], [0.85, 1.1, 0.9, -0.07]])
    return batch


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def summary(models, state, losses):
    """What a step left, for the comparisons: the losses; on rank 0 (and in
    one process) the gradients, parameters, BatchNorm statistics; on every
    rank a digest of parameters, Adam moments and buffers."""
    params = [p for m in models.modules() for p in m.parameters()]
    buffers = [b for m in models.modules() for b in m.buffers()]
    moments = [s[k] for p in params for s in [state.optimizer.state.get(p, {})]
               for k in ("exp_avg", "exp_avg_sq") if k in s]
    out = {"losses": {k: float(v) for k, v in losses.items()},
           "digest": digest(params + moments + buffers)}
    if parallel.rank() == 0:  # tensors: torch.save pickles numpy arrays 13x slower
        out["grads"] = [None if p.grad is None else p.grad.clone() for p in params]
        out["params"] = [p.detach().clone() for p in params]
        out["buffers"] = [b.clone() for b in buffers]
    return out


def gru_step(batch):
    """One GRU v10 train step of this process's rows of ``batch`` (all of
    them outside a group), the networks in float64, the automask noise from
    a seeded generator."""
    models = steps_gru.build_gru_models(_gru_opts(), "cpu", torch.Generator().manual_seed(0))
    for m in models.modules():
        m.double()
    models.gru.kernel_scales = (False,) * 4  # the plain convs: conv3x3 takes no float64
    state = TrainState(models.parameters(), 1e-4, 0, 1)
    parallel.replicate_(models.modules())
    rows = parallel.shard_batch(batch, parallel.rank(), parallel.world_size())
    losses = steps_gru.train_step(models, state, {k: torch.from_numpy(v) for k, v in rows.items()},
                                  torch.Generator().manual_seed(11))
    parallel.all_reduce_mean_(list(losses.values()))
    return summary(models, state, losses)


def check_against_one_process(runs, want, rel=1e-9):
    """Rank 0 of ``runs`` against the one-process ``want``: losses and
    every gradient, parameter and buffer at ``rel`` of its tensor's max;
    every rank's digest the same."""
    assert len({r["digest"] for r in runs}) == 1, "the ranks differ"
    got = runs[0]
    for k, v in want["losses"].items():
        assert got["losses"][k] == pytest.approx(v, rel=rel, abs=0), k
    for which in ("grads", "params", "buffers"):
        assert len(got[which]) == len(want[which])
        for i, (g, w) in enumerate(zip(got[which], want[which])):
            assert (g is None) == (w is None), f"{which} {i}"
            if w is not None:
                g, w = g.numpy(), w.numpy()
                np.testing.assert_allclose(g, w, atol=rel * np.abs(w).max(), rtol=0,
                                           err_msg=f"{which} {i}")


def test_gru_step_over_two_ranks_is_the_one_process_step():
    batch = _gru_batch()
    assert steps_gru.remat_mode(_gru_opts()) == "1"
    want = gru_step(batch)
    runs = parallel.launch(gru_step, CPU2, batch)
    check_against_one_process(runs, want)
    assert np.isfinite(want["losses"]["loss"])
    assert sum(g is not None and bool(g.abs().max() > 0) for g in want["grads"]) > 100


# ------------------------------------------------------------- failures
def _failing_rank(how):
    if parallel.rank() == 1:
        if how == "raises":
            raise ValueError("rank 1 fails")
        time.sleep(600)  # hangs
    dist.all_reduce(torch.ones(1))


@pytest.mark.parametrize("how", ["raises", "hangs"])
def test_a_failing_rank_ends_the_run(how):
    """A rank that raises ends the run through spawn; one that hangs makes
    the other's collective raise at the group's timeout. Either way launch
    raises, in seconds, and no rank is left running."""
    t0 = time.perf_counter()
    with pytest.raises(torch.multiprocessing.ProcessRaisedException) as info:
        parallel.launch(_failing_rank, CPU2, how, timeout_s=5 if how == "hangs" else 60)
    assert time.perf_counter() - t0 < 60
    if how == "raises":
        assert "rank 1 fails" in str(info.value)
