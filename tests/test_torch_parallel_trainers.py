"""The training entry points over 2 gloo ranks on the CPU: ``train_gru``,
``train_fusion`` and ``train_fusion_v3`` with ``--no_cuda --num_devices 2``
(``train_dpt``'s run is tests/test_torch_mono_step.py's
``test_more_than_one_device_trains``). Each ``main()`` trains its
synthetic epoch in two processes (``train.trainer.train_main`` through
``parallel.launch``) and returns None; the mesh is printed once, each rank
names itself, and rank 0 alone logs, validates and writes ``weights_0/``
with the trainer's module files. The steps themselves are held against the
one-process step in tests/test_torch_parallel.py (GRU) and
tests/test_torch_parallel_step.py (mono).
"""

import os

import numpy as np
import pytest
import torch

from ssde_tpu_torch.scripts import train_fusion, train_fusion_v3, train_gru
from test_torch_parallel import _one_torch_thread  # noqa: F401

RUNS = {  # label: (entry point, extra arguments, module files of weights_0)
    "gru": (train_gru, ["--gru_version", "v10", "--len_sequence", "2"], ["gru.pth"]),
    "fusion": (train_fusion, [], ["fusion.pth"]),
    "fusion_v3": (train_fusion_v3, [], ["fusion.pth"]),
}


@pytest.mark.parametrize("label", sorted(RUNS))
def test_entry_point_trains_over_two_ranks(label, tmp_path, capfd):
    script, extra, files = RUNS[label]
    argv = ["--synthetic_data", "--no_cuda", "--num_devices", "2", "--height", "32",
            "--width", "64", "--batch_size", "2", "--num_epochs", "1", "--num_workers", "1",
            "--log_frequency", "8", "--log_dir", str(tmp_path), *extra]
    assert script.main(argv) is None  # the trainers live in the ranks
    out = capfd.readouterr().out
    assert "Training is using mesh: data=2 [cpu, cpu] over gloo" in out
    assert "Device: cpu, rank 0 of 2" in out and "Device: cpu, rank 1 of 2" in out
    assert out.count("Training model named") == 1 and out.count("saved model to") == 1
    steps = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(steps) == 1 and np.isfinite(float(steps[0].split("loss:")[1].split("|")[0]))
    vals = [ln for ln in out.splitlines() if ln.startswith("val ")]
    assert len(vals) == 1 and np.isfinite(float(vals[0].split()[2]))
    folder = tmp_path / "mdp" / "models" / "weights_0"
    names = sorted(os.listdir(folder))
    assert set(files + ["adam.pth", "encoder.pth", "depth.pth"]) <= set(names), names
    adam = torch.load(folder / "adam.pth", weights_only=True)
    want = 4 if label == "gru" else 8  # the synthetic epoch's global batches
    assert {int(s["step"]) for s in adam["state"].values()} == {want}
