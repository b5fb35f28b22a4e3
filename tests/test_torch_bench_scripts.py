"""The port's bench entry points, on the CPU.

``ssde_tpu_torch.scripts.bench_infer``, ``bench_gru`` and ``bench_loader``
are the counterparts of ``scripts/bench_infer.py``, ``bench_gru.py`` and
``bench_loader.py``: here each runs at 64x128 with ``device="cpu"`` and
prints the JAX script's JSON keys (the times are the CPU's and are not
checked); without a card and without ``device`` each CLI raises. The
Loader's process pool, which ``bench_loader`` times, is held to the JAX
Loader in ``tests/test_torch_preprocess.py``.
"""

import json

import pytest
import torch

from ssde_tpu_torch.scripts import bench_gru, bench_infer, bench_loader

H, W = 64, 128
# the keys of the JAX scripts' JSON lines (scripts/bench_infer.py:71-77,
# scripts/bench_gru.py:56-62)
INFER_KEYS = {"metric", "value", "unit", "batch", "ms_per_batch"}
GRU_KEYS = {"metric", "value", "unit", "batch", "seq_len", "ms_per_step"}
SMALL_JPEGS = ["--n_images", "8", "--width", str(W), "--height", str(H), "--src_width", "320",
               "--src_height", "96", "--batch_size", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The steps here take one torch thread: beside the other workers of a
    parallel pytest run a thread pool in every process oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_bench_infer_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_BATCH", "2")
    result, disp = bench_infer.main("cpu", H, W)
    out = capsys.readouterr().out
    assert "device: cpu" in out and _json_lines(out) == [result]
    assert set(result) == INFER_KEYS
    assert result["metric"] == f"kitti_{W}x{H}_depth_infer_frames_per_sec_per_chip"
    assert result["unit"] == "frames/s" and result["batch"] == 2 and result["value"] > 0
    assert disp.shape == (2, 1, H, W) and torch.isfinite(disp).all()
    assert 0 < disp.min() and disp.max() < 1


def test_bench_gru_on_the_cpu(monkeypatch, capsys):
    for k, v in dict(BENCH_GRU_VERSIONS="v10", BENCH_BATCH="1", BENCH_T="2", BENCH_STEPS="1",
                     BENCH_H=str(H), BENCH_W=str(W)).items():
        monkeypatch.setenv(k, v)
    results = bench_gru.main("cpu")
    out = capsys.readouterr().out
    assert _json_lines(out) == results and len(results) == 1
    (result,) = results
    assert set(result) == GRU_KEYS
    assert result["metric"] == f"kitti_{W}x{H}_gru_v10_train_frame_samples_per_sec"
    assert (result["unit"], result["batch"], result["seq_len"]) == ("frame-samples/s", 1, 2)
    assert result["value"] > 0


def test_bench_loader_tables_on_the_cpu(capsys):
    rows = bench_loader.main(SMALL_JPEGS + ["--workers", "1,2"], "cpu")
    out = capsys.readouterr().out
    assert [(kind, w) for kind, w, _, _ in rows] == [
        ("thread", 1), ("thread", 2), ("process", 1), ("process", 2)]
    assert all(items > 0 and frames == pytest.approx(3 * items) for _, _, items, frames in rows)
    assert "8 JPEGs 320x96 -> 128x64, 3 frames/item, batch 2 [cpu]" in out
    assert f"{'pool':>9} {'workers':>7} {'items/s':>9} {'frames/s':>9}" in out


@pytest.mark.parametrize("cache", [False, True])
def test_bench_loader_fed_on_the_cpu(capsys, cache):
    rates = bench_loader.main(
        SMALL_JPEGS + ["--fed", "--fed_epochs", "1"] + (["--cache"] if cache else []), "cpu")
    out = capsys.readouterr().out
    assert list(rates) == ["direct", "device_prefetch", "plain_put_prefetch", "direct2"]
    assert all(r > 0 for r in rates.values())
    mode = "uint8-cache" if cache else "jpeg-decode"
    for label in rates:
        assert f"loader-fed step [{mode}, 2 workers, {label}]: " in out
    assert ("cache prime: " in out) == cache


def test_the_clis_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (bench_infer.main, bench_gru.main, lambda: bench_loader.main([])):
        with pytest.raises(RuntimeError, match="no CUDA card is available"):
            main()
