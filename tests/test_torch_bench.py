"""The port's bench (``python -m imm_tpu_torch.bench``) at a tiny config on
the CPU, as ``tests/test_bench.py`` runs the JAX bench: the records' keys,
positive rates, and a device that says it is the CPU (its times are the
host clock's, not a device's)."""

import json

from imm_tpu_torch import bench
from imm_tpu_torch.models.imm import IMMConfig
from imm_tpu_torch.utils.config import PerceptualLossConfig
from tests.torch_parity import TINY


def test_bench_train_smoke():
    rec = bench.bench_train(
        batch=4, scan=2, loss_cfg=PerceptualLossConfig(feature_source="pixel", weights=(1, 1, 1)),
        cfg=IMMConfig(**TINY), device="cpu", steps=2, warmup=1,
    )
    assert rec["metric"] == "train_images_per_sec" and rec["unit"] == "images/sec"
    assert rec["value"] > 0 and rec["step_ms_p50"] > 0 and rec["step_ms_p90"] >= rec["step_ms_p50"]
    assert rec["batch"] == 4 and rec["scan"] == 2 and rec["preset"] == "synthetic_best"
    assert rec["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert "not a device time" in rec["timing"]
    assert "vs_baseline" not in rec


def test_bench_inference_smoke():
    rec = bench.bench_inference(4, cfg=IMMConfig(**TINY), device="cpu", reps=3, warmup=1)
    assert rec["metric"] == "landmark_images_per_sec" and rec["unit"] == "images/sec"
    assert rec["batch"] == 4 and rec["value"] > 0 and rec["swap_images_per_sec"] > 0
    assert rec["latency_ms_batch1"] > 0 and rec["swap_latency_ms_batch1"] > 0
    assert rec["device"]["platform"] == "cpu" and "vs_baseline" not in rec
    json.dumps(rec)  # one JSON line


def test_bench_main_prints_one_json_line(capsys, monkeypatch):
    monkeypatch.setattr(bench, "bench_inference",
                        lambda batch, device, reps: {"metric": "m", "batch": batch, "reps": reps})
    bench.main(["--mode", "inference", "--batch", "8", "--device", "cpu"])
    bench.main(["--mode", "inference", "--batch", "8", "--device", "cpu", "--steps", "7"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in lines] == [
        {"metric": "m", "batch": 8, "reps": 100}, {"metric": "m", "batch": 8, "reps": 7}]
