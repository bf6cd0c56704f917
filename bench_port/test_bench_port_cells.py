"""The harness end to end on the CPU at a tiny size: each cell, the reference
against the program, the planted faults and the control failing the check,
a third cell added as new files only, and the data files against
``BENCHMARK.json``. The tests marked ``cuda`` run the cells and the control
on the card at their own sizes and skip without one.

The tiny cells compute in float32 on the program's side, so the program
and the reference agree to rounding; the faults and the control are held to
the cells' own limits."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_port.cell import load_cell
from bench_port.compare import train_numbers, verdict
from bench_port.run import run_cell

HOME = Path(__file__).resolve().parent
CHECKOUT = HOME.parent
SEED = 3_141_592_653
TINY_MODEL = {"image_size": 32, "filters": [8, 8, 16, 16], "strides": [1, 2, 1, 2],
              "decoder_filters": [16, 8, 8], "compute_dtype": "float32"}
TINY = {
    "train_k10_tps_b128": {
        "experiment": {"model": TINY_MODEL, "train": {"batch_size": 4, "steps_per_call": 5},
                       "loss": {"compute_dtype": "float32"}},
        "traffic": {"trace_wait": 1, "trace_warmup": 1, "trace_steps": 2}},
    "serve_k10_swap_b128": {
        "experiment": {"model": TINY_MODEL},
        "traffic": {"batch": 4, "pool": 2, "warmup_calls": 1, "keep_share": 0.5,
                    "trace_warmup": 1, "trace_calls": 2}},
}
CELLS = sorted(TINY)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_end_to_end_on_the_cpu(name, trace):
    r = run_cell(name, SEED, 0.5, bool(trace), device="cpu", overrides=TINY[name])
    assert r["correct"] is True
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    cell = load_cell(name)
    if trace:
        # CPU runs have no device trace: the device metrics find nothing to read
        assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(r["metrics"]) == {m["name"] for m in cell.e2e}
        assert all(m["value"] > 0 for m in r["metrics"].values())


def test_reference_matches_the_program_in_float32():
    r = run_cell("train_k10_tps_b128", SEED + 1, 0.1, False, device="cpu",
                 overrides=TINY["train_k10_tps_b128"])
    got = {k: v["value"] for k, v in r["checks"].items()}
    assert got["loss0_gap"] < 1e-5 and got["grad_median_gap"] < 1e-5 and got["stats1_gap"] < 1e-5
    assert got["change_gap"] < 1e-3  # Adam's first steps amplify rounding
    r = run_cell("serve_k10_swap_b128", SEED + 1, 0.1, False, device="cpu",
                 overrides=TINY["serve_k10_swap_b128"])
    assert r["checks"]["image_gap"]["value"] < 1e-5


def _unchanged_step(model, loss_fn, optimizer, state, source, target, **kw):
    """A step that runs the forward pass and returns its state unchanged."""
    with torch.no_grad():
        model(source, target)
    return state, {"loss/total": torch.zeros(())}


def _half_batch_step(original):
    def step(model, loss_fn, optimizer, state, source, target, equi=None, **kw):
        h = source.shape[0] // 2
        if equi is not None:
            view, pv, pt, n_grid, w = equi
            cut = lambda p: type(p)(*(x[:h] for x in p))  # noqa: E731
            equi = (view[:h], cut(pv), None if pt is None else cut(pt), n_grid, w)
        return original(model, loss_fn, optimizer, state, source[:h], target[:h], equi=equi, **kw)

    return step


def _altered_swap(original):
    def swap(model):
        fn = original(model)

        def altered(a, p):
            out = fn(a, p).clone()
            out[0] = out[-1]
            return out

        return altered

    return swap


def _half_swap(original):
    def swap(model):
        fn = original(model)

        def half(a, p):
            out = fn(a, p).clone()
            out[len(out) // 2:] = 0
            return out

        return half

    return swap


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered",
                                   "half_batch_served"])
def test_a_planted_fault_fails_the_check(fault, monkeypatch):
    import imm_tpu_torch.eval.swap as swap_module
    import imm_tpu_torch.train.steps as steps

    if fault == "state_unchanged":
        monkeypatch.setattr(steps, "_single_step", _unchanged_step)
    elif fault == "half_batch":
        monkeypatch.setattr(steps, "_single_step", _half_batch_step(steps._single_step))
    elif fault == "answer_altered":
        monkeypatch.setattr(swap_module, "swap_fn", _altered_swap(swap_module.swap_fn))
    else:
        monkeypatch.setattr(swap_module, "swap_fn", _half_swap(swap_module.swap_fn))
    name = "serve_k10_swap_b128" if fault.startswith(("answer", "half_batch_")) else "train_k10_tps_b128"
    overrides = json.loads(json.dumps(TINY[name]))
    if name == "serve_k10_swap_b128":
        overrides["traffic"]["keep_share"] = 1.0
    r = run_cell(name, SEED + 2, 0.1, False, device="cpu", overrides=overrides)
    assert r["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_the_float8_control_fails_the_check(name):
    """The plain reference in float8, put in the program's place, at the tiny
    size: the cell's own limits refuse it."""
    from bench_port.compare import image_gap
    from bench_port.reference.model import IMMReference, Precision, load_vgg
    from bench_port.reference.train import TrainReference
    from bench_port.weights import make_weights

    cell = load_cell(name, overrides=TINY[name])
    cfg, cpu = cell.config, torch.device("cpu")
    weights = make_weights(cfg["model"], SEED, cpu)
    if name == "train_k10_tps_b128":
        vgg = load_vgg(cfg["loss"]["trained_weights"], cpu)
        ref = TrainReference(cfg, vgg).follow(weights, SEED, 3)
        control = TrainReference(cfg, vgg, Precision(fp8=True)).follow(weights, SEED, 3)
        numbers, _ = train_numbers(control, ref, weights)
    else:
        from bench_port.reference.data import blob_faces

        gen = torch.Generator().manual_seed(SEED)
        a, p = blob_faces(gen, 8, 32), blob_faces(gen, 8, 32)
        with torch.no_grad():
            ref = IMMReference(cfg["model"]).swap(weights, a, p)
            control = IMMReference(cfg["model"], Precision(fp8=True)).swap(weights, a, p)
        numbers = {"image_gap": image_gap([(0, 0, control)], {0: ref})[0]}
    assert not verdict(numbers, load_cell(name).limits)


@pytest.mark.parametrize("name", CELLS)
def test_calibration_names_each_reading_by_its_side(name):
    """The readings that the limits are set from, at the tiny size: each seed
    one of the program, and each control seed one of the control and of
    each planted fault, every one under its own name."""
    from bench_port import calibrate
    from bench_port.run import Clock

    cell = load_cell(name, overrides=TINY[name])
    driver = cell.module("traffic", cell.traffic["kind"]).Driver(
        cell, SEED, torch.device("cpu"), Clock())
    driver.setup()
    rows = []
    readings = {"train_steps": calibrate._train, "swap_calls": calibrate._serve}
    seeds = [SEED, SEED + 1]
    readings[cell.traffic["kind"]](cell, driver, seeds, set(seeds),
                                   lambda seed, who, numbers, where: rows.append((seed, who)),
                                   "program")
    sides = [[who for s, who in rows if s == seed] for seed in seeds]
    assert sides[0] == sides[1] and sides[0].count("program") == 1
    assert len(set(sides[0])) == len(sides[0]) >= 3


def _digest(folder: Path) -> dict[str, str]:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_third_cell_is_new_files_only(tmp_path):
    """A serving cell at another batch and pool, added as a workload file and
    a traffic file beside a copy of the benchmark: found and run by name,
    with no file of the copy edited."""
    home = tmp_path / "bench_port"
    shutil.copytree(HOME, home, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    before = _digest(home)
    mix = json.loads((home / "traffic" / "closed_swap_b128_pool8.json").read_text())
    mix.update(batch=2, pool=3, keep_share=1.0)
    (home / "traffic" / "closed_swap_b2_pool3.json").write_text(json.dumps(mix))
    work = json.loads((home / "workloads" / "serve_k10_swap_b128.json").read_text())
    work["traffic"] = "closed_swap_b2_pool3"
    (home / "workloads" / "serve_k10_swap_b2.json").write_text(json.dumps(work))
    bench["workloads"].append({"name": "serve_k10_swap_b2", "config": "swap_k10",
                               "traffic": "closed_swap_b2_pool3", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "serve_k10_swap_b128" in m.get("workloads", ()):
            m["workloads"].append("serve_k10_swap_b2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    r = run_cell("serve_k10_swap_b2", SEED, 0.1, False, device="cpu", home=home,
                 overrides={"experiment": {"model": TINY_MODEL}})
    assert r["correct"] is True
    assert set(r["metrics"]) == {"serve_images_per_s", "serve_ms_p95", "setup_s"}
    after = _digest(home)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"traffic/closed_swap_b2_pool3.json",
                                        "workloads/serve_k10_swap_b2.json"}


def test_benchmark_json_names_the_files_that_exist():
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (CHECKOUT / c["file"]).is_file()
        assert json.loads((CHECKOUT / c["file"]).read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert (cell.config_name, cell.traffic_name, cell.chips) == (w["config"], w["traffic"], w["chips"])
        assert (HOME / "traffic" / f"{cell.traffic['kind']}.py").is_file()
        assert cell.limits and cell.e2e and cell.per_layer
        assert {m["moves"] for m in cell.per_layer} <= {m["name"] for m in cell.e2e}
    for m in bench["per_layer"]:
        assert (HOME / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload", name, "--seed", str(SEED),
         "--seconds", "3", "--trace", "0"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_card_at_the_cells_size(card, name, tmp_path):
    out = tmp_path / "readings.jsonl"
    seeds = "1001,1002,1003"
    subprocess.run([sys.executable, "-m", "bench_port.calibrate", "--workload", name, "--seeds",
                    seeds, "--control-seeds", seeds, "--out", str(out)],
                   cwd=CHECKOUT, check=True, timeout=1200)
    limits = load_cell(name).limits
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert all(verdict(r["numbers"], limits) for r in rows if r["who"] == "program")
    assert not any(verdict(r["numbers"], limits) for r in rows if r["who"] != "program")
