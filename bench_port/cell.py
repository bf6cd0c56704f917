"""A cell and everything it names, found by name in the benchmark's folders:
``workloads/<cell>.json`` (its configuration, traffic mix, chips and the
limits of its correctness check), ``configs/<config>.json`` (the model and
recipe as run) and ``traffic/<mix>.json`` (the mix's parameters and the
``kind`` of traffic, whose driver is ``traffic/<kind>.py``). Which metrics a
cell reports comes from ``BENCHMARK.json`` at the checkout's root."""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def merge(base: dict, over: dict | None) -> dict:
    """``base`` with the keys of ``over`` put in, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict  # the configuration's ``experiment`` block
    traffic_name: str
    traffic: dict
    limits: dict[str, float]
    home: Path  # the benchmark's folder
    e2e: list[dict]  # BENCHMARK.json end-to-end entries this cell reports
    per_layer: list[dict]  # and its per-layer entries

    def module(self, folder: str, name: str):
        """The Python file ``<folder>/<name>.py`` of the benchmark, loaded by path."""
        path = self.home / folder / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"bench_port_{folder}_{name}".replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def _reports(entry: dict, cell: str, e2e_names: set[str] | None = None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return e2e_names is None or entry["moves"] in e2e_names


def load_cell(name: str, home: Path = HERE, overrides: dict | None = None) -> Cell:
    """The cell ``name`` under the benchmark folder ``home``; ``overrides``
    ({"experiment": ..., "traffic": ..., "limits": ...}) are merged in (the
    CPU tests shrink a cell so)."""
    overrides = overrides or {}
    work = _read(home / "workloads" / f"{name}.json")
    config = _read(home / "configs" / f"{work['config']}.json")
    traffic = _read(home / "traffic" / f"{work['traffic']}.json")
    bench = _read(home.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is not None and (entry["config"], entry["traffic"], entry["chips"]) != (
            work["config"], work["traffic"], work["chips"]):
        raise ValueError(f"BENCHMARK.json and workloads/{name}.json disagree about the cell")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(
        name=name, chips=work["chips"], config_name=work["config"],
        config=merge(config["experiment"], overrides.get("experiment")),
        traffic_name=work["traffic"], traffic=merge(traffic, overrides.get("traffic")),
        limits=merge(work["limits"], overrides.get("limits")), home=home,
        e2e=e2e, per_layer=per_layer,
    )


def experiment_config(block: dict):
    """The program's ``ExperimentConfig`` of a configuration's ``experiment``
    block (lists become tuples)."""
    from imm_tpu_torch.models.imm import IMMConfig
    from imm_tpu_torch.utils.config import (
        DataConfig,
        ExperimentConfig,
        PairConfig,
        PerceptualLossConfig,
        TrainConfig,
    )

    def tup(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    kinds = {"model": IMMConfig, "train": TrainConfig, "pair": PairConfig,
             "loss": PerceptualLossConfig, "data": DataConfig}
    return ExperimentConfig(**{k: kinds[k](**tup(v)) if k in kinds else v for k, v in block.items()})
