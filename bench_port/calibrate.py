"""The readings that the limits of ``correct`` are set from, at a cell's own
size, in one process: the program on a dozen seeds or more (the lower
reading), and on three seeds or more the control, the plain reference
computed in float8 in the program's place, and each planted fault that the
cell can have (the upper reading).

    python3 -m bench_port.calibrate --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 [--out readings.jsonl] [--program-dtype float32]

Training: each seed loads fresh weights into one experiment and takes the
first call, as a run's set-up does; the faults are a state left unchanged
and the mean taken over half of the batch. Serving: each seed draws a pool
and the program generates every pair of it once; the faults are an image
altered where it is produced and half of the batch left out. One JSON line
per reading.

``--program-dtype float32`` runs the program in float32 (TF32 off, as the
reference) in place of the configuration's bfloat16: the witness that a gap
of the program's own runs comes from its precision, read as
``program_float32``. Needs a card; exits with code 2 without one.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from bench_port.cell import load_cell
from bench_port.compare import image_gap, train_numbers
from bench_port.run import Clock


def _train(cell, driver, seeds, control_seeds, emit, label):
    from bench_port.reference.model import Precision, load_vgg, strict_fp32
    from bench_port.reference.train import TrainReference
    from bench_port.traffic.train_steps import FOLLOWED

    strict_fp32()
    vgg = load_vgg(cell.config["loss"]["trained_weights"], driver.device)
    plain = TrainReference(cell.config, vgg)
    faults = {"control_fp8": TrainReference(cell.config, vgg, Precision(fp8=True)),
              "half_batch": TrainReference(cell.config, vgg, half_batch=True)}
    for seed in seeds:
        driver.start(seed)
        ref = plain.follow(driver.weights, driver.data_seed, FOLLOWED)
        emit(seed, label, *train_numbers(driver.program_readings(), ref, driver.weights))
        if seed not in control_seeds:
            continue
        for who, other in faults.items():
            got = other.follow(driver.weights, driver.data_seed, FOLLOWED)
            emit(seed, who, *train_numbers(got, ref, driver.weights))
        unchanged = {"raw": torch.ones_like(ref["raw"]),
                     "grad0": {k: torch.zeros_like(v) for k, v in ref["grad0"].items()},
                     "params": driver.weights, "ema": driver.weights, "stats": driver.weights,
                     "stats1": driver.weights}
        emit(seed, "state_unchanged", *train_numbers(unchanged, ref, driver.weights))


def _serve(cell, driver, seeds, control_seeds, emit, label):
    from bench_port.reference.model import IMMReference, Precision, strict_fp32

    strict_fp32()
    plain = IMMReference(cell.config["model"])
    fp8 = IMMReference(cell.config["model"], Precision(fp8=True))
    for seed in seeds:
        driver.start(seed)
        js = range(len(driver.pool))
        outs = [(j, j, driver.fn(*driver.pool[j])) for j in js]
        with torch.no_grad():
            refs = {j: plain.swap(driver.weights, *driver.pool[j]) for j in js}
            gap, at = image_gap(outs, refs)
            emit(seed, label, {"image_gap": gap}, {"image_gap": at})
            if seed not in control_seeds:
                continue
            control = [(j, j, fp8.swap(driver.weights, *driver.pool[j])) for j in js]
            altered = [(j, j, torch.cat([r[1:2], r[1:]])) for j, r in refs.items()]
            half = [(j, j, torch.cat([r[: len(r) // 2], torch.zeros_like(r[len(r) // 2:])]))
                    for j, r in refs.items()]
            for who, got in (("control_fp8", control), ("answer_altered", altered),
                             ("half_batch", half)):
                g, a = image_gap(got, refs)
                emit(seed, who, {"image_gap": g}, {"image_gap": a})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control-seeds", default="", help="comma-separated, a subset of --seeds")
    p.add_argument("--out", default="")
    p.add_argument("--program-dtype", choices=("float32",), default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("[bench_port] calibrate needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    overrides, label = None, "program"
    if args.program_dtype:
        from bench_port.reference.model import strict_fp32

        strict_fp32()
        block = load_cell(args.workload).config
        dtype = {"compute_dtype": args.program_dtype}
        overrides = {"experiment": {k: dtype for k in ("model", "loss") if k in block}}
        label, control = f"program_{args.program_dtype}", set()
    cell = load_cell(args.workload, overrides=overrides)
    kind = cell.traffic["kind"]
    driver = cell.module("traffic", kind).Driver(cell, seeds[0], torch.device("cuda"), Clock())
    driver.setup()
    out = open(args.out, "a") if args.out else None

    def emit(seed, who, numbers, where):
        line = json.dumps({"cell": cell.name, "seed": seed, "who": who, "numbers": numbers,
                           "where": where})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        {"train_steps": _train, "swap_calls": _serve}[kind](cell, driver, seeds, control, emit, label)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
