"""What the data-parallel step check of ``chip_smoke.py`` can tell apart.

    python3 scripts/dp_step_tolerance.py [--device cpu] [--preset tiny_cpu] [--batch 16]

One step of a preset (default ``synthetic_best`` at B=128 on the card, in
float32 with SGD, as the smoke's ``data_parallel`` phase takes it) in one
process and on two ``gloo`` ranks of half the batch each (on the card both
ranks share card 0), from the same weights and images. Runs:

- ``one``: one process, BatchNorm's two-pass variance (no ``axis_name``:
  single-process training);
- ``one_fast``: one process with ``axis_name``, the variance as
  E[x^2] - E[x]^2, the formula the ranks use (the smoke's reference);
- ``ranks``: two ranks, the package as it is;
- ``fault_plain``: two ranks whose BatchNorm all-reduces its statistics
  with a plain ``dist.all_reduce``, which autograd does not see;
- ``fault_local``: two ranks whose statistics are the global ones in value
  but carry only the rank's own gradient;
- ``one_adam``, ``ranks_adam``: ``one`` and ``ranks`` with Adam.

Prints one JSON line for each pair compared (``step_difference``: the
parameter change's largest difference over its largest entry, the loss's
relative difference, the BatchNorm statistics' largest difference). The
faults exist only in this script, as patches of the ranks' processes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from imm_tpu_torch.configs import get_preset  # noqa: E402
from imm_tpu_torch.models import nets  # noqa: E402
from imm_tpu_torch.parallel import dryrun  # noqa: E402
from imm_tpu_torch.parallel.mesh import make_mesh  # noqa: E402


def _plain_all_reduce(x, mesh):
    y = x.clone()
    dist.all_reduce(y, group=mesh.group)
    return y / mesh.size


def _local_gradient(x, mesh):
    y = x.detach().clone()
    dist.all_reduce(y, group=mesh.group)
    return x + (y / mesh.size - x).detach()


PATCHES = {"fault_plain": ("all_reduce_mean", _plain_all_reduce),
           "fault_local": ("all_reduce_mean", _local_gradient)}


def run(inputs: dict, device, variant: str, mesh=None) -> dict:
    patch = PATCHES.get(variant)
    saved = getattr(nets, patch[0]) if patch else None
    if patch:
        setattr(nets, patch[0], patch[1])
    try:
        return dryrun.injected_steps(inputs, device, mesh)
    finally:
        if patch:
            setattr(nets, patch[0], saved)


RANK_RUNS = (("ranks", "sgd"), ("fault_plain", "sgd"), ("fault_local", "sgd"),
             ("ranks_adam", "adam"))  # variant, its inputs


def rank_worker(work: str, device: str) -> None:
    mesh = make_mesh()
    for variant, inputs in RANK_RUNS:
        inputs = torch.load(Path(work) / f"{inputs}.pt", weights_only=False)
        out = run(inputs, device, variant, mesh)
        if mesh.rank == 0:
            torch.save(out, Path(work) / f"{variant}.out.pt")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--preset", default="synthetic_best")
    parser.add_argument("--batch", type=int, default=128)
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
    sgd = dryrun.preset_step_inputs(get_preset(args.preset), args.batch, dev)
    adam = dict(sgd, train=dataclasses.replace(sgd["train"], optimizer="adam"))
    with tempfile.TemporaryDirectory() as work:
        for name, inputs in (("sgd", sgd), ("adam", adam)):
            torch.save(inputs, Path(work) / f"{name}.pt")
        t0 = time.perf_counter()
        dryrun.spawn(rank_worker, 2, work, dev.type, device=dev.type, backend="gloo",
                     local_rank=0, timeout_s=900, threads=1)
        spawn_s = time.perf_counter() - t0
        out = {v: torch.load(Path(work) / f"{v}.out.pt", weights_only=False) for v, _ in RANK_RUNS}
    two_pass = dict(sgd, model=dataclasses.replace(sgd["model"], axis_name=None))
    out["one"] = run(two_pass, dev, "one")
    out["one_fast"] = run(sgd, dev, "one_fast")
    out["one_adam"] = run(adam, dev, "one_adam")
    before = sgd["state_dict"]
    for other, one in (("one_fast", "one"), ("ranks", "one"), ("ranks", "one_fast"),
                       ("fault_plain", "one"), ("fault_plain", "one_fast"),
                       ("fault_local", "one"), ("fault_local", "one_fast"),
                       ("ranks_adam", "one_adam")):
        print(json.dumps({"compare": f"{other} against {one}", "preset": args.preset,
                          "batch": args.batch, "device": args.device, "card": card,
                          **dryrun.step_difference(before, out[one], out[other])}), flush=True)
    print(json.dumps({"spawn_s": spawn_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
