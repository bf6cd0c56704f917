"""Data-parallel runs in several local processes: the dry run of the
data-parallel step, and the workers that the tests and ``chip_smoke.py``
start. The counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``.

``spawn(worker, n, *args)`` starts ``n`` processes (``torch.multiprocessing``),
forms a process group of them on localhost (on CUDA NCCL, or ``gloo`` when
asked, which lets the ranks share one card; ``gloo`` on the CPU) and calls
``worker(*args)`` in each. A worker writes what it found to files that the
caller reads; ``spawn`` raises if any worker raised or the run outlived its
time limit.

    python -m imm_tpu_torch.parallel.dryrun 2 [--device cpu]

runs two steps of the ``tiny_cpu`` preset on two ranks and checks that both
ranks end with the same parameters. On the card (the default) the ranks
share card 0 through ``gloo``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from imm_tpu_torch.parallel.distributed import initialize_multihost
from imm_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from imm_tpu_torch.utils.device import get_device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, n, port, device, backend, local_rank, timeout_s, threads, worker, args):
    if threads:
        torch.set_num_threads(threads)
    initialize_multihost(
        device=device, backend=backend, init_method=f"tcp://127.0.0.1:{port}", world_size=n,
        rank=rank, local_rank=local_rank, timeout_s=timeout_s,
    )
    try:
        worker(*args)
    finally:
        dist.destroy_process_group()


def spawn(worker, n: int, *args, device=None, backend: str | None = None,
          local_rank: int | None = None, timeout_s: float = 300.0, threads: int = 0) -> None:
    """Run ``worker(*args)`` in ``n`` ranks of a new process group on
    localhost. ``device``/``backend``/``local_rank`` go to
    ``initialize_multihost`` (``device`` None: the card; ``local_rank=0``
    puts every rank on the first card).
    ``threads`` > 0 caps each rank's intra-op threads. Raises if a rank
    fails, and stops every rank if the run outlives ``timeout_s``."""
    ctx = mp.start_processes(
        _entry, args=(n, _free_port(), device, backend, local_rank, timeout_s, threads, worker,
                      args),
        nprocs=n, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks of {worker.__name__} ran past {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def _same_on_every_rank(tensors, mesh: Mesh) -> bool:
    """Whether every rank holds the same values (bit for bit, NaNs aside):
    the elementwise maximum across ranks equals the minimum."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(torch.equal(hi, lo))


# -- the dry run -------------------------------------------------------------


def _dryrun_worker(steps: int, device: str) -> None:
    from imm_tpu_torch.configs import get_preset
    from imm_tpu_torch.experiment import build_experiment

    exp = build_experiment(get_preset("tiny_cpu"), device=device, total_steps=steps)
    state = exp.run()
    if state.host_step != steps or int(state.step) != steps:
        raise RuntimeError(f"rank {exp.mesh.rank} stopped at step {state.host_step}")
    if not _same_on_every_rank(list(exp.model.state_dict().values()), exp.mesh):
        raise RuntimeError("the ranks' parameters differ after the dry run")


def dryrun_multichip(n_devices: int, steps: int = 2, device=None) -> None:
    """Two steps of the ``tiny_cpu`` preset's data-parallel step on
    ``n_devices`` ranks: the batch split across the ranks, the state
    replicated, the gradients and BatchNorm statistics averaged. Raises
    unless every rank ends at ``steps`` with the same parameters.

    ``device`` None is the card: every rank on card 0 through ``gloo``, a
    check of the step and not a scaling figure. ``device='cpu'``: ``gloo``
    ranks on the CPU."""
    dev = get_device(device)
    spawn(_dryrun_worker, n_devices, steps, dev.type, device=dev.type, backend="gloo",
          local_rank=0, threads=1)


# -- one step on injected inputs ---------------------------------------------


def injected_steps(inputs: dict, device, mesh: Mesh | None = None) -> dict:
    """One ``train.steps._single_step`` on injected inputs, in float32 with
    TF32 off; with a mesh of several ranks on this rank's share of the
    batch. -> the state after it, on the CPU, and its metrics.

    ``inputs``: ``model`` (``IMMConfig``), ``loss`` (``PerceptualLossConfig``),
    ``train`` (``TrainConfig``), the model's ``state_dict``, ``loss_ema``,
    global-batch ``source`` and ``target`` (B, S, S, 3), and optionally
    ``equi`` = (view, source TPS params, target TPS params, n_grid, weight)
    and ``ent`` as ``_single_step`` takes them."""
    from imm_tpu_torch.losses.perceptual import ReconstructionLoss
    from imm_tpu_torch.models.imm import IMM
    from imm_tpu_torch.ops.tps import TPSParams
    from imm_tpu_torch.train.state import TrainState, make_optimizer
    from imm_tpu_torch.train.steps import _single_step

    # float32 convs and matmuls in full float32 on the card, in every rank
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    parallel = mesh is not None and mesh.size > 1
    cfg = inputs["model"]
    if parallel and cfg.norm == "batch" and cfg.axis_name is None:
        cfg = dataclasses.replace(cfg, axis_name="data")
    model = IMM(cfg).to(dev)
    model.load_state_dict(inputs["state_dict"])
    loss_fn = ReconstructionLoss(inputs["loss"], device=dev)
    optimizer = make_optimizer(inputs["train"])
    state = TrainState(
        step=torch.zeros((), dtype=torch.int32, device=dev), model=model,
        opt_state=optimizer.init(dict(model.named_parameters())),
        loss_ema=inputs["loss_ema"].to(dev),
    )

    def local(x):
        x = x.to(dev)
        return shard_batch(x, mesh) if parallel else x

    equi = inputs.get("equi")
    if equi is not None:
        view, ps, pt, n_grid, weight = equi
        equi = (local(view), TPSParams(*map(local, ps)), TPSParams(*map(local, pt)), n_grid, weight)
    state, metrics = _single_step(
        model, loss_fn, optimizer, state, local(inputs["source"]), local(inputs["target"]),
        mesh=mesh if parallel else None, equi=equi, ent=inputs.get("ent"),
    )
    return {
        "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "loss_ema": state.loss_ema.cpu(), "metrics": {k: float(v) for k, v in metrics.items()},
    }


def preset_step_inputs(config, batch: int, device) -> dict:
    """``injected_steps``' inputs for one step of ``config`` (an
    ``ExperimentConfig``) at its widths, in float32 with SGD: weights from
    seed 0, ``batch`` synthetic faces and their pair as the preset makes
    them, the equivariance and entropy terms as the preset weighs them. The
    tensors are on the CPU."""
    from imm_tpu_torch.data.pairs import PairSynthesizer
    from imm_tpu_torch.data.synthetic import SyntheticBlobFaces
    from imm_tpu_torch.losses.perceptual import n_loss_terms
    from imm_tpu_torch.models.imm import init_model

    dev = torch.device(device)
    # float32 throughout, the model and the loss's VGG; BatchNorm's variance
    # as E[x^2] - E[x]^2 in one process as on the ranks (``axis_name``): the
    # runs then differ only in the order of their sums
    model_cfg = dataclasses.replace(config.model, compute_dtype="float32", axis_name="data")
    model = init_model(model_cfg, seed=0, device=dev)
    faces = SyntheticBlobFaces(image_size=model_cfg.image_size)
    frames = faces.sample(torch.Generator(dev).manual_seed(11), batch)["image"]
    with torch.no_grad():
        source, target, ps, pt = PairSynthesizer(config.pair).pair_with_params(
            torch.Generator(dev).manual_seed(12), frames)

    def cpu(x):
        return x.detach().cpu()

    return dict(
        model=model_cfg, loss=dataclasses.replace(config.loss, compute_dtype="float32"),
        train=dataclasses.replace(config.train, optimizer="sgd"),
        state_dict={k: cpu(v) for k, v in model.state_dict().items()},
        loss_ema=torch.ones(n_loss_terms(config.loss)), source=cpu(source), target=cpu(target),
        equi=(cpu(source), tuple(map(cpu, ps)), tuple(map(cpu, pt)), config.pair.n_grid,
              config.train.equi_weight),
        ent=(config.train.ent_weight, model_cfg.temperature),
    )


def step_difference(before: dict, one: dict, other: dict) -> dict:
    """How far ``other``'s step lies from ``one``'s (``injected_steps``
    outputs, both from the state dict ``before``): ``param_rel``, the
    largest difference of the parameters' changes over the largest entry
    of ``one``'s change; ``loss_rel``, the loss's relative difference;
    ``stats_max_abs``, the BatchNorm statistics' largest difference."""
    params = [k for k in before if not k.endswith(("running_mean", "running_var"))]
    top = max((one["state_dict"][k] - before[k]).abs().max().item() for k in params)
    diff = {k: (other["state_dict"][k] - one["state_dict"][k]).abs().max().item() for k in params}
    worst = max(diff, key=diff.get)
    stats = [(other["state_dict"][k] - one["state_dict"][k]).abs().max().item()
             for k in before if k not in params]
    loss1, loss2 = one["metrics"]["loss/total"], other["metrics"]["loss/total"]
    return {"param_rel": diff[worst] / top, "param_rel_at": worst,
            "loss_rel": abs(loss2 - loss1) / abs(loss1), "stats_max_abs": max(stats, default=0.0)}


def injected_step_worker(inputs_path: str, device) -> None:
    """``injected_steps`` on this rank; writes ``rank<r>.pt`` beside the
    inputs."""
    inputs = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh()
    out = injected_steps(inputs, device, mesh)
    torch.save(out, Path(inputs_path).with_name(f"rank{mesh.rank}.pt"))


# -- an experiment on every rank ---------------------------------------------


def experiment_worker(inputs_path: str, device) -> None:
    """``build_experiment(config).run()`` on this rank; writes ``rank<r>.pt``
    beside the inputs: the state, the trainer's history, the kernels'
    launches and the run's seconds, and whether every rank ended with the
    same parameters.

    ``inputs``: ``config`` (``ExperimentConfig``), ``steps``, and optionally
    ``warmup_steps``: steps taken first and not counted in the launches or
    timed (on CUDA the kernels build and load during them). Without them a
    config with a workdir resumes from its latest checkpoint: a piece of a
    run."""
    from imm_tpu_torch.experiment import build_experiment
    from imm_tpu_torch.ops import kernel_counts, reset_kernel_counts

    inputs = torch.load(inputs_path, weights_only=False)
    warmup, steps = inputs.get("warmup_steps", 0), inputs["steps"]
    # built for every step: a file-backed stream is bounded to the run's steps
    exp = build_experiment(inputs["config"], device=device, total_steps=warmup + steps)
    if warmup:
        exp.trainer.total_steps = warmup
        exp.run()
    elif exp.config.workdir:
        exp.state = exp.trainer.restore_or_init()
    exp.trainer.total_steps = warmup + steps
    reset_kernel_counts()
    sync = torch.cuda.synchronize if exp.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    state = exp.trainer.run()
    sync()
    seconds = time.perf_counter() - t0
    launches = kernel_counts()
    tensors = list(exp.model.state_dict().values())
    torch.save({
        "rank": exp.mesh.rank, "world": exp.mesh.size, "host_step": state.host_step,
        "state_dict": {k: v.detach().cpu() for k, v in exp.model.state_dict().items()},
        "loss_ema": state.loss_ema.cpu(), "history": exp.trainer.history,
        "rng": exp.trainer.gen.get_state(),
        "launches": launches, "seconds": seconds, "steps": steps,
        "same_on_every_rank": _same_on_every_rank(tensors, exp.mesh),
    }, Path(inputs_path).with_name(f"rank{exp.mesh.rank}.pt"))


def worker_sequence(calls) -> None:
    """Each ``(worker, args)`` of ``calls`` in turn, in one process group."""
    for worker, args in calls:
        worker(*args)


def collectives_probe_worker(out_path: str) -> None:
    """One all-reduce and one broadcast of tensors on this rank's device;
    writes what came back and the backend to ``out_path`` (rank 0)."""
    mesh = make_mesh()
    dev = torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else None
    x = torch.arange(4, dtype=torch.float32, device=dev) + mesh.rank
    dist.all_reduce(x, group=mesh.group)
    y = torch.full((3,), float(mesh.rank + 7), device=dev)
    dist.broadcast(y, src=0, group=mesh.group)
    if mesh.rank == 0:
        torch.save({"all_reduce": x.cpu(), "broadcast": y.cpu(), "world": mesh.size,
                    "backend": dist.get_backend(mesh.group), "device": str(x.device)}, out_path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Two data-parallel steps of tiny_cpu on N ranks.")
    parser.add_argument("n", nargs="?", type=int, default=2, help="ranks (default 2)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    dryrun_multichip(args.n, device=args.device)
    print(f"dryrun_multichip({args.n}): 2 steps of tiny_cpu on {args.n} gloo ranks "
          f"({args.device}), the same parameters on every rank ({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
