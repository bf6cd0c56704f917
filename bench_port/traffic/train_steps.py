"""Traffic kind ``train_steps``: a closed loop of back-to-back calls of the
program's training step, ``Experiment.step_fn``, each of the recipe's
``steps_per_call`` optimizer steps on pairs the step draws on the device;
after each call the host reads the call's loss, as the trainer does at its
log points. The window runs whole calls until ``--seconds`` have passed.

Set-up builds one experiment, loads the weights made from the seed into its
state (``load_flat_state``, the program's checkpoint loader) and takes its
first call: the warm-up, and the three steps the reference follows. A
forward pre-hook on the model marks the steps of that call; at the start of
steps 1, 2 and 3 it keeps the loss-balancing EMA (whose first value is the
first step's raw loss terms, and from which each later step's follow), at
step 1 Adam's first moment (the first gradient times 1 - b1), at step 3
the parameters, their EMA and the BatchNorm statistics.

Mix parameters (``traffic/<mix>.json``): ``trace_wait``, ``trace_warmup``,
``trace_steps``: the profiled slice within one call, in steps.
"""

from __future__ import annotations

import math
import time

import torch

FOLLOWED = 3


class Driver:
    unit = "step"

    def __init__(self, cell, seed: int, device: torch.device, clock):
        self.cell, self.seed, self.device, self.clock = cell, seed, device, clock
        self.cfg = cell.config
        t = self.cfg["train"]
        if t["steps_per_call"] <= FOLLOWED:
            raise ValueError(f"the check follows {FOLLOWED} steps of one call; "
                             f"steps_per_call is {t['steps_per_call']}")

    # -- set-up ------------------------------------------------------------

    def setup(self):
        from imm_tpu_torch.experiment import build_experiment

        from bench_port.cell import experiment_config

        self.clock.mark("import")
        dev = self.device
        if dev.type == "cuda":
            torch.cuda.init()
            torch.zeros(1, device=dev)
            self.clock.mark("cuda_init")
            from imm_tpu_torch.ops import _build

            for name in ("bottleneck_fwd", "bottleneck_bwd", "warp_fwd"):
                _build.load(name)
            self.clock.mark("kernel_load")
        self.exp = build_experiment(experiment_config(self.cfg), device=dev, restore=False)
        self.start(self.seed)
        self.clock.mark("warm_up")

    def start(self, seed: int):
        """Load the weights made from ``seed`` into a fresh state and take the
        first call, keeping what the check reads of its first steps."""
        from imm_tpu_torch.train.state import flatten_state, load_flat_state

        from bench_port.weights import make_weights

        self.weights_seed, self.data_seed = (2 * seed) % 2**63, (2 * seed + 1) % 2**63
        self.weights = make_weights(self.cfg["model"], self.weights_seed, self.device)
        fresh = {}
        for key, live in flatten_state(self.exp.state).items():
            if key.startswith(("model/", "ema_params/")):
                fresh[key] = self.weights[key.split("/", 1)[1]]
            elif key == "loss_ema":
                fresh[key] = torch.ones_like(live)
            else:  # step, optimizer count and moments
                fresh[key] = torch.zeros_like(live)
        load_flat_state(self.exp.state, fresh)
        self.state = self.exp.state
        self.gen = torch.Generator(self.device).manual_seed(self.data_seed)
        self.clock.mark("model_and_state")
        self.kept = {}
        seen = [0]

        def keep(module, inputs):
            i = seen[0]
            seen[0] += 1
            st = self.exp.state
            if 1 <= i <= FOLLOWED:
                self.kept[f"loss_ema{i}"] = st.loss_ema.detach().clone()
            if i == 1:
                self.kept["mu"] = {k: v.detach().clone() for k, v in st.opt_state["mu"].items()}
                self.kept["stats1"] = {k: v.detach().clone() for k, v in module.named_buffers()}
            if i == FOLLOWED:
                self.kept["params"] = {k: v.detach().clone() for k, v in module.named_parameters()}
                self.kept["ema"] = {k: v.detach().clone() for k, v in (st.ema_params or {}).items()}
                self.kept["stats"] = {k: v.detach().clone() for k, v in module.named_buffers()}

        hook = self.exp.model.register_forward_pre_hook(keep)
        try:
            self._call()
        finally:
            hook.remove()
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _call(self) -> float:
        self.state, metrics = self.exp.step_fn(self.state, self.gen)
        return metrics["loss/total"].item()

    # -- the window --------------------------------------------------------

    def window(self, seconds: float) -> dict:
        t = self.cfg["train"]
        calls = failed = 0
        t0 = time.perf_counter()
        while True:
            loss = self._call()
            calls += 1
            failed += 0 if math.isfinite(loss) else t["steps_per_call"]
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        elapsed = time.perf_counter() - t0
        steps = calls * t["steps_per_call"]
        from bench_port.counts.flops import train_step_flops

        return {"seconds": elapsed, "calls": calls, "units": steps, "attempted": steps,
                "failed": failed, "batch": t["batch_size"],
                "flops_per_unit": train_step_flops(self.cfg),
                "metrics": {"train_images_per_s": steps * t["batch_size"] / elapsed}}

    def traced_slice(self):
        """A slice of ``trace_steps`` steps inside a call, after
        ``trace_wait`` + ``trace_warmup`` of its steps, profiled twice
        (``trace.two_slices``); the model's forward pre-hook marks the steps."""
        from torch.profiler import profile, schedule

        from bench_port.trace import read_profile, two_slices

        tr = self.cell.traffic

        def profiled(activities):
            events = []
            with profile(activities=activities,
                         schedule=schedule(wait=tr["trace_wait"], warmup=tr["trace_warmup"],
                                           active=tr["trace_steps"], repeat=1),
                         on_trace_ready=lambda p: events.extend(read_profile(p))) as prof:
                hook = self.exp.model.register_forward_pre_hook(lambda m, i: prof.step())
                try:
                    self._call()
                finally:
                    hook.remove()
                self._sync()
            return events

        return two_slices(profiled, tr["trace_steps"], "step", self.device.type == "cuda")

    def counters(self) -> dict:
        from imm_tpu_torch.ops.fused import landmark_bottleneck
        from imm_tpu_torch.ops.warp import warp_bilinear

        return {"bottleneck_fwd": landmark_bottleneck.launches,
                "bottleneck_bwd": landmark_bottleneck.bwd_launches,
                "warp_fwd": warp_bilinear.launches, "optimizer_steps": self.state.host_step}

    def release(self):
        """Free the program's state before the reference runs."""
        self.exp = self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def program_readings(self) -> dict:
        k, t = self.kept, self.cfg
        d, b1 = t["loss"]["ema_decay"], t["train"]["adam_b1"]
        raw = [k["loss_ema1"]]
        for i in range(2, FOLLOWED + 1):
            raw.append((k[f"loss_ema{i}"] - d * k[f"loss_ema{i - 1}"]) / (1.0 - d))
        return {"raw": torch.stack(raw), "grad0": {n: v / (1.0 - b1) for n, v in k["mu"].items()},
                "params": k["params"], "ema": k["ema"], "stats": k["stats"], "stats1": k["stats1"]}

    def check(self, reference=None):
        """-> the numbers compared and where each was set. ``reference``
        (a ``TrainReference``) replaces the float32 one: the control."""
        from bench_port.compare import train_numbers

        missing = {"mu", "params", f"loss_ema{FOLLOWED}"} - set(self.kept)
        if missing:  # the model ran fewer forward passes than the followed steps
            return ({k: float("inf") for k in self.cell.limits},
                    {k: f"no reading of {sorted(missing)}" for k in self.cell.limits})
        ref = self.reference(reference).follow(self.weights, self.data_seed, FOLLOWED)
        return train_numbers(self.program_readings(), ref, self.weights)

    def reference(self, reference=None):
        from bench_port.reference.model import load_vgg, strict_fp32
        from bench_port.reference.train import TrainReference

        strict_fp32()
        if reference is not None:
            return reference
        vgg = load_vgg(self.cfg["loss"]["trained_weights"], self.device)  # as the program reads it
        return TrainReference(self.cfg, vgg)
