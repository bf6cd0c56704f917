"""Traffic kind ``swap_calls``: one caller in a closed loop of
``swap_fn(appearance, pose)`` calls on the program's serving entry, each at
the mix's ``batch`` and ending when its output is complete on the device.
The inputs cycle through a pool of ``pool`` appearance/pose batches of blob
faces made on the device from the seed at set-up.

The window's first call on each pair of the pool is kept for the check,
and each later call with probability ``keep_share``, drawn from the seed;
after the window the reference generates the same swaps in float32 and
every kept image is compared.

Mix parameters: ``batch``, ``pool``, ``warmup_calls``, ``keep_share``,
``trace_warmup``, ``trace_calls``.
"""

from __future__ import annotations

import random
import statistics
import time

import torch


class Driver:
    unit = "call"

    def __init__(self, cell, seed: int, device: torch.device, clock):
        self.cell, self.seed, self.device, self.clock = cell, seed, device, clock
        self.cfg, self.tr = cell.config, cell.traffic

    def setup(self):
        from imm_tpu_torch.models.imm import init_model

        from bench_port.cell import experiment_config

        self.clock.mark("import")
        dev = self.device
        if dev.type == "cuda":
            torch.cuda.init()
            torch.zeros(1, device=dev)
            self.clock.mark("cuda_init")
            from imm_tpu_torch.ops import _build

            _build.load("bottleneck_fwd")
            self.clock.mark("kernel_load")
        self.model = init_model(experiment_config(self.cfg).model, device=dev)
        self.start(self.seed)
        for i in range(self.tr["warmup_calls"]):
            self.fn(*self.pool[i % len(self.pool)])
        self._sync()
        self.clock.mark("warm_up")

    def start(self, seed: int):
        """Load the weights made from ``seed`` and draw the input pool."""
        from imm_tpu_torch.eval.swap import swap_fn

        from bench_port.reference.data import blob_faces
        from bench_port.weights import make_weights

        dev = self.device
        self.weights = make_weights(self.cfg["model"], (2 * seed) % 2**63, dev)
        self.model.load_state_dict(self.weights)
        self.fn = swap_fn(self.model)
        self.clock.mark("model_and_state")
        gen = torch.Generator(dev).manual_seed((2 * seed + 1) % 2**63)
        b, s = self.tr["batch"], self.cfg["model"]["image_size"]
        self.pool = [(blob_faces(gen, b, s), blob_faces(gen, b, s)) for _ in range(self.tr["pool"])]
        self._sync()
        self.clock.mark("inputs")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        rng = random.Random(self.seed)
        n, times, self.kept = len(self.pool), [], []
        t0 = time.perf_counter()
        while True:
            i = len(times)
            c0 = time.perf_counter()
            out = self.fn(*self.pool[i % n])
            self._sync()
            c1 = time.perf_counter()
            times.append(c1 - c0)
            if rng.random() < self.tr["keep_share"] or i < n:
                self.kept.append((i, i % n, out))
            if c1 - t0 >= seconds:
                break
        elapsed = c1 - t0
        calls = len(times)
        p95 = statistics.quantiles(times, n=20, method="inclusive")[18] if calls > 1 else times[0]
        from bench_port.counts.flops import swap_call_flops

        return {"seconds": elapsed, "units": calls, "attempted": calls, "failed": 0,
                "kept": len(self.kept), "batch": self.tr["batch"],
                "call_ms_min": 1e3 * min(times), "call_ms_p50": 1e3 * statistics.median(times),
                "call_ms_max": 1e3 * max(times),
                "flops_per_unit": swap_call_flops(self.cfg["model"], self.tr["batch"]),
                "metrics": {"serve_images_per_s": calls * self.tr["batch"] / elapsed,
                            "serve_ms_p95": p95 * 1e3}}

    def traced_slice(self):
        """``trace_calls`` calls after ``trace_warmup``, profiled twice
        (``trace.two_slices``)."""
        from torch.profiler import profile, schedule

        from bench_port.trace import read_profile, two_slices

        n, warm, active = len(self.pool), self.tr["trace_warmup"], self.tr["trace_calls"]

        def profiled(activities):
            events = []
            with profile(activities=activities,
                         schedule=schedule(wait=0, warmup=warm, active=active, repeat=1),
                         on_trace_ready=lambda p: events.extend(read_profile(p))) as prof:
                for i in range(warm + active):
                    self.fn(*self.pool[i % n])
                    self._sync()
                    prof.step()
            return events

        return two_slices(profiled, active, "call", self.device.type == "cuda")

    def counters(self) -> dict:
        from imm_tpu_torch.ops.fused import landmark_bottleneck

        return {"bottleneck_fwd": landmark_bottleneck.launches}

    def release(self):
        self.fn = self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, reference=None):
        """-> the numbers compared and where each was set. ``reference``
        (an ``IMMReference``) replaces the float32 one: the control."""
        from bench_port.compare import image_gap
        from bench_port.reference.model import IMMReference, strict_fp32

        strict_fp32()
        net = reference or IMMReference(self.cfg["model"])
        with torch.no_grad():
            refs = {j: net.swap(self.weights, *self.pool[j]) for j in sorted({j for _, j, _ in self.kept})}
        gap, at = image_gap(self.kept, refs)
        return {"image_gap": gap}, {"image_gap": at}
