"""Training-recipe sweep runner on the synthetic harness. Mirrors
``scripts/sweep_tps.py``.

The experiment registry is ``scripts/sweep_variants.yaml``, read in place:
one copy of the registry serves both packages. Each entry is a list of
dotted-config overrides plus an optional baked ``steps`` budget, a status
and a list of seeds; ``load_variants`` validates it as the JAX runner does.
A variant trains under ``variant_config`` (the ``synthetic`` preset, B=128,
the variant's overrides, ``train.seed`` last) in a workdir keyed on its
config (``variant_workdir``, the JAX runner's hash under another root, so a
port checkpoint never lands in a JAX workdir), and its record goes to
``--out`` with the JAX record's keys.

Usage:
    python -m imm_tpu_torch.tools.sweep_tps [--steps 15000]
        [--out docs/artifacts/torch/sweep_tps.jsonl] [--only name1,name2]
        [--seeds 0,1] [--force] [--device cpu] [--work-root DIR]

A variant already recorded in ``--out`` at the same step budget and seed is
skipped, so an interrupted sweep resumes where it left off; a run cut short
resumes from its workdir's latest checkpoint and goes on as the uncut run
(the checkpoint carries its random stream and its evals). Runs on the GPU
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import logging
import os
import re
import tempfile
import time
from pathlib import Path

import torch

from imm_tpu_torch.configs import get_preset
from imm_tpu_torch.experiment import build_experiment
from imm_tpu_torch.utils.config import ExperimentConfig, apply_overrides

REGISTRY_PATH = Path(__file__).resolve().parents[2] / "scripts" / "sweep_variants.yaml"
DEFAULT_OUT = os.path.join("docs", "artifacts", "torch", "sweep_tps.jsonl")
DEFAULT_STEPS = 15_000

VALID_STATUSES = ("active", "refuted", "cancelled")


@dataclasses.dataclass(frozen=True)
class Variant:
    """One registry entry: overrides + optional baked step budget.

    ``status`` gates execution: ``refuted`` / ``cancelled`` entries stay in
    the registry as recorded decisions, but the runner refuses them without
    ``--force``, and they must carry a ``reason``. ``seeds`` makes
    replication a dimension: each seed is a run of its own, keyed in the
    resume-skip set and trained with ``train.seed=<s>`` on top of the
    overrides."""

    overrides: tuple[str, ...]
    steps: int | None = None  # None -> the runner's --steps applies
    status: str = "active"
    reason: str | None = None  # mandatory for non-active statuses
    seeds: tuple[int, ...] = (0,)


def load_variants(path: str | os.PathLike = REGISTRY_PATH) -> dict[str, Variant]:
    """Parse and validate a registry file. Raises ``ValueError`` on a
    duplicate key, an empty entry, a budget in the name that the entry does
    not bake, an unknown status, a non-active entry without a reason, or
    seeds that are not distinct ints."""
    import yaml

    class _DupCheckLoader(yaml.SafeLoader):
        """``yaml.safe_load`` keeps the last of two equal keys: a pasted
        variant name would train the wrong recipe under a validated name."""

    def _no_dup_mapping(loader, node, deep=False):
        seen = set()
        for key_node, _ in node.value:
            key = loader.construct_object(key_node, deep=deep)
            if key in seen:
                raise ValueError(f"duplicate registry key: {key!r}")
            seen.add(key)
        return yaml.SafeLoader.construct_mapping(loader, node, deep)

    _DupCheckLoader.add_constructor(yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG, _no_dup_mapping)
    with open(path) as f:
        raw = yaml.load(f, Loader=_DupCheckLoader)
    out: dict[str, Variant] = {}
    for name, spec in raw.items():
        if spec is None:
            raise ValueError(f"{name}: empty registry entry")
        steps = spec.get("steps")
        budget = re.search(r"_(\d+)k$", name)
        if budget and steps != int(budget.group(1)) * 1000:
            raise ValueError(
                f"{name}: name encodes a {budget.group(1)}k budget but the "
                f"registry bakes steps={steps} — bake the named budget (ADVICE r3)"
            )
        status = spec.get("status", "active")
        if status not in VALID_STATUSES:
            raise ValueError(f"{name}: unknown status {status!r}; one of {VALID_STATUSES}")
        reason = spec.get("reason")
        if status != "active" and not reason:
            raise ValueError(
                f"{name}: status={status} requires a `reason` pointing at "
                "the doc/commit that killed it (VERDICT r4 #7)"
            )
        seeds = tuple(spec.get("seeds") or (0,))
        if len(set(seeds)) != len(seeds) or not all(isinstance(s, int) for s in seeds):
            raise ValueError(f"{name}: seeds must be distinct ints: {seeds}")
        out[name] = Variant(tuple(spec.get("overrides") or ()), steps, status, reason, seeds)
    return out


@functools.cache
def registry() -> dict[str, Variant]:
    """The shipped registry, read once on first use (not on import)."""
    return load_variants()


def default_variants() -> list[str]:
    """Variants the bare (no ``--only``) sweep runs: the active plain probes.
    Convergence runs (baked budgets, or LR boundaries sized for them) and
    trained-feature A/Bs run only through ``--only``."""
    return [
        n for n, v in registry().items()
        if v.steps is None
        and v.status == "active"
        and not any(o.startswith("train.lr_boundaries") for o in v.overrides)
        and "feat" not in n
    ]


def default_work_root() -> str:
    return os.path.join(tempfile.gettempdir(), "sweep_work_torch")


def variant_workdir(name: str, variant: Variant, steps: int, seed: int = 0,
                    root: str | None = None) -> str:
    """Scratch workdir of a (variant, steps, seed) run, keyed on the steps,
    the overrides and a non-zero seed with the JAX runner's key string and
    SHA-1 prefix, so an edited variant never resumes a stale checkpoint and
    both packages name a run alike. ``root`` defaults to
    ``$TMPDIR/sweep_work_torch``."""
    key = f"{steps}|{'|'.join(variant.overrides)}"
    if seed != 0:
        key += f"|seed={seed}"
    cfg_key = hashlib.sha1(key.encode()).hexdigest()[:8]
    return os.path.join(root or default_work_root(), f"{name}_{cfg_key}")


def variant_config(name: str, variant: Variant, steps: int, workdir: str | None = None,
                   seed: int = 0, root: str | None = None) -> ExperimentConfig:
    """The config a sweep run of ``variant`` trains under: the base sweep
    protocol, then the variant's overrides, then ``train.seed`` (so the seed
    dimension wins even over a recipe that bakes one). The one source for the
    runner and ``diagnose_landmarks``."""
    return apply_overrides(
        get_preset("synthetic"),
        [
            f"name={name}",
            "train.batch_size=128",
            f"train.total_steps={steps}",
            "eval_every=3000",
            f"workdir={workdir or variant_workdir(name, variant, steps, seed, root)}",
        ]
        + list(variant.overrides)
        + [f"train.seed={seed}"],
    )


def run_variant(name: str, variant: Variant, steps: int, out_path: str, seed: int = 0,
                device=None, root: str | None = None) -> dict:
    """Train one (variant, seed) run for ``steps`` (the effective budget),
    evaluate it, append its record to ``out_path`` and return the record.

    The workdir keeps a checkpoint every 1,000 steps, so a run that was cut
    resumes, and the checkpoint carries the generator, the evals and the
    wall time: the record of a run in pieces is that of the uncut run, its
    ``curve`` every eval of the run and its ``wall_s`` the sum of the pieces'
    (the steps that a cut threw away not counted)."""
    config = variant_config(name, variant, steps, seed=seed, root=root)
    exp = build_experiment(config, device=device, restore=True)
    t0 = time.time()
    state = exp.run()
    final = exp.eval_fn(state)
    curve = [
        {k: v for k, v in h.items() if k == "step" or k.startswith("eval/")}
        for h in exp.trainer.history
        if any(k.startswith("eval/") for k in h)
    ]
    rec = {
        "variant": name,
        "steps": steps,
        "seed": seed,
        # the kind is explicit so a probe named final_* never takes a final's
        # curve file in scripts/summarize_sweep.py
        "kind": "final" if variant.steps is not None else "probe",
        "overrides": list(variant.overrides),
        "final": final,
        "curve": curve,
        "wall_s": round(exp.trainer.prior_wall_s + time.time() - t0, 1),
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(f"[sweep] {name} seed={seed}: test={final['landmark_error_test_pct']:.2f}%IOD "
          f"({rec['wall_s']:.0f}s)", flush=True)
    # free this run's model, optimizer state and loss before the next one
    dev = exp.device
    del exp, state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _recorded(out_path: str) -> set[tuple[str, int, int]]:
    """(variant, steps, seed) triples already recorded in ``out_path``.

    Keyed on steps too, so a mis-stepped run does not shadow the real one.
    Records without a ``seed`` are seed-0 runs. Re-read before every run: a
    concurrent runner may have recorded it since."""
    done: set[tuple[str, int, int]] = set()
    if os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    r = json.loads(line)
                    done.add((r["variant"], int(r["steps"]), int(r.get("seed", 0))))
                except (ValueError, KeyError):
                    # a writer killed mid-line leaves a torn last line: not recorded
                    print(f"[sweep] ignoring unparseable line in {out_path}: {line[:80]!r}",
                          flush=True)
    return done


@contextlib.contextmanager
def _chip_lock(path: str):
    """Advisory exclusive lock serialising sweep runners on one GPU, held for
    one run; a second runner waits here (and says so) instead of sharing the
    card. The kernel releases a ``flock`` when its holder dies. An empty path
    disables it."""
    if not path:
        yield
        return
    import fcntl

    with open(path, "a+") as f:
        try:
            fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            print(f"[sweep] lock {path} held by another runner; waiting", flush=True)
            fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=DEFAULT_STEPS,
                        help="budget for variants without a baked one")
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--only", default=None, help="comma-separated variant subset")
    parser.add_argument("--seeds", default=None,
                        help="comma-separated seeds; overrides each variant's registry `seeds`")
    parser.add_argument("--force", action="store_true",
                        help="run refuted/cancelled registry entries anyway")
    parser.add_argument("--lock-file",
                        default=os.path.join(tempfile.gettempdir(), "imm_tpu_torch_gpu.lock"),
                        help="advisory lock serialising runners on the GPU ('' disables)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to run (default cuda; without a GPU this raises)")
    parser.add_argument("--work-root", default=None,
                        help="directory of the runs' workdirs (default $TMPDIR/sweep_work_torch)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", datefmt="%H:%M:%S")

    variants = registry()
    names = args.only.split(",") if args.only else default_variants()
    unknown = sorted(set(names) - variants.keys())
    if unknown:  # fail in milliseconds, not hours into the sweep
        raise SystemExit(f"unknown variants {unknown}; options: {sorted(variants)}")
    # the status gate fails the whole invocation up front
    dead = [n for n in names if variants[n].status != "active"]
    if dead and not args.force:
        raise SystemExit(
            f"refusing non-active variants {dead} "
            f"({', '.join(f'{n}: {variants[n].reason}' for n in dead)}); "
            "re-run with --force to override"
        )
    cli_seeds = [int(s) for s in args.seeds.split(",")] if args.seeds else None
    records = []
    for name in names:
        variant = variants[name]
        steps = variant.steps if variant.steps is not None else args.steps
        for seed in cli_seeds if cli_seeds is not None else variant.seeds:
            # the done-set is re-read under the lock, so the loser of a race
            # between two runners skips the run the winner recorded
            with _chip_lock(args.lock_file):
                if (name, steps, seed) in _recorded(args.out):
                    print(f"[sweep] {name} seed={seed}: already recorded at {steps} steps, "
                          "skipping", flush=True)
                    continue
                records.append(run_variant(name, variant, steps, args.out, seed=seed,
                                           device=args.device, root=args.work_root))
    return records


if __name__ == "__main__":
    main()
