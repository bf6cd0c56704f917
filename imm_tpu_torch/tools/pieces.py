"""Run a long training command in pieces, each inside a bounded session (a
machine lent for a fixed time, a batch job's wall limit), and carry its
workdirs from one piece to the next as compressed files.

Usage:
    python -m imm_tpu_torch.tools.pieces --root DIR --budget-s S [--hard-s H]
        [--carry-in DIR] [--carry-out DIR] [--log FILE] -- COMMAND ...

1. Unpack: each ``<carry-in>/<workdir>/<step>.pt.z`` becomes
   ``<root>/<workdir>/checkpoints/<step>/state.pt``, unless that workdir
   already holds that step or a later one.
2. Run ``COMMAND`` in its own process group, its output appended to
   ``--log``. Once ``--budget-s`` seconds have passed, stop it as soon as a
   newer complete checkpoint appears under ``root``, so the cut throws away
   no step; at ``--hard-s`` stop it whatever it is doing (the steps since
   the newest checkpoint are then lost). A command that ends by itself
   (the run reached its budget and wrote its record) is not stopped.
3. Pack: the newest complete checkpoint of each workdir under ``root`` into
   ``<carry-out>/<workdir>/<step>.pt.z``, the only file there.

The trainer's checkpoint carries the random stream, the evals and the wall
time (``train/loop.py``), so the next piece, the same command on the
unpacked workdir, goes on as the uncut run would. ``pack_bytes`` splits
the file into the four byte planes of its 4-byte words (the tensors of a
``torch.save`` file start 64-byte aligned, so each float32's sign and
exponent bytes fall in one plane) and compresses them with zlib.

Exit code: the command's if it ended by itself, 0 if stopped after a new
checkpoint, 124 if stopped at ``--hard-s``.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
import zlib

import numpy as np

from imm_tpu_torch.train.loop import CHECKPOINT_FILE, checkpoint_steps

PACK_LEVEL = 6
SUFFIX = ".pt.z"


def split_planes(data: bytes) -> bytes:
    """The bytes of ``data``'s 4-byte words, plane by plane (every word's
    byte 0, then every byte 1, ...), then the tail of ``len % 4`` bytes."""
    n = len(data) // 4 * 4
    words = np.frombuffer(data, np.uint8, count=n).reshape(-1, 4)
    return words.T.tobytes() + data[n:]


def join_planes(data: bytes) -> bytes:
    """The inverse of ``split_planes``."""
    n = len(data) // 4 * 4
    planes = np.frombuffer(data, np.uint8, count=n).reshape(4, -1)
    return planes.T.tobytes() + data[n:]


def pack_bytes(data: bytes) -> bytes:
    return zlib.compress(split_planes(data), PACK_LEVEL)


def unpack_bytes(data: bytes) -> bytes:
    return join_planes(zlib.decompress(data))


def workdirs(root: str) -> dict[str, int]:
    """Each workdir under ``root`` that holds a complete checkpoint, with its
    newest step."""
    out = {}
    if os.path.isdir(root):
        for name in sorted(os.listdir(root)):
            steps = checkpoint_steps(os.path.join(root, name, "checkpoints"))
            if steps:
                out[name] = steps[-1]
    return out


def _write_atomic(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)


def unpack(carry: str, root: str) -> dict[str, int]:
    """Step 1: the carried checkpoints into their workdirs; -> what was
    unpacked. Files beside the workdirs (the pieces' ``--log``) are left."""
    have, done = workdirs(root), {}
    for name in sorted(os.listdir(carry)) if os.path.isdir(carry) else []:
        if not os.path.isdir(os.path.join(carry, name)):
            continue
        files = [f for f in os.listdir(os.path.join(carry, name)) if f.endswith(SUFFIX)]
        if len(files) != 1:
            raise SystemExit(f"{carry}/{name}: expected one *{SUFFIX} file, found {files}")
        step = int(files[0][: -len(SUFFIX)])
        if have.get(name, -1) >= step:
            continue
        with open(os.path.join(carry, name, files[0]), "rb") as f:
            data = unpack_bytes(f.read())
        _write_atomic(os.path.join(root, name, "checkpoints", str(step), CHECKPOINT_FILE), data)
        done[name] = step
    return done


def pack(root: str, carry: str) -> dict[str, tuple[int, int, int]]:
    """Step 3: the newest checkpoint of each workdir into ``carry``; ->
    workdir: (step, raw bytes, packed bytes)."""
    out = {}
    for name, step in workdirs(root).items():
        with open(os.path.join(root, name, "checkpoints", str(step), CHECKPOINT_FILE), "rb") as f:
            raw = f.read()
        packed = pack_bytes(raw)
        dest = os.path.join(carry, name)
        _write_atomic(os.path.join(dest, f"{step}{SUFFIX}"), packed)
        for old in os.listdir(dest):
            if old != f"{step}{SUFFIX}":
                os.remove(os.path.join(dest, old))
        out[name] = (step, len(raw), len(packed))
    return out


def _stop(proc: subprocess.Popen, grace_s: float = 30.0) -> None:
    for sig in (signal.SIGTERM, signal.SIGKILL):
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            return
        try:
            proc.wait(timeout=grace_s)
            return
        except subprocess.TimeoutExpired:
            continue


def run_piece(command: list[str], root: str, budget_s: float, hard_s: float, log_path: str | None,
              poll_s: float = 5.0) -> tuple[int, str]:
    """Step 2; -> (exit code, how the piece ended: 'finished', 'checkpoint'
    or 'hard_limit')."""
    log = open(log_path, "a") if log_path else None
    t0 = time.time()
    proc = subprocess.Popen(command, stdout=log, stderr=subprocess.STDOUT if log else None,
                            start_new_session=True)
    at_budget = None
    try:
        while True:
            try:
                return proc.wait(timeout=poll_s), "finished"
            except subprocess.TimeoutExpired:
                pass
            elapsed = time.time() - t0
            if elapsed >= hard_s:
                _stop(proc)
                return 124, "hard_limit"
            if elapsed >= budget_s:
                now = workdirs(root)
                if at_budget is None:
                    at_budget = now
                elif any(step > at_budget.get(name, -1) for name, step in now.items()):
                    _stop(proc)
                    return 0, "checkpoint"
    finally:
        if proc.poll() is None:
            _stop(proc)
        if log:
            log.close()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--" not in argv:
        raise SystemExit("usage: ... -- COMMAND")
    split = argv.index("--")
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--root", required=True, help="directory of the command's workdirs")
    parser.add_argument("--budget-s", type=float, required=True,
                        help="after this, stop at the next checkpoint")
    parser.add_argument("--hard-s", type=float, default=None,
                        help="stop here in any case (default: budget + 900)")
    parser.add_argument("--carry-in", default=None, help="packed checkpoints to start from")
    parser.add_argument("--carry-out", default=None, help="where to pack the newest checkpoints")
    parser.add_argument("--log", default=None, help="append the command's output here")
    args = parser.parse_args(argv[:split])
    command = argv[split + 1:]
    if args.carry_in:
        print(f"[pieces] unpacked {unpack(args.carry_in, args.root)}", flush=True)
    hard = args.hard_s if args.hard_s is not None else args.budget_s + 900
    t0 = time.time()
    rc, how = run_piece(command, args.root, args.budget_s, hard, args.log)
    print(f"[pieces] {how} after {time.time() - t0:.1f}s, rc={rc}, checkpoints "
          f"{workdirs(args.root)}", flush=True)
    if args.carry_out:
        t0 = time.time()
        packed = pack(args.root, args.carry_out)
        print(f"[pieces] packed (step, raw bytes, packed bytes) {packed} in "
              f"{time.time() - t0:.1f}s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
