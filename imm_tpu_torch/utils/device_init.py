"""Bounded first-touch CUDA initialisation. Mirrors
``imm_tpu.utils.device_init``.

The first CUDA call of a process creates its context on the card. On a
healthy machine that takes about a second; a wedged driver or a card held in
a bad state can block it for minutes inside native code, where a Python
signal handler would run only after the call returns. Bounding the first
touch turns such a hang into a fast, clean failure that a retry loop
(``cli.train --supervise``) can cycle on: a watchdog thread hard-exits the
process (``os._exit(86)``) if the call has not returned in time.

The bound is an infrastructure setting, not a model hyperparameter, so it
lives in an environment variable, ``IMM_TPU_DEVICE_INIT_TIMEOUT_S`` (the JAX
package's name; default 600, ``0`` disables it).
"""

from __future__ import annotations

import os
import sys
import threading

import torch

_DEFAULT_TIMEOUT_S = 600
#: process exit code of the init watchdog (the stall watchdog uses 42)
INIT_TIMEOUT_EXIT_CODE = 86


def _call_with_timeout(fn, timeout_s: int, what: str):
    """Run ``fn()``; hard-exit the process if it blocks past ``timeout_s``."""
    if timeout_s <= 0:
        return fn()

    def _abort():
        sys.stderr.write(
            f"{what} blocked for {timeout_s}s — the device is likely wedged; exiting "
            f"{INIT_TIMEOUT_EXIT_CODE} so a supervise/retry loop can relaunch "
            "(IMM_TPU_DEVICE_INIT_TIMEOUT_S tunes/disables this)\n"
        )
        sys.stderr.flush()
        os._exit(INIT_TIMEOUT_EXIT_CODE)

    timer = threading.Timer(timeout_s, _abort)
    timer.daemon = True
    timer.start()
    try:
        return fn()
    finally:
        timer.cancel()


def init_timeout_s() -> int:
    return int(os.environ.get("IMM_TPU_DEVICE_INIT_TIMEOUT_S", _DEFAULT_TIMEOUT_S))


def cuda_init_or_timeout(timeout_s: int | None = None) -> None:
    """``torch.cuda.init()`` with a bound on the process's first CUDA
    initialisation. An initialised context returns at once, so the watchdog
    is armed only for the first touch. A wedged init hard-exits the process
    with :data:`INIT_TIMEOUT_EXIT_CODE`."""
    if torch.cuda.is_initialized():
        return
    _call_with_timeout(
        torch.cuda.init, init_timeout_s() if timeout_s is None else timeout_s, "torch.cuda.init()"
    )
