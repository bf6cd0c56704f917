"""Bounded first-touch CUDA initialisation (``imm_tpu_torch.utils.device_init``),
the four cases of ``tests/test_device_init.py``. The blocked call runs in a
subprocess: the watchdog ends the whole process."""

import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from imm_tpu_torch.utils import device_init
from imm_tpu_torch.utils.device_init import (
    INIT_TIMEOUT_EXIT_CODE,
    _call_with_timeout,
    cuda_init_or_timeout,
)

ROOT = Path(__file__).resolve().parents[1]


def test_blocked_call_hard_exits_with_watchdog_code():
    # a Python-level sleep stands in for an init blocked in native code; the
    # watchdog thread's os._exit fires whatever the main thread blocks in
    code = (
        "from imm_tpu_torch.utils.device_init import _call_with_timeout; "
        "import time; _call_with_timeout(lambda: time.sleep(30), 1, 'probe')"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=60, env=env, cwd=ROOT)
    assert proc.returncode == INIT_TIMEOUT_EXIT_CODE == 86, proc.stderr
    assert "likely wedged" in proc.stderr


def test_fast_call_passes_through_and_watchdog_is_disarmed():
    assert _call_with_timeout(lambda: 42, timeout_s=5, what="probe") == 42
    time.sleep(0.05)  # a leaked timer would os._exit the test process


def test_zero_timeout_disables_bound(monkeypatch):
    assert _call_with_timeout(lambda: "ok", timeout_s=0, what="probe") == "ok"
    monkeypatch.setenv("IMM_TPU_DEVICE_INIT_TIMEOUT_S", "0")
    assert device_init.init_timeout_s() == 0
    monkeypatch.delenv("IMM_TPU_DEVICE_INIT_TIMEOUT_S")
    assert device_init.init_timeout_s() == 600


def test_cuda_init_on_an_initialised_context_arms_nothing(monkeypatch):
    """An initialised context returns at once, without a watchdog; an
    uninitialised one is initialised under the bound."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(device_init, "_call_with_timeout", lambda *a: calls.append(a))
    cuda_init_or_timeout(timeout_s=1)
    assert calls == []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    cuda_init_or_timeout(timeout_s=7)
    assert calls == [(torch.cuda.init, 7, "torch.cuda.init()")]
