"""Adam with optax's conventions, the parameter EMA and the gradients'
global norm, over all of a model's parameter leaves, in place, as one op.

K6, CUDA kernels written by hand for Hopper (``csrc/adam_ema.cu``): two
launches an optimizer step whatever the number of leaves, where the plain
per-leaf version (``train/state.py:Optimizer.update_per_leaf`` and the copy
back in ``train/steps.py:_single_step``) issues ~19 launches a leaf. The
rate, the bias corrections and the NaN guard's flag come from the
device-resident count and loss: no host sync, nothing copied to the device.
The launch goes through ``ctypes`` with the leaves' pointers in the kernels'
argument struct, rebuilt every step (the gradients are new tensors).

The plain version stays in ``train``: a CPU tensor takes it, and so does SGD.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref

import torch
from torch import Tensor

from imm_tpu_torch.ops import _build

# csrc/adam_ema.cu: threads a block, leaves and rate boundaries an Args holds
THREADS = 256
MAX_LEAVES = 80
MAX_BOUNDARIES = 4
# blocks of the two kernels on each SM
BLOCKS_PER_SM = 4
# the step's scalars, as the kernels write them
GRAD_NORM, LOSS, NONFINITE, LR, BIAS1, BIAS2, NORM, SCALARS = range(8)
GUARD, CLIP, DECAY, EMA = 1, 2, 4, 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _Leaves(ctypes.Structure):
    _fields_ = [("p", _P * MAX_LEAVES), ("g", _P * MAX_LEAVES), ("m", _P * MAX_LEAVES),
                ("v", _P * MAX_LEAVES), ("e", _P * MAX_LEAVES), ("n", _I * MAX_LEAVES),
                ("cl", _I * MAX_LEAVES)]


class _Step(ctypes.Structure):
    _fields_ = [("count", _P), ("loss", _P), ("scal", _P), ("part", _P), ("counter", _P),
                ("leaves", _I), ("flags", _I), ("bounds", _I),
                ("bound", _I * MAX_BOUNDARIES), ("ratio", _F * MAX_BOUNDARIES),
                *((k, _F) for k in ("lr", "b1", "b2", "rb1", "rb2", "eps", "wd", "clip", "d",
                                    "rd"))]


class _Args(ctypes.Structure):
    _fields_ = [("l", _Leaves), ("s", _Step)]


assert ctypes.sizeof(_Args) == 3968  # the source's static_assert


@dataclasses.dataclass(frozen=True)
class Recipe:
    """The update's constants: ``TrainConfig``'s Adam settings, the
    piecewise-constant rate as ``(boundary, ratio)`` pairs in ascending
    order, and the parameter EMA's decay (0: none)."""

    learning_rate: float
    boundaries: tuple[tuple[int, float], ...]
    b1: float
    b2: float
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    ema_decay: float = 0.0
    nan_guard: bool = False


@dataclasses.dataclass(frozen=True)
class StepScalars:
    """An optimizer step's metrics as 0-d f32 tensors on the device:
    ``grad_norm``, ``loss/total`` and ``nonfinite_step`` (0, 0 and 1 for a
    step the NaN guard skipped)."""

    grad_norm: Tensor
    loss: Tensor
    nonfinite: Tensor | None


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# one zeroed 32-bit counter for each (device, stream), kept across calls: the
# norm's last block wraps it back to 0
_COUNTERS: dict[tuple[int, int], Tensor] = {}


def _counter(device, stream: int) -> Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None:
        buf = _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return buf


def _layout(g: Tensor, p: Tensor) -> tuple[Tensor, int]:
    """-> the gradient as the kernels read it, and its ``cl`` code: 0 laid
    out as its contiguous parameter, else the channels-last code."""
    if g.is_contiguous():
        return g, 0
    if g.dim() == 4 and g.is_contiguous(memory_format=torch.channels_last):
        _, c, h, w = g.shape
        if h * w < 256:
            return g, c * 256 + h * w
    return g.contiguous(), 0  # a layout the kernels do not read: one copy


@dataclasses.dataclass(frozen=True)
class _Checked:
    """What the last call checked of its parameters, moments and EMA: the
    tensors (weakly held) and their data pointers. A training run hands the
    same tensors over every step, and only the gradients are new."""

    refs: tuple
    ptrs: tuple
    shapes: tuple
    sizes: tuple
    grid: int

    def holds(self, tensors: list[Tensor], ptrs: tuple) -> bool:
        return self.ptrs == ptrs and all(r() is t for r, t in zip(self.refs, tensors))


_CHECKED: list = [None]


def _check_state(tensors: list[Tensor], n_leaves: int, dev) -> _Checked:
    ptrs = tuple(t.data_ptr() for t in tensors)
    last = _CHECKED[0]
    if last is not None and last.holds(tensors, ptrs):
        return last
    for j, t in enumerate(tensors):
        i = j % n_leaves
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"leaf {i}: parameters, moments and EMA must be contiguous "
                             f"float32 on {dev}, got {t.dtype} {t.stride()} on {t.device}")
        if t.shape != tensors[i].shape:
            raise ValueError(f"leaf {i}: shapes differ: {tuple(tensors[i].shape)}, "
                             f"{tuple(t.shape)}")
    sizes = tuple(t.numel() for t in tensors[:n_leaves])
    if max(sizes) >= 2**31:
        raise ValueError(f"a leaf of {max(sizes)} elements, more than an int32 counts")
    groups = -(-max(sizes) // 4)
    grid = max(1, min(BLOCKS_PER_SM * _sm_count(dev.index), -(-groups // THREADS)))
    _CHECKED[0] = checked = _Checked(tuple(map(weakref.ref, tensors)), ptrs,
                                     tuple(t.shape for t in tensors[:n_leaves]), sizes, grid)
    return checked


def adam_ema(params: list[Tensor], grads: list[Tensor], mu: list[Tensor], nu: list[Tensor],
             ema: list[Tensor] | None, count: Tensor, loss: Tensor, recipe: Recipe) -> StepScalars:
    """One Adam step over the leaves, in place: ``params``, ``mu``, ``nu``,
    ``ema`` (with ``recipe.ema_decay > 0``) and the int32 ``count`` are
    updated, unless ``recipe.nan_guard`` finds the loss or the gradients'
    norm not finite, which leaves all of them as they were. Every leaf is
    float32 and contiguous, its gradient of its shape (channels-last is read
    as it is); ``loss`` is the step's 0-d total. ``adam_ema.launches``
    counts the kernels launched (two a call)."""
    n_leaves = len(params)
    if not 0 < n_leaves <= MAX_LEAVES:
        raise ValueError(f"the Adam kernels take 1 to {MAX_LEAVES} leaves, got {n_leaves}")
    if len(recipe.boundaries) > MAX_BOUNDARIES:
        raise ValueError(f"the Adam kernels take at most {MAX_BOUNDARIES} rate boundaries, "
                         f"got {len(recipe.boundaries)}")
    use_ema = recipe.ema_decay > 0
    if use_ema and (ema is None or len(ema) != n_leaves):
        raise ValueError("an EMA decay needs one EMA tensor a leaf")
    if not (len(grads) == len(mu) == len(nu) == n_leaves):
        raise ValueError(f"{n_leaves} leaves, {len(grads)} gradients, {len(mu)} and {len(nu)} "
                         "moments")
    dev = count.device
    if count.dtype != torch.int32 or count.numel() != 1:
        raise ValueError(f"count must be one int32, got {count.dtype} {tuple(count.shape)}")
    loss = loss.detach().float()
    if loss.numel() != 1 or loss.device != dev:
        raise ValueError(f"loss must be one value on {dev}, got {tuple(loss.shape)} on "
                         f"{loss.device}")
    state = [*params, *mu, *nu, *(ema if use_ema else ())]
    checked = _check_state(state, n_leaves, dev)
    read, cls = [], []  # the gradients as the kernels read them, alive until the launch
    for i, g in enumerate(grads):
        g, cl = _layout(g, params[i])
        if g.dtype != torch.float32 or g.device != dev or g.shape != checked.shapes[i]:
            raise ValueError(f"leaf {i}: the gradient must be float32 {tuple(checked.shapes[i])} "
                             f"on {dev}, got {g.dtype} {tuple(g.shape)} on {g.device}")
        read.append(g)
        cls.append(cl)
    a = _Args()
    lv, ptrs = a.l, checked.ptrs
    lv.p[:n_leaves], lv.m[:n_leaves] = ptrs[:n_leaves], ptrs[n_leaves:2 * n_leaves]
    lv.v[:n_leaves], lv.g[:n_leaves] = ptrs[2 * n_leaves:3 * n_leaves], [g.data_ptr() for g in read]
    if use_ema:
        lv.e[:n_leaves] = ptrs[3 * n_leaves:]
    lv.n[:n_leaves], lv.cl[:n_leaves] = checked.sizes, cls
    grid = checked.grid
    buf = torch.empty(SCALARS + grid, dtype=torch.float32, device=dev)
    s = a.s
    s.leaves, s.bounds = n_leaves, len(recipe.boundaries)
    s.flags = (GUARD * recipe.nan_guard | CLIP * (recipe.grad_clip > 0)
               | DECAY * (recipe.weight_decay > 0) | EMA * use_ema)
    for j, (b, ratio) in enumerate(recipe.boundaries):
        s.bound[j], s.ratio[j] = b, ratio
    s.lr, s.b1, s.b2 = recipe.learning_rate, recipe.b1, recipe.b2
    s.rb1, s.rb2, s.eps = 1.0 - recipe.b1, 1.0 - recipe.b2, 1e-8  # optax's, as Optimizer.update
    s.wd, s.clip, s.d, s.rd = (recipe.weight_decay, recipe.grad_clip, recipe.ema_decay,
                               1.0 - recipe.ema_decay)
    fn = _build.load("adam_ema")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        s.count, s.loss = count.data_ptr(), loss.data_ptr()
        s.counter = _counter(dev, stream).data_ptr()
        s.scal, s.part = buf.data_ptr(), buf.data_ptr() + 4 * SCALARS
        _build.check("adam_ema", fn(ctypes.byref(a), grid, stream))
    adam_ema.launches += 2
    return StepScalars(grad_norm=buf[GRAD_NORM], loss=buf[LOSS], nonfinite=buf[NONFINITE])


adam_ema.launches = 0
