"""The port's serving export (``imm_tpu_torch.eval.export``): the landmark
detector and the swap generator exported with ``torch.export``, saved,
loaded and held to ``landmark_fn``/``swap_fn`` and to the JAX package's
functions on the same weights (``tests/test_eval.py`` does the same for the
JAX package's StableHLO export).

Tolerances: the loaded program runs the same operations as the eager
forward on the CPU, 1e-6; against JAX, float32 through ~20 layers, 1e-5 for
coords and 1e-4 for the swap images.
"""

import io

import jax.numpy as jnp
import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from imm_tpu.eval.export import landmark_fn as jax_landmark_fn
from imm_tpu.eval.swap import swap_fn as jax_swap_fn
from imm_tpu_torch.eval.export import (
    export_landmarker,
    export_swap_generator,
    landmark_fn,
    load_landmarker,
    load_landmarker_file,
    load_swap_generator,
    save_landmarker,
)
from imm_tpu_torch.eval.swap import swap_fn
from imm_tpu_torch.ops.fused import landmark_bottleneck
from imm_tpu_torch.ops.warp import warp_bilinear
from tests.torch_parity import images, jax_model, n, port_model, t


def _ops_in(program) -> set[str]:
    return {str(node.target) for node in program.graph.nodes if node.op == "call_function"}


def test_landmarker_round_trip_equals_landmark_fn_and_jax(tmp_path):
    jmodel, variables = jax_model()
    model = port_model(variables)
    x = t(images(31, batch=3))
    blob = export_landmarker(model, 3, 32)
    exported = load_landmarker(blob)
    got = exported(x)
    assert got.shape == (3, 5, 2)
    np.testing.assert_allclose(n(got), n(landmark_fn(model)(x)), atol=1e-6)
    want = jax_landmark_fn(jmodel, variables["params"], variables["batch_stats"])(jnp.asarray(n(x)))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)
    # on the CPU the program holds the plain bottleneck, not the kernel's op
    program = torch.export.load(io.BytesIO(blob))
    assert not any("imm_tpu" in op for op in _ops_in(program))
    path = str(tmp_path / "landmarker.pt2")
    save_landmarker(path, model, 3, 32)
    np.testing.assert_allclose(n(load_landmarker_file(path)(x)), n(got), atol=1e-6)


def test_swap_generator_round_trip_equals_swap_fn_and_jax():
    jmodel, variables = jax_model()
    model = port_model(variables)
    app, pose = t(images(32, batch=2)), t(images(33, batch=2))
    exported = load_swap_generator(export_swap_generator(model, 2, 32))
    got = exported(app, pose)
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(n(got), n(swap_fn(model)(app, pose)), atol=1e-6)
    want = jax_swap_fn(jmodel, variables["params"], variables["batch_stats"])(
        jnp.asarray(n(app)), jnp.asarray(n(pose)))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)


def test_kernel_ops_export_under_fake_cuda_tensors():
    """Traced on (fake) CUDA tensors, the wrappers' kernels stay in the graph
    as ``imm_tpu::bottleneck_fwd`` and ``imm_tpu::warp_fwd``; nothing runs."""

    class Module(torch.nn.Module):
        def forward(self, heatmaps, images, grid):
            coords, maps = landmark_bottleneck(heatmaps, (16, 16), 10.0)
            return coords, maps, warp_bilinear(images, grid)

    before = (landmark_bottleneck.launches, warp_bilinear.launches)
    with FakeTensorMode():
        args = (torch.empty(2, 16, 16, 10, device="cuda"), torch.empty(2, 32, 32, 3, device="cuda"),
                torch.empty(2, 8, 8, 2, device="cuda"))
    program = torch.export.export(Module(), args, strict=False)
    ops = _ops_in(program)
    assert {"imm_tpu.bottleneck_fwd.default", "imm_tpu.warp_fwd.default"} <= ops
    outputs = [node for node in program.graph.nodes if node.op == "output"][0].args[0]
    assert [tuple(o.meta["val"].shape) for o in outputs] == [(2, 10, 2), (2, 16, 16, 10), (2, 8, 8, 3)]
    assert (landmark_bottleneck.launches, warp_bilinear.launches) == before
