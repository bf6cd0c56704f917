"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with ``nvcc`` (sm_90a); elsewhere they skip. Run on
the card, where JAX is absent, without ``tests/conftest.py`` (it imports JAX):
``python -m pytest tests/test_torch_kernels.py -q --noconftest``.

Tolerance 1e-5 (float32): kernel and plain version differ only in ``expf``
against ``torch.exp``, summation order and the ruler's last bit.
"""

import dataclasses

import pytest
import torch

from imm_tpu_torch.ops.fused import _bottleneck_reference, landmark_bottleneck

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape,out_hw,temperature",
    [
        ((128, 16, 16, 10), (16, 16), 1.0),  # the swap preset
        ((5, 16, 16, 30), (16, 16), 1.0),  # odd batch, the largest K
        ((3, 16, 16, 16), (32, 32), 0.5),  # out_hw != hw
        ((2, 8, 12, 20), (12, 8), 2.0),  # non-square
        ((2, 48, 48, 10), (48, 48), 1.0),  # above 48 KB of shared memory
    ],
)
def test_bottleneck_kernel_matches_plain(dev, shape, out_hw, temperature):
    hm = torch.randn(shape, generator=torch.Generator(dev).manual_seed(0), device=dev) * 3.0
    before = landmark_bottleneck.launches
    c, m = landmark_bottleneck(hm, out_hw, 10.0, temperature)  # auto: the kernel
    torch.cuda.synchronize()
    assert landmark_bottleneck.launches == before + 1
    c_r, m_r = _bottleneck_reference(hm, out_hw, 10.0, temperature, "rot")
    torch.testing.assert_close(c, c_r, rtol=0, atol=1e-5)
    torch.testing.assert_close(m, m_r, rtol=0, atol=1e-5)


def test_bottleneck_kernel_refuses_what_it_cannot_take(dev):
    hm = torch.randn(2, 16, 16, 10, device=dev)
    with pytest.raises(TypeError):
        landmark_bottleneck(hm.double(), (16, 16), 10.0, impl="pallas")
    with pytest.raises(ValueError, match="contiguous"):
        landmark_bottleneck(hm.transpose(1, 2), (16, 16), 10.0, impl="pallas")
    with pytest.raises(NotImplementedError, match="backward"):
        landmark_bottleneck(hm.requires_grad_(), (16, 16), 10.0, impl="pallas")
    with pytest.raises(ValueError, match="shared memory"):
        landmark_bottleneck(torch.zeros(1, 128, 128, 4, device=dev), (16, 16), 10.0, impl="pallas")


def test_model_paths_agree_on_the_card(dev):
    from imm_tpu_torch.eval.export import landmark_fn
    from imm_tpu_torch.models.imm import IMM, IMMConfig, init_model

    cfg = IMMConfig(n_landmarks=5, image_size=32, filters=(8, 8, 16, 16), strides=(1, 2, 1, 2),
                    decoder_filters=(16, 8, 8))
    model = init_model(cfg, seed=0, device=dev)
    plain = IMM(dataclasses.replace(cfg, bottleneck_impl="xla")).to(dev)
    plain.load_state_dict(model.state_dict())
    img = torch.rand(4, 32, 32, 3, generator=torch.Generator(dev).manual_seed(1), device=dev)
    before = landmark_bottleneck.launches
    got = landmark_fn(model)(img)
    assert landmark_bottleneck.launches == before + 1
    torch.testing.assert_close(got, landmark_fn(plain)(img), rtol=0, atol=1e-5)
