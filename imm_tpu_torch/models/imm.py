"""The IMM model shell: encoders + landmark bottleneck + generator.
Mirrors ``imm_tpu.models.imm``.

The content encoder reads the *source* image, the pose encoder the *target*;
heatmaps pass the spatial-softmax bottleneck and are re-rendered as Gaussian
maps at bottleneck resolution; the decoder reconstructs the target from the
concatenation. Only 2K pose scalars cross the bottleneck.

Public methods take and return the JAX package's layouts: NHWC images
(B, S, S, 3), heatmaps (B, h, w, K), coords (B, K, 2) in (y, x) order,
content (B, h, w, C). Train or eval mode is the module's own
(``model.train()`` / ``model.eval()``), where flax passed ``train=``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from imm_tpu_torch.models.nets import (
    ContentEncoder,
    ConvBlock,
    Decoder,
    FlaxBatchNorm,
    FlaxGroupNorm,
    PoseEncoder,
    SameConv2d,
)
from imm_tpu_torch.ops.fused import landmark_bottleneck
from imm_tpu_torch.ops.gauss import render_gaussian_maps
from imm_tpu_torch.utils.device import get_device
from imm_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True, unsafe_hash=True)
class IMMConfig:
    """Architecture hyperparameters (the same fields as the JAX package's)."""

    n_landmarks: int = 10
    image_size: int = 128
    filters: tuple[int, ...] = (32, 32, 64, 64, 128, 128, 256, 256)
    strides: tuple[int, ...] = (1, 1, 2, 1, 2, 1, 2, 1)
    decoder_filters: tuple[int, ...] = (256, 128, 64, 32)
    gauss_std: float = 0.1  # sigma of the re-rendered maps, normalized units
    gauss_mode: str = "rot"
    temperature: float = 1.0
    norm: str = "batch"
    compute_dtype: str = "float32"
    bottleneck_impl: str = "auto"  # 'xla' | 'pallas' | 'auto'
    entry_s2d: int = 0  # space-to-depth block of the entry conv (0 = direct)
    # BatchNorm's data-parallel axis: 'data' takes flax's E[x^2] - E[x]^2
    # variance and averages the statistics across the ranks of the process
    # group (models/nets.py:FlaxBatchNorm)
    axis_name: str | None = None

    def __post_init__(self):
        h = self.bottleneck_hw[0]
        ups = len(self.decoder_filters) - 1
        if h * (2**ups) != self.image_size:
            raise ValueError(
                f"decoder_filters has {ups} upsamples: {h}px bottleneck -> "
                f"{h * 2**ups}px, but image_size={self.image_size}; need one "
                f"stage per 2x plus a final stage"
            )

    @property
    def bottleneck_hw(self) -> tuple[int, int]:
        down = 1
        for s in self.strides:
            down *= s
        return (self.image_size // down, self.image_size // down)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


@dataclasses.dataclass
class IMMOutputs:
    """Everything downstream consumers need (loss, eval, viz)."""

    recon: torch.Tensor  # (B, H, W, 3) reconstruction of the target
    coords: torch.Tensor  # (B, K, 2) landmark (y, x) in [-1, 1]
    heatmaps: torch.Tensor  # (B, h, w, K) raw pose-encoder heatmaps
    gauss_maps: torch.Tensor  # (B, h, w, K) re-rendered Gaussian maps
    content: torch.Tensor  # (B, h, w, C) content features


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class IMM(nn.Module):
    """Conditional image generation through a landmark bottleneck."""

    def __init__(self, config: IMMConfig = IMMConfig()):
        super().__init__()
        c = self.config = config
        self.content_encoder = ContentEncoder(
            c.filters, c.strides, c.norm, c.dtype, c.entry_s2d, c.axis_name
        )
        self.pose_encoder = PoseEncoder(
            c.n_landmarks, c.filters, c.strides, c.norm, c.dtype, c.entry_s2d, c.axis_name
        )
        self.decoder = Decoder(
            c.filters[-1] + c.n_landmarks, c.decoder_filters, 3, c.norm, c.dtype, c.axis_name
        )

    def _bottleneck(self, heatmaps_nchw):
        """NCHW heatmaps -> coords (B, K, 2) f32 and NCHW maps in the compute
        dtype. The bottleneck runs in float32 whatever the compute dtype."""
        c = self.config
        # one copy: a cast returns the channel-last layout, a no-op cast
        # returns the NCHW view and .contiguous() copies
        heatmaps = _nhwc(heatmaps_nchw).to(
            torch.float32, memory_format=torch.contiguous_format
        ).contiguous()
        coords, gauss_maps = landmark_bottleneck(
            heatmaps, c.bottleneck_hw, inv_std=1.0 / c.gauss_std,
            temperature=c.temperature, mode=c.gauss_mode, impl=c.bottleneck_impl,
        )
        return coords, heatmaps, _nchw(gauss_maps).to(c.dtype)

    def forward(self, source: torch.Tensor, target: torch.Tensor) -> IMMOutputs:
        """Full forward: reconstruct ``target`` from content(source) + pose(target)."""
        with span("imm.content_encoder"):
            content = self.content_encoder(_nchw(source))
        with span("imm.pose_encoder"):
            coords, heatmaps, gauss_maps = self._bottleneck(self.pose_encoder(_nchw(target)))
        with span("imm.decoder"):
            recon = self.decoder(torch.cat([content, gauss_maps], dim=1))
        return IMMOutputs(
            recon=_nhwc(recon).float(),
            coords=coords,
            heatmaps=heatmaps,
            gauss_maps=_nhwc(gauss_maps).float(),
            content=_nhwc(content).float(),
        )

    def encode_pose(self, image: torch.Tensor):
        """Landmarks only (the eval path): image -> (coords, heatmaps)."""
        with span("imm.pose_encoder"):
            coords, heatmaps, _ = self._bottleneck(self.pose_encoder(_nchw(image)))
        return coords, heatmaps

    def encode_content(self, image: torch.Tensor) -> torch.Tensor:
        """Image -> (B, h, w, C) content features in the compute dtype."""
        with span("imm.content_encoder"):
            return _nhwc(self.content_encoder(_nchw(image)))

    def generate(self, content: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """Decode from explicit content features + landmark coords (swap path)."""
        c = self.config
        with span("imm.decoder"):
            gauss_maps = render_gaussian_maps(
                coords.float(), c.bottleneck_hw, inv_std=1.0 / c.gauss_std, mode=c.gauss_mode
            ).to(c.dtype)
            x = torch.cat([_nchw(content).to(c.dtype), _nchw(gauss_maps)], dim=1)
            return _nhwc(self.decoder(x)).float()


def init_model(config: IMMConfig, seed: int = 0, device=None) -> IMM:
    """A model initialised from ``seed`` with the flax initialisers
    (``lecun_normal`` convs, zero biases, unit norm scales, zero mean and
    unit variance running stats), on ``device`` (default: the GPU)."""
    model = IMM(config)
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (ConvBlock, SameConv2d, FlaxBatchNorm, FlaxGroupNorm)):
            m.reset_parameters(generator=gen)
    return model.to(get_device(device))
