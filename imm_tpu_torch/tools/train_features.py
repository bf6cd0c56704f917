"""Train the perceptual loss's feature trunk offline. Mirrors
``scripts/train_features.py``.

Trains the same ``VGG16Features`` trunk the perceptual loss uses as the
encoder of a U-Net denoiser on synthetic blob-face frames, then freezes it to
an ``.npz`` in the loader's RGB-ready format (``save_vgg16_params``, with its
``channel_order`` marker), which ``loss.feature_source=trained`` loads in
either package; the run ends by loading it into the port's perceptual loss.

Objective: reconstruct the clean frame from a corrupted one (additive noise
and/or global photometric jitter). Skip connections feed every perceptual tap
(conv1_2, conv2_2, conv3_3, conv4_3) into the decoder, so every tap learns
clean image structure and invariance to the corruption.

Usage:
    python -m imm_tpu_torch.tools.train_features [--steps 6000] [--batch 64]
        [--corruption both|noise|photo] [--warp] [--device cpu]
        [--out runs/trained_features_torch.npz]

Runs on the GPU unless ``--device cpu`` is given. The default ``--out`` lies
under the git-ignored ``runs/``, so a bare run never overwrites a committed
``weights/*.npz``.
"""

from __future__ import annotations

import argparse
import logging
import math
import time
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from imm_tpu_torch.data.pairs import PairSynthesizer
from imm_tpu_torch.data.synthetic import SyntheticBlobFaces
from imm_tpu_torch.losses.perceptual import ReconstructionLoss
from imm_tpu_torch.models.nets import SameConv2d, _upsample2x, lecun_normal_
from imm_tpu_torch.models.vgg import PERCEPTUAL_TAPS, VGG16Features, save_vgg16_params
from imm_tpu_torch.train.state import make_optimizer, piecewise_constant_config
from imm_tpu_torch.utils.config import PairConfig, PerceptualLossConfig
from imm_tpu_torch.utils.device import get_device

# decoder: conv4_3 (S/8) -> up + conv3_3 -> up + conv2_2 -> up + conv1_2 -> RGB
DECODER_WIDTHS = (("conv4_3", 512, 256), ("conv3_3", 256, 128), ("conv2_2", 128, 64),
                  ("conv1_2", 64, 32))  # (tap, tap channels, conv width)
# VGG16Features takes [0, 255] - mean (about +-120) and has no norm layer: the
# first conv's kernel is divided by this so its outputs start at unit scale
CONV1_1_RESCALE = 120.0
# the K=30 flagship's warp (sweep ind_3x), geometry only: photometric jitter
# would fight the denoising objective
WARP_PAIR = PairConfig(rotsd=(5.0, 7.5), scalesd=(0.05, 0.075), transsd=(0.05, 0.12),
                       warpsd=(0.001, 0.03), enable_jitter=False)
LOG_WINDOW = 20  # steps a logged loss averages (the JAX script's scan length)


class Denoiser(nn.Module):
    """``VGG16Features`` encoder + U-Net decoder over the perceptual taps.

    (B, S, S, 3) corrupted images in [0, 1] -> (B, S, S, 3) float32. The
    parameters are float32 and every conv computes in bf16, as flax's
    ``dtype=bf16, param_dtype=f32``. The flax module's names: ``vgg``,
    ``Conv_0`` .. ``Conv_3`` (``decoder[i]``), ``to_rgb``."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features(PERCEPTUAL_TAPS, torch.bfloat16).requires_grad_(True)
        self.decoder = nn.ModuleList()
        cin = 0
        for _, tap_channels, width in DECODER_WIDTHS:
            self.decoder.append(SameConv2d(cin + tap_channels, width, 3, dtype=torch.bfloat16))
            cin = width
        self.to_rgb = SameConv2d(cin, 3, 3, dtype=torch.bfloat16)

    def forward(self, corrupted: torch.Tensor) -> torch.Tensor:
        feats = self.vgg(corrupted)
        x = None
        for conv, (tap, _, _) in zip(self.decoder, DECODER_WIDTHS):
            f = feats[tap].permute(0, 3, 1, 2).to(torch.bfloat16)
            x = f if x is None else torch.cat([_upsample2x(x), f], dim=1)
            x = F.relu(conv(x))
        return self.to_rgb(x).permute(0, 2, 3, 1).float()


def init_denoiser(seed: int = 0) -> Denoiser:
    """flax's initialisers (``lecun_normal`` kernels, zero biases) drawn from
    a ``torch.Generator``, then ``conv1_1``'s kernel divided by
    ``CONV1_1_RESCALE``."""
    model = Denoiser()
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, gen)
            nn.init.zeros_(m.bias)
    with torch.no_grad():
        model.vgg.convs["conv1_1"].weight.div_(CONV1_1_RESCALE)
    return model


class CorruptDraws(NamedTuple):
    """The random draws of one corruption: brightness U(-0.15, 0.15) and
    contrast U(0.7, 1.3) of shape (B, 1, 1, 1), or None without photometric
    jitter; standard-normal noise like the images, or None without noise."""

    bright: torch.Tensor | None
    contrast: torch.Tensor | None
    noise: torch.Tensor | None


def corrupt_draws(gen: torch.Generator, shape, corruption: str) -> CorruptDraws:
    if corruption not in ("both", "noise", "photo"):
        raise ValueError(f"unknown corruption {corruption!r}")
    bright = contrast = noise = None
    b, dev = shape[0], gen.device
    if corruption in ("both", "photo"):
        bright = torch.rand((b, 1, 1, 1), generator=gen, device=dev) * 0.3 - 0.15
        contrast = torch.rand((b, 1, 1, 1), generator=gen, device=dev) * 0.6 + 0.7
    if corruption in ("both", "noise"):
        noise = torch.randn(tuple(shape), generator=gen, device=dev)
    return CorruptDraws(bright, contrast, noise)


def corrupt(image: torch.Tensor, draws: CorruptDraws, noise_sd: float) -> torch.Tensor:
    """Photometric jitter, then additive noise, then a clip to [0, 1]: the
    structure of the frame is kept."""
    x = image
    if draws.bright is not None:
        x = (x - 0.5) * draws.contrast + 0.5 + draws.bright
    if draws.noise is not None:
        x = x + draws.noise * noise_sd
    return torch.clamp(x, 0.0, 1.0)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=6000)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--image-size", type=int, default=128)
    parser.add_argument("--noise-sd", type=float, default=0.15)
    parser.add_argument(
        "--corruption", default="both", choices=("both", "noise", "photo"),
        help="denoising corruption: additive noise, photometric jitter, or both. "
        "Photometric invariance can remove colour cues a perceptual metric needs; "
        "'noise' keeps colour selectivity.",
    )
    parser.add_argument(
        "--warp", action="store_true",
        help="TPS-warp the clean frames (ind_3x-level warps, no jitter) before the "
        "corruption, so the trunk trains on the warped frames the perceptual loss sees",
    )
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to run (default cuda; without a GPU this raises)")
    parser.add_argument("--out", default="runs/trained_features_torch.npz")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", datefmt="%H:%M:%S")

    dev = get_device(args.device)
    faces = SyntheticBlobFaces(image_size=args.image_size)
    model = init_denoiser(0).to(dev)
    params = dict(model.named_parameters())
    # Adam at 1e-3, x0.3 at 60% of the steps and x0.1 more at 85%
    optimizer = make_optimizer(
        piecewise_constant_config(1e-3, {int(args.steps * 0.6): 0.3, int(args.steps * 0.85): 0.1}))
    opt_state = optimizer.init(params)
    warp = PairSynthesizer(WARP_PAIR) if args.warp else None
    gen = torch.Generator(dev).manual_seed(1)

    n_windows = max(1, args.steps // LOG_WINDOW)
    log_every = max(1, n_windows // 15)
    losses = []
    t0 = time.time()
    for i in range(n_windows):
        window = torch.zeros((), device=dev)
        for _ in range(LOG_WINDOW):
            with torch.no_grad():
                clean = faces.sample(gen, args.batch)["image"]
                if warp is not None:
                    # warp the clean frame: input and target stay aligned
                    clean, _ = warp.warp_view(gen, clean)
                corrupted = corrupt(clean, corrupt_draws(gen, clean.shape, args.corruption),
                                    args.noise_sd)
            pred = model(corrupted)
            loss = torch.mean(torch.square(pred - clean))
            grads = torch.autograd.grad(loss, list(params.values()))
            updates, opt_state = optimizer.update(dict(zip(params, grads)), opt_state, params)
            with torch.no_grad():
                for k, p in params.items():
                    p.add_(updates[k])
            window += loss.detach()
        if i % log_every == 0 or i == n_windows - 1:
            losses.append(float(window) / LOG_WINDOW)  # waits for the device
            print(f"step {(i + 1) * LOG_WINDOW}/{args.steps} loss={losses[-1]:.5f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    steps = n_windows * LOG_WINDOW
    wall = time.time() - t0
    save_vgg16_params(model.vgg.export_params(), args.out)
    # the file loads where it is used: the perceptual loss as the flagship
    # recipe configures it, on the last step's reconstruction and target
    perceptual = ReconstructionLoss(
        PerceptualLossConfig(feature_source="trained", trained_weights=args.out, input_scale=2),
        device=dev)
    with torch.no_grad():
        trained_loss = float(perceptual(pred.detach(), clean, perceptual.init_ema())[0])
    if not math.isfinite(trained_loss):
        raise RuntimeError(f"{args.out}: the perceptual loss on it is {trained_loss}")
    print(f"saved trained feature trunk -> {args.out} ({steps} steps, "
          f"{1000.0 * wall / steps:.2f} ms a step; perceptual loss on it {trained_loss:.5g})",
          flush=True)
    return {"steps": steps, "wall_s": wall, "ms_per_step": 1000.0 * wall / steps,
            "loss_first": losses[0], "loss_last": losses[-1], "trained_loss": trained_loss,
            "out": args.out}


if __name__ == "__main__":
    main()
