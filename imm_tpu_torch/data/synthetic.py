"""Procedural blob-face dataset with known ground-truth landmarks, generated on
the device from a ``torch.Generator``. Mirrors ``imm_tpu.data.synthetic``.

Each face is an elliptical head and 5 coloured blob parts (two eyes, nose,
two mouth corners) over a vertical-gradient background. Identity (colours,
part offsets) and pose (a similarity transform of the part template) are
independent latents, so ``sample_pair`` emits video-style pairs: one
identity in two poses. Landmarks are the part centres, (y, x) in [-1, 1].

The random draws (``draw_identity``, ``draw_pose``, the pixel noise) are kept
apart from ``_landmarks`` / ``_render``, which are deterministic, so a test
can hand both packages the same latents. The two packages' random streams
differ: the same seed gives other faces.
"""

from __future__ import annotations

import dataclasses

import torch

# Part template in face frame: (y, x) in [-1, 1]-ish face units.
_TEMPLATE = (
    (-0.15, -0.22),  # left eye
    (-0.15, 0.22),  # right eye
    (0.08, 0.0),  # nose
    (0.32, -0.18),  # mouth left
    (0.32, 0.18),  # mouth right
)
_PART_SIGMA = (0.06, 0.06, 0.05, 0.045, 0.045)
_HEAD_SIGMA = (0.55, 0.45)  # (y, x) ellipse sigmas


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


@dataclasses.dataclass(frozen=True, unsafe_hash=True)
class SyntheticBlobFaces:
    """On-device generator of blob faces; see the module docstring."""

    image_size: int = 128
    rot_sd: float = 0.25  # radians of pose rotation
    scale_sd: float = 0.12  # log-scale sd
    trans_range: float = 0.25  # uniform center offset
    offset_sd: float = 0.03  # identity-specific part offsets
    noise_sd: float = 0.02
    dtype: str = "float32"
    # Pose correlation between the two frames of ``sample_pair``: 0 draws
    # them independently; g in (0, 1] interpolates frame A's pose toward a
    # fresh draw (scale in log-space).
    pair_pose_gap: float = 0.0

    @property
    def n_landmarks(self) -> int:
        return len(_TEMPLATE)

    # -- latents ----------------------------------------------------------

    def draw_identity(self, gen: torch.Generator, batch: int):
        """-> part_colors (B, 1+K, 3), offsets (B, K, 2), bg (B, 2, 3)."""
        part_colors = _uniform(gen, (batch, 1 + self.n_landmarks, 3), 0.15, 1.0)
        offsets = _normal(gen, (batch, self.n_landmarks, 2)) * self.offset_sd
        bg = _uniform(gen, (batch, 2, 3), 0.0, 0.6)
        return part_colors, offsets, bg

    def draw_pose(self, gen: torch.Generator, batch: int):
        """-> rot (B,), scale (B,), center (B, 2)."""
        rot = _normal(gen, (batch,)) * self.rot_sd
        scale = torch.exp(_normal(gen, (batch,)) * self.scale_sd)
        center = _uniform(gen, (batch, 2), -self.trans_range, self.trans_range)
        return rot, scale, center

    def draw_noise(self, gen: torch.Generator, batch: int) -> torch.Tensor:
        """Standard-normal pixel noise (B, S, S, 3); ``_render`` scales it."""
        s = self.image_size
        return _normal(gen, (batch, s, s, 3))

    def _landmarks(self, offsets, rot, scale, center):
        """Apply the pose similarity to the (identity-offset) template."""
        template = torch.tensor(_TEMPLATE, dtype=offsets.dtype, device=offsets.device)
        pts = template[None] + offsets  # (B, K, 2)
        cos = (torch.cos(rot) * scale)[:, None]
        sin = (torch.sin(rot) * scale)[:, None]
        y = cos * pts[:, :, 0] - sin * pts[:, :, 1] + center[:, None, 0]
        x = sin * pts[:, :, 0] + cos * pts[:, :, 1] + center[:, None, 1]
        return torch.stack([y, x], dim=-1)

    # -- rendering --------------------------------------------------------

    def _render(self, landmarks, part_colors, bg, rot, scale, center, noise):
        """Latents + standard-normal ``noise`` (B, S, S, 3) -> images in [0, 1]."""
        s = self.image_size
        dev = landmarks.device
        ys = torch.linspace(-1.0, 1.0, s, device=dev)
        gy, gx = torch.meshgrid(ys, ys, indexing="ij")  # (S, S)

        # Background: vertical gradient between two identity colours.
        t = (gy[None, :, :, None] + 1.0) * 0.5
        canvas = bg[:, 0][:, None, None, :] * (1 - t) + bg[:, 1][:, None, None, :] * t

        # Head: rotated anisotropic Gaussian ellipse, painter-composited.
        dy = gy[None] - center[:, 0, None, None]
        dx = gx[None] - center[:, 1, None, None]
        cos = torch.cos(rot)[:, None, None]
        sin = torch.sin(rot)[:, None, None]
        sc = scale[:, None, None]
        fy = (cos * dy + sin * dx) / sc
        fx = (-sin * dy + cos * dx) / sc
        head_a = torch.exp(-0.5 * ((fy / _HEAD_SIGMA[0]) ** 2 + (fx / _HEAD_SIGMA[1]) ** 2))
        head_a = torch.clamp(head_a * 1.4, 0.0, 1.0)[..., None]
        canvas = canvas * (1 - head_a) + part_colors[:, 0][:, None, None, :] * head_a

        # Parts: isotropic Gaussians at landmark positions (scaled with pose).
        sig = torch.tensor(_PART_SIGMA, device=dev)[None] * scale[:, None]  # (B, K)
        for k in range(self.n_landmarks):
            d2 = (gy[None] - landmarks[:, k, 0, None, None]) ** 2 + (
                gx[None] - landmarks[:, k, 1, None, None]
            ) ** 2
            a = torch.exp(-0.5 * d2 / (sig[:, k, None, None] ** 2 + 1e-8))
            a = torch.clamp(a * 1.5, 0.0, 1.0)[..., None]
            canvas = canvas * (1 - a) + part_colors[:, 1 + k][:, None, None, :] * a

        out = torch.clamp(canvas + noise * self.noise_sd, 0.0, 1.0)
        return out.to(getattr(torch, self.dtype))

    # -- public API -------------------------------------------------------

    def sample(self, gen: torch.Generator, batch: int) -> dict[str, torch.Tensor]:
        """One frame per identity: {'image': (B,S,S,3), 'landmarks': (B,K,2)},
        on ``gen``'s device."""
        part_colors, offsets, bg = self.draw_identity(gen, batch)
        rot, scale, center = self.draw_pose(gen, batch)
        lm = self._landmarks(offsets, rot, scale, center)
        img = self._render(lm, part_colors, bg, rot, scale, center, self.draw_noise(gen, batch))
        return {"image": img, "landmarks": lm}

    def _pose_near(self, gen, pose_a, batch):
        """Frame-B pose: A's pose interpolated toward a fresh draw by
        ``g = pair_pose_gap`` (scale in log-space)."""
        g = self.pair_pose_gap
        rot_a, scale_a, center_a = pose_a
        rot_f, scale_f, center_f = self.draw_pose(gen, batch)
        rot = (1.0 - g) * rot_a + g * rot_f
        scale = scale_a ** (1.0 - g) * scale_f**g
        center = (1.0 - g) * center_a + g * center_f
        return rot, scale, center

    def sample_pair(self, gen: torch.Generator, batch: int) -> dict[str, torch.Tensor]:
        """Video-style pair: one identity, two poses (independent at
        ``pair_pose_gap=0``, A-correlated otherwise)."""
        part_colors, offsets, bg = self.draw_identity(gen, batch)
        pose_a = self.draw_pose(gen, batch)
        if self.pair_pose_gap <= 0:
            pose_b = self.draw_pose(gen, batch)
        else:
            pose_b = self._pose_near(gen, pose_a, batch)
        out = {}
        for name, (rot, scale, center) in (("a", pose_a), ("b", pose_b)):
            lm = self._landmarks(offsets, rot, scale, center)
            noise = self.draw_noise(gen, batch)
            out[f"image_{name}"] = self._render(lm, part_colors, bg, rot, scale, center, noise)
            out[f"landmarks_{name}"] = lm
        return out

    @staticmethod
    def interocular(landmarks: torch.Tensor) -> torch.Tensor:
        """(B, K, 2) -> (B,) eye separation (the %IOD denominator)."""
        return torch.linalg.norm(landmarks[:, 0] - landmarks[:, 1], dim=-1)
