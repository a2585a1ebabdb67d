"""Rate-distortion codec simulator (the counterpart of ``repro.core.codec``).

Model: effective coded pixels P = roi_pixels * r^2 * (1 + rho*(N-1));
bpp = b*T*1000 / P; decoded = clip(round(blur_r(x) * levels) / levels +
sigma * noise, 0, 1) with levels = clip(quant_scale * bpp, 4, 256) and
sigma = sigma0 * exp(-bpp / beta); blur_r average-pools by k (k = 2 for
r = 0.75, 4 for r = 0.5), upsamples nearest and edge-pads the tail.

``_avg_pool`` sums each k x k cell in row-major order and then divides:
that is XLA's order for ``reshape(...).mean(axis=(2, 4))`` to the bit,
where ``mean`` over the reshaped axes is not.  The noise add is the fused
multiply-add XLA forms for ``x + sigma * noise``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.common.device import upload


@dataclass(frozen=True)
class CodecConfig:
    bitrates_kbps: Tuple[int, ...] = (50, 100, 200, 400, 800, 1000)
    resolutions: Tuple[float, ...] = (1.0, 0.75, 0.5)
    slot_seconds: float = 1.0
    temporal_rho: float = 0.25        # inter-frame residual cost fraction
    sigma0: float = 0.35              # noise at bpp -> 0
    beta: float = 1.6                 # bpp decay constant
    quant_scale: float = 10.0         # quantization levels per unit bpp
    crf_bpp: float = 4.0              # "visually lossless" CRF-18 analogue


def pool_factor(res: float) -> int:
    """The blur branch of a resolution: 1 (identity), 2, 4 or 8."""
    if res >= 0.999:
        return 1
    return 2 if res > 0.6 else 4 if res > 0.3 else 8


class CodecTables(NamedTuple):
    """A codec config's tables on the device, built once per run
    (``device_tables``) so that a slot step uploads nothing."""
    bitrates: torch.Tensor      # (J,) f32 Kbps
    resolutions: torch.Tensor   # (R,) f32
    pool_factors: torch.Tensor  # (R,) int32 blur branch of each resolution


def device_tables(bitrates: Sequence[int], resolutions: Sequence[float],
                  device) -> CodecTables:
    """The (bitrates, resolutions) tables and each resolution's pool factor
    on ``device``, uploaded without a host sync."""
    return CodecTables(
        bitrates=upload(bitrates, device, np.float32),
        resolutions=upload(resolutions, device, np.float32),
        pool_factors=upload([pool_factor(r) for r in resolutions], device,
                            np.int32))


def _avg_pool(frames: torch.Tensor, k: int) -> torch.Tensor:
    """(..., H, W) -> (..., H//k, W//k) cell means, row-major cell sums."""
    H, W = frames.shape[-2:]
    x = frames[..., :H // k * k, :W // k * k]
    x = x.reshape(*x.shape[:-2], H // k, k, W // k, k)
    s = None
    for i in range(k):
        for j in range(k):
            v = x[..., :, i, :, j]
            s = v if s is None else s + v
    # audit: allow(host-sync) k is the static pool factor, a Python int
    return s / float(k * k)


def blur(frames: torch.Tensor, k: int) -> torch.Tensor:
    """Average-pool by k, nearest upsample, edge-pad the tail rows and
    columns back to (H, W); k = 1 is the identity."""
    if k == 1:
        return frames
    H, W = frames.shape[-2:]
    up = _avg_pool(frames, k).repeat_interleave(k, dim=-2).repeat_interleave(
        k, dim=-1)
    ph, pw = H - up.shape[-2], W - up.shape[-1]
    if ph or pw:
        lead = up.shape[:-2]
        up = torch.nn.functional.pad(up.reshape(-1, 1, *up.shape[-2:]),
                                     (0, pw, 0, ph), mode="replicate")
        up = up.reshape(*lead, H, W)
    return up


def _resolution_blur(frames: torch.Tensor, res: float) -> torch.Tensor:
    """Downscale -> upscale loss for res < 1."""
    return blur(frames, pool_factor(res))


def nearest_resolution(resolutions, res: torch.Tensor) -> torch.Tensor:
    """(C,) requested resolutions -> (C,) int64 index of the nearest
    configured one (first on ties, like ``jnp.argmin``).  ``resolutions``
    is a sequence or, on the slot step, ``CodecTables.resolutions``."""
    table = torch.as_tensor(resolutions, dtype=torch.float32,
                            device=res.device)
    return torch.argmin(torch.abs(table[None, :] - res[:, None]), dim=1)


def rate_terms(cfg: CodecConfig, roi_pixels: torch.Tensor,
               bitrate_kbps: torch.Tensor, res: torch.Tensor,
               n_eff: torch.Tensor):
    """Per-camera scalar terms, elementwise float32 in the JAX package's
    order: (levels, sigma, size_bytes)."""
    pix = roi_pixels * res * res * (1.0 + cfg.temporal_rho * (n_eff - 1))
    bits = bitrate_kbps * 1000.0 * cfg.slot_seconds
    bpp = bits / torch.clamp(pix, min=1.0)
    levels = torch.clamp(cfg.quant_scale * bpp, 4.0, 256.0)
    sigma = cfg.sigma0 * torch.exp(-bpp / cfg.beta)
    return levels, sigma, bits / 8.0


def crf_terms(cfg: CodecConfig, roi_pixels: torch.Tensor, res: torch.Tensor,
              n_eff: torch.Tensor):
    """CRF mode's scalar terms at the fixed ``crf_bpp``: (levels, sigma,
    size_bytes = effective pixels * bpp / 8), content-proportional."""
    pix = roi_pixels * res * res * (1.0 + cfg.temporal_rho * (n_eff - 1.0))
    bpp = torch.full_like(pix, cfg.crf_bpp)
    levels = torch.clamp(cfg.quant_scale * bpp, 4.0, 256.0)
    sigma = cfg.sigma0 * torch.exp(-bpp / cfg.beta)
    return levels, sigma, pix * bpp / 8.0


def quantize_noise(x: torch.Tensor, levels, sigma, noise: torch.Tensor
                   ) -> torch.Tensor:
    """clip(round(x * levels) / levels + sigma * noise, 0, 1), the add
    fused (round half to even, like ``jnp.round``)."""
    x = torch.round(x * levels) / levels
    return torch.clamp(prng.fma(noise, sigma, x), 0.0, 1.0)


def encode_segment(cfg: CodecConfig, frames: torch.Tensor,
                   roi_pixels: torch.Tensor, bitrate_kbps: torch.Tensor,
                   res: torch.Tensor, key: torch.Tensor,
                   num_frames: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One camera: frames (N, H, W), 0-d scalars, key (2,) ->
    (decoded (N, H, W), size_bytes).  The plain oracle: every blur branch
    computed, the nearest one selected."""
    N = frames.shape[0]
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                    device=frames.device)
    n_eff = f32(N) if num_frames is None else f32(num_frames)
    res = f32(res)
    levels, sigma, size = rate_terms(cfg, f32(roi_pixels), f32(bitrate_kbps),
                                     res, n_eff)
    outs = torch.stack([_resolution_blur(frames, r)
                        for r in cfg.resolutions])
    x = outs[nearest_resolution(cfg.resolutions, res[None])[0]]
    noise = prng.normal(key, frames.shape)
    return quantize_noise(x, levels, sigma, noise), size


def encode_segment_crf(cfg: CodecConfig, frames: torch.Tensor,
                       roi_pixels: torch.Tensor, key: torch.Tensor,
                       res: Optional[torch.Tensor] = None,
                       num_frames: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CRF ("constant quality") mode for one camera: fixed bpp, size
    proportional to the effective pixels.  ``res=None`` skips the blur
    select (and charges r = 1).  The plain oracle, like
    ``encode_segment``."""
    N = frames.shape[0]
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                    device=frames.device)
    n_eff = f32(N) if num_frames is None else f32(num_frames)
    r = f32(1.0) if res is None else f32(res)
    levels, sigma, size = crf_terms(cfg, f32(roi_pixels), r, n_eff)
    x = frames
    if res is not None:
        outs = torch.stack([_resolution_blur(frames, rr)
                            for rr in cfg.resolutions])
        x = outs[nearest_resolution(cfg.resolutions, r[None])[0]]
    noise = prng.normal(key, frames.shape)
    return quantize_noise(x, levels, sigma, noise), size


def encode_fleet_segment(cfg: CodecConfig, frames: torch.Tensor,
                         roi_pixels: torch.Tensor, bitrate_kbps: torch.Tensor,
                         res: torch.Tensor, keys: torch.Tensor,
                         num_frames: Optional[torch.Tensor] = None, *,
                         tables: CodecTables
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-batched ``encode_segment`` through the tx_codec kernel:
    frames (C, N, H, W), per-camera scalars (C,), keys (C, 2) ->
    (decoded (C, N, H, W), size_bytes (C,)).  ``tables`` are the config's
    device tables (``device_tables``, built once per run)."""
    from repro_torch.kernels.tx_codec import ops as tx_ops
    return tx_ops.encode_fleet(cfg, frames, roi_pixels, bitrate_kbps, res,
                               keys, num_frames, tables=tables)


def encode_fleet_segment_crf(cfg: CodecConfig, frames: torch.Tensor,
                             roi_pixels: torch.Tensor, keys: torch.Tensor,
                             res: Optional[torch.Tensor] = None,
                             num_frames: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-batched ``encode_segment_crf`` through the tx_codec kernel
    (``res=None`` skips the blur select)."""
    from repro_torch.kernels.tx_codec import ops as tx_ops
    return tx_ops.encode_fleet_crf(cfg, frames, roi_pixels, keys, res,
                                   num_frames)
