"""Fleet encode, bitrate and CRF modes: per-camera scalar rate terms and
the noise draw here, the per-pixel transform in the tx_codec kernel
(``csrc/tx_codec.cu``) for CUDA tensors, its plain version for CPU
tensors or a stand-in for fake tensors (``analysis.trace_cost``).

The scalar terms (effective pixels, bits, bpp, levels, sigma, nearest
resolution, sizes) are (C,) float32 vectors in the order of
``repro.kernels.tx_codec.ops.encode_fleet``; the noise is the port's
threefry ``normal`` under each camera's key, the bits the JAX package
draws.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.common.device import is_fake, record_kernel
from repro_torch.common import prng
from repro_torch.core import codec
from repro_torch.kernels import build
from repro_torch.kernels.tx_codec import ref

# kernel launches since the last reset
LAUNCHES = 0
MIN_SIDE = 8          # H and W the kernel takes: at least the largest pool

_LAUNCH = None


def _launcher():
    """The kernel's C entry point, its argument types bound once."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = build.library("tx_codec").tx_codec_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def tx_codec_cuda(frames: torch.Tensor, noise: torch.Tensor,
                  levels: torch.Tensor, sigma: torch.Tensor,
                  kcam: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream; all operands on the card."""
    global LAUNCHES
    C, N, H, W = frames.shape
    want = {"frames": (frames, torch.float32, (C, N, H, W)),
            "noise": (noise, torch.float32, (C, N, H, W)),
            "levels": (levels, torch.float32, (C,)),
            "sigma": (sigma, torch.float32, (C,)),
            "kcam": (kcam, torch.int32, (C,))}
    for name, (t, dt, shape) in want.items():
        if t.device != frames.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on "
                             f"{frames.device}, got {t.device}")
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if H < MIN_SIDE or W < MIN_SIDE:
        raise ValueError(f"frames must be at least {MIN_SIDE} x {MIN_SIDE}, "
                         f"got {H} x {W}")
    out = torch.empty_like(frames)
    if any(t.data_ptr() % 16 for t in (frames, noise)):
        raise ValueError("frames and noise must start on a 16-byte boundary")
    err = _launcher()(frames.data_ptr(), noise.data_ptr(), levels.data_ptr(),
             sigma.data_ptr(), kcam.data_ptr(), out.data_ptr(), C, N, H, W,
             torch.cuda.current_stream(frames.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tx_codec kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def tx_codec_stand_in(frames: torch.Tensor) -> torch.Tensor:
    """The kernel on fake tensors (``analysis.trace_cost``): the decoded
    frames at their shape and one launch with the bound's operations and
    bytes."""
    px = frames.numel()
    record_kernel("tx_codec", 8 * px, 12 * px)
    return torch.empty(frames.shape, dtype=torch.float32,
                       device=frames.device)


def tx_codec(frames, noise, levels, sigma, kcam) -> torch.Tensor:
    """The per-pixel transform: plain version on the CPU, kernel on CUDA,
    stand-in on fake tensors."""
    if is_fake(frames, noise):
        return tx_codec_stand_in(frames)
    if frames.device.type == "cpu":
        return ref.tx_codec_ref(frames, noise, levels, sigma, kcam)
    return tx_codec_cuda(frames.contiguous(), noise.contiguous(),
                         levels.contiguous(), sigma.contiguous(),
                         kcam.contiguous())


def encode_fleet(cfg: codec.CodecConfig, frames: torch.Tensor,
                 roi_pixels: torch.Tensor, bitrate_kbps: torch.Tensor,
                 res: torch.Tensor, keys: torch.Tensor,
                 num_frames: Optional[torch.Tensor] = None, *,
                 tables: codec.CodecTables
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bitrate-mode fleet encode: frames (C, N, H, W), per-camera scalars
    (C,), keys (C, 2) -> (decoded (C, N, H, W), size_bytes (C,)).
    ``tables`` are ``cfg``'s device tables (``codec.device_tables``, built
    once per run)."""
    C, N = frames.shape[:2]
    dev = frames.device
    n_eff = (torch.full((C,), float(N), dtype=torch.float32, device=dev)
             if num_frames is None else num_frames.to(torch.float32))
    levels, sigma, size = codec.rate_terms(cfg, roi_pixels, bitrate_kbps,
                                           res, n_eff)
    kcam = _pool_factors(tables, res)
    noise = prng.normal(keys, frames.shape[1:])
    return tx_codec(frames, noise, levels, sigma, kcam), size


def _pool_factors(tables: codec.CodecTables, res: torch.Tensor
                  ) -> torch.Tensor:
    """(C,) int32 pool factor of each camera's nearest resolution."""
    return tables.pool_factors[codec.nearest_resolution(tables.resolutions,
                                                        res)]


def encode_fleet_crf(cfg: codec.CodecConfig, frames: torch.Tensor,
                     roi_pixels: torch.Tensor, keys: torch.Tensor,
                     res: Optional[torch.Tensor] = None,
                     num_frames: Optional[torch.Tensor] = None, *,
                     blur: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """CRF-mode fleet encode: fixed bpp, content-proportional sizes (C,).
    ``res=None`` or ``blur=False`` takes the identity branch for every
    camera; the r^2 term still charges when ``res`` is given."""
    C, N = frames.shape[:2]
    dev = frames.device
    n_eff = (torch.full((C,), float(N), dtype=torch.float32, device=dev)
             if num_frames is None else num_frames.to(torch.float32))
    r = (torch.ones((C,), dtype=torch.float32, device=dev) if res is None
         else res.to(torch.float32))
    levels, sigma, size = codec.crf_terms(cfg, roi_pixels, r, n_eff)
    kcam = (_pool_factors(codec.device_tables(cfg.bitrates_kbps,
                                              cfg.resolutions, dev), r)
            if blur and res is not None
            else torch.ones((C,), dtype=torch.int32, device=dev))
    noise = prng.normal(keys, frames.shape[1:])
    return tx_codec(frames, noise, levels, sigma, kcam), size
