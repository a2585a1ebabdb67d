"""Utility MLP (paper section 5.1): (a, c, b, r) -> predicted accuracy.

The counterpart of ``repro.core.utility``'s inference half: 2 hidden
layers of 32 with a sigmoid output over normalised features
(log-bitrate).  ``init_utility_mlp`` reproduces the JAX package's
``init_utility_mlp`` draws bit for bit.  The featurisation's ``log`` is the
expansion XLA uses (``prng.log``), so the features are bitwise equal.
Training (``fit``) is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.common import prng
from repro_torch.common.params import ParamDef, init_params

HIDDEN = 32

Params = Dict[str, torch.Tensor]


def utility_mlp_defs() -> Dict[str, ParamDef]:
    return {
        "w1": ParamDef((4, HIDDEN), "normal", scale=2.0),
        "b1": ParamDef((HIDDEN,), "zeros"),
        "w2": ParamDef((HIDDEN, HIDDEN), "normal", scale=2.0),
        "b2": ParamDef((HIDDEN,), "zeros"),
        "w3": ParamDef((HIDDEN, 1), "normal", scale=2.0),
        "b3": ParamDef((1,), "zeros"),
    }


def init_utility_mlp(key: torch.Tensor) -> Params:
    return init_params(key, utility_mlp_defs())


def _featurize(a, c, b_kbps, r) -> torch.Tensor:
    return torch.stack([a, c, prng.log(b_kbps / 50.0) / 3.5, r], dim=-1)


def predict(params: Params, a, c, b_kbps, r) -> torch.Tensor:
    x = _featurize(a, c, b_kbps, r)
    h = torch.relu(x @ params["w1"] + params["b1"])
    h = torch.relu(h @ params["w2"] + params["b2"])
    return torch.sigmoid(h @ params["w3"] + params["b3"])[..., 0]


def predict_grid(params: Params, a: torch.Tensor, c: torch.Tensor,
                 bitrates: torch.Tensor, resolutions: torch.Tensor
                 ) -> torch.Tensor:
    """(I,) features x (J,) bitrates x (R,) resolutions -> (I, J, R) in one
    (I*J*R, 4) MLP call."""
    I, J, R = a.shape[0], bitrates.shape[0], resolutions.shape[0]
    aa = a[:, None, None].expand(I, J, R)
    cc_ = c[:, None, None].expand(I, J, R)
    bb = bitrates[None, :, None].expand(I, J, R)
    rr = resolutions[None, None, :].expand(I, J, R)
    flat = predict(params, aa.reshape(-1), cc_.reshape(-1), bb.reshape(-1),
                   rr.reshape(-1))
    return flat.reshape(I, J, R)


def utility_table(params: Params, a: torch.Tensor, c: torch.Tensor,
                  bitrates: torch.Tensor, resolutions: torch.Tensor,
                  weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(util (I, J), best_res (I, J)): lambda-weighted best-resolution
    utility per (camera, bitrate), first resolution on ties."""
    util_r = predict_grid(params, a, c, bitrates, resolutions)
    best_r_idx = torch.argmax(util_r, dim=-1)
    best = util_r.max(dim=-1).values * weights[:, None]
    return best, resolutions[best_r_idx]
