"""Utility MLP (paper section 5.1): (a, c, b, r) -> predicted accuracy.

The counterpart of ``repro.core.utility``: 2 hidden layers of 32 with a
sigmoid output over normalised features (log-bitrate), and ``fit``, which
trains it on profiled (features, F1) pairs with the port's AdamW
(``train/optimizer.py``).  ``init_utility_mlp`` reproduces the JAX
package's ``init_utility_mlp`` draws bit for bit.  The featurisation's
``log`` is the expansion XLA uses (``prng.log``), so the features are
bitwise equal.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.common.config import OptimizerConfig
from repro_torch.common.device import upload
from repro_torch.common.params import ParamDef, init_params
from repro_torch.train.optimizer import adamw_update, init_opt_state

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
    return _mlp(params, _featurize(a, c, b_kbps, r))


def _mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
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


def fit(params: Params, features: np.ndarray, targets: np.ndarray, *,
        steps: int = 800, lr: float = 3e-3) -> Tuple[Params, float]:
    """Fit the MLP to measured F1: features (n, 4) raw (a, c, b_kbps, r),
    targets (n,), the mean squared error through autograd, AdamW (warmup
    20 steps, cosine to ``steps``, decay 1e-4 on matrices, clip 1.0) on
    the parameters' device.  The loop reads nothing back: the clip and the
    schedule stay tensors, and the loss is fetched once, after it.
    Returns (fitted params, final-step loss)."""
    dev = params["w1"].device
    feats = upload(features, dev, np.float32)
    tgts = upload(targets, dev, np.float32)
    x = _featurize(feats[:, 0], feats[:, 1], feats[:, 2], feats[:, 3])
    opt_cfg = OptimizerConfig(lr=lr, warmup_steps=20, total_steps=steps,
                              weight_decay=1e-4, grad_clip=1.0)
    params = {k: v.detach() for k, v in params.items()}
    opt = init_opt_state(opt_cfg, params)
    names = sorted(params)
    loss = None
    for _ in range(steps):
        p = {k: params[k].requires_grad_(True) for k in names}
        loss = torch.mean(torch.square(_mlp(p, x) - tgts))
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        with torch.no_grad():
            params, opt, _ = adamw_update(
                opt_cfg, {k: p[k].detach() for k in names},
                dict(zip(names, grads)), opt)
    return params, float(loss.detach())
