"""Train the conv detectors on synthetic scenes (cached to artifacts/).

The counterpart of ``repro.train.detector_train``.  The server detector's
F1 is the system's utility; the light variant is ROIDet's on-camera
model.  Each step is the loss and its gradients by autograd, then the
port's AdamW (``train/optimizer.py``); a batch comes from the numpy
``MultiCameraScene`` and goes up through ``device.upload`` (pinned,
asynchronous), so the loop never waits on the card: the loss is read once,
when it is saved.

With ``cache=True`` and a committed ``artifacts/detector_<variant>`` the
weights are restored from it; otherwise they are trained, and (``cache``)
saved there in JAX's layout (HWIO kernels, ``{"variant", "loss"}``
metadata), so the JAX package restores them too.

On the card, cuDNN's TF32 mode rounds the convolutions' inputs to 10
mantissa bits: a caller who leaves ``torch.backends.cudnn.allow_tf32`` on
trains other weights than the CPU does.
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.common import prng
from repro_torch.common.config import OptimizerConfig
from repro_torch.common.convert import params_from_numpy, params_to_numpy
from repro_torch.common.device import resolve_device, upload
from repro_torch.data.synthetic import MultiCameraScene, SceneConfig
from repro_torch.models import detector as det
from repro_torch.train.optimizer import adamw_update, init_opt_state
from repro_torch.train.steps import value_and_grad

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts"


def make_training_batch(scene: MultiCameraScene, rng: np.random.Generator,
                        batch: int = 16, degrade: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(frames (B, H, W), targets (B, H/16, W/16, 5)): one random frame
    per camera of each new segment, half of them degraded by codec-like
    quantisation and noise (the JAX draws, in the JAX order)."""
    cfg = scene.cfg
    gy, gx = cfg.height // det.STRIDE, cfg.width // det.STRIDE
    frames, targets = [], []
    while len(frames) < batch:
        seg = scene.segment()
        for cam in range(cfg.num_cameras):
            f = rng.integers(0, cfg.frames_per_segment)
            img = seg["frames"][cam, f]
            if degrade and rng.uniform() < 0.5:
                lv = rng.uniform(8, 64)
                img = np.round(img * lv) / lv
                img = np.clip(img + rng.normal(0, rng.uniform(0, 0.1),
                                               img.shape), 0, 1)
            frames.append(img.astype(np.float32))
            targets.append(det.encode_targets(seg["boxes"][cam][f], gy, gx))
            if len(frames) >= batch:
                break
    return np.stack(frames), np.stack(targets)


def train_detector(variant: str = "server", steps: int = 300,
                   batch: int = 16, seed: int = 0, cache: bool = True,
                   scene_cfg: SceneConfig | None = None, device=None
                   ) -> det.Params:
    """The detector's weights (OIHW tensors on ``device``, the card by
    default): restored from ``ARTIFACTS/detector_<variant>`` when
    ``cache`` and it is committed, else trained for ``steps`` steps of
    ``batch`` frames from ``init_detector(PRNGKey(seed))`` on
    ``MultiCameraScene(scene_cfg or SceneConfig(seed=seed + 100))`` and,
    with ``cache``, saved there."""
    dev = resolve_device(device)
    scene_cfg = scene_cfg or SceneConfig(seed=seed + 100)
    cache_dir = ARTIFACTS / f"detector_{variant}"
    if cache and ckpt.is_committed(cache_dir):
        tree, _ = ckpt.restore(cache_dir)
        return params_from_numpy(tree, "detector", device=dev)

    params = det.init_detector(prng.PRNGKey(seed, device=dev), variant)
    opt_cfg = OptimizerConfig(lr=2e-3, warmup_steps=20, total_steps=steps,
                              weight_decay=1e-4, grad_clip=5.0)
    opt = init_opt_state(opt_cfg, params)
    scene = MultiCameraScene(scene_cfg)
    rng = np.random.default_rng(seed)
    loss = None
    for _ in range(steps):
        fr, tg = make_training_batch(scene, rng, batch)
        loss, grads = value_and_grad(det.detection_loss, params,
                                     upload(fr, dev), upload(tg, dev))
        params, opt, _ = adamw_update(opt_cfg, params, grads, opt)
    if cache:
        ckpt.save(params_to_numpy(params, "detector"), cache_dir, step=steps,
                  metadata={"variant": variant, "loss": float(loss)})
    return params
