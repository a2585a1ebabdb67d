"""DeepStream system entry point: one whole-trace episode per method.

The counterpart of ``repro.core.scheduler.DeepStreamSystem.run_episode``:
build the run's control context (bandwidth trace, lambda weights, elastic
thresholds, the jcab table, the static DP capacity), run
``fleet.fleet_episode`` on the device, and fetch the stacked logs once.
The returned log dict has the JAX package's keys.  Profiling (``profile``,
which needs the utility-MLP trainer) is not ported yet: callers set
``mlp``, ``tau_wl``/``tau_wh`` and ``jcab_table`` themselves.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.common.device import resolve_device
from repro_torch.core import allocation as alloc
from repro_torch.core import elastic as elastic_mod
from repro_torch.core import fleet as fleet_mod
from repro_torch.core.codec import CodecConfig
from repro_torch.core.elastic import ElasticConfig
from repro_torch.data.synthetic import DeviceScene, SceneConfig

METHODS = ("deepstream", "jcab", "reducto", "static")


@dataclass
class SystemConfig:
    scene: SceneConfig = field(default_factory=SceneConfig)
    codec: CodecConfig = field(default_factory=CodecConfig)
    elastic: ElasticConfig = field(default_factory=ElasticConfig)
    block_size: int = 8
    weights: Optional[np.ndarray] = None      # lambda_i (default: ones)
    eval_frames: int = 4                      # frames scored per segment
    # optional bandwidth ceiling (Kbps) pinning the DP capacity across runs
    w_cap_kbps: Optional[float] = None

    def lam(self) -> np.ndarray:
        if self.weights is None:
            return np.ones(self.scene.num_cameras, np.float64)
        return np.asarray(self.weights, np.float64)


class DeepStreamSystem:
    def __init__(self, cfg: SystemConfig, light_params: Dict[str, Any],
                 server_params: Dict[str, Any], mlp_params=None, *,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        to_dev = lambda p: (None if p is None else
                            {k: torch.as_tensor(v).to(self.device)
                             for k, v in p.items()})
        self.light = to_dev(light_params)
        self.server = to_dev(server_params)
        self.mlp = to_dev(mlp_params)
        self.tau_wl: float = 0.0
        self.tau_wh: float = float("inf")
        self.jcab_table: Optional[np.ndarray] = None   # (J, R) agnostic F1
        self._key = prng.PRNGKey(1234, device=self.device)
        self._G = fleet_mod.gt_capacity(
            cfg.scene.max_objects + cfg.scene.num_stationary)

    def _jcab_utility_table(self):
        """jcab's content-agnostic (util (C, J), best_res (C, J)): the
        (J, R) table folded and lambda-weighted for every camera."""
        jt = self.jcab_table
        C = self.cfg.scene.num_cameras
        lam = self.cfg.lam()
        util = (np.repeat(jt.max(-1)[None], C, 0)
                * lam[:, None]).astype(np.float32)
        best_res = np.repeat(np.asarray(
            self.cfg.codec.resolutions, np.float32)[jt.argmax(-1)][None], C, 0)
        return util, best_res

    def _control_context(self, method: str, trace_kbps: np.ndarray,
                         use_elastic: bool) -> Dict[str, Any]:
        """Per-run uploads: the trace, lambda, thresholds, the jcab table,
        a fresh elastic state and the static DP capacity."""
        cfgc = self.cfg.codec
        dev = self.device
        bitrates = tuple(int(b) for b in cfgc.bitrates_kbps)
        borrow = (self.cfg.elastic.budget_kbits / cfgc.slot_seconds
                  if use_elastic else 0.0)
        w_cap = alloc.trace_capacity(
            bitrates, trace_kbps, self.cfg.scene.num_cameras,
            elastic_borrow_kbps=borrow, pin_kbps=self.cfg.w_cap_kbps)
        f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=dev)
        ctx: Dict[str, Any] = dict(
            trace=f32(trace_kbps), lam=f32(self.cfg.lam()),
            tau_wl=f32(self.tau_wl), tau_wh=f32(self.tau_wh), w_cap=w_cap,
            est=elastic_mod.init_state(dev), jcab_util=None, jcab_res=None)
        if method == "jcab":
            util, best_res = self._jcab_utility_table()
            ctx["jcab_util"], ctx["jcab_res"] = f32(util), f32(best_res)
        return ctx

    def run_episode(self, scene: DeviceScene, trace_kbps: np.ndarray,
                    method: str = "deepstream",
                    use_elastic: Optional[bool] = None,
                    faults: Optional[np.ndarray] = None
                    ) -> Dict[str, np.ndarray]:
        """One whole bandwidth trace on the device, then one log fetch.
        ``faults`` is an optional (T, C) bool liveness mask."""
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}")
        if use_elastic is None:
            use_elastic = method == "deepstream"
        if not isinstance(scene, DeviceScene):
            raise TypeError(f"run_episode needs a DeviceScene, got "
                            f"{type(scene)!r}")
        if scene.device != self.device:
            raise ValueError(f"scene lives on {scene.device}, the system on "
                             f"{self.device}")
        if scene.G != self._G:
            raise ValueError(f"scene GT capacity {scene.G} != {self._G}")
        C = self.cfg.scene.num_cameras
        lam = self.cfg.lam()
        ctx = self._control_context(method, trace_kbps, use_elastic)
        out = fleet_mod.fleet_episode(
            method, codec_cfg=self.cfg.codec, scene_cfg=scene.cfg,
            server_params=self.server, light_params=self.light,
            mlp_params=self.mlp if method == "deepstream" else None,
            jcab_util=ctx["jcab_util"], jcab_res=ctx["jcab_res"],
            lam=ctx["lam"], scene_params=scene.params, trace=ctx["trace"],
            key0=self._key, skey=scene.key, tau_wl=ctx["tau_wl"],
            tau_wh=ctx["tau_wh"], est0=ctx["est"], ecfg=self.cfg.elastic,
            bitrates=tuple(self.cfg.codec.bitrates_kbps),
            resolutions=tuple(self.cfg.codec.resolutions),
            use_elastic=use_elastic, w_cap=ctx["w_cap"], num_cams=C,
            eval_frames=self.cfg.eval_frames, block_size=self.cfg.block_size,
            gt_pad=self._G, t_start=scene._t, faults=faults)
        scene._t += len(trace_kbps)
        # the one harvest of the stacked logs
        packs = out.packs.cpu().numpy()
        cpacks = out.cpacks.cpu().numpy()
        return {
            "utility": packs[:, 0] @ lam,
            "mean_f1": packs[:, 0].mean(axis=1),
            "bytes": packs[:, 1].sum(axis=1),
            "W": np.asarray(trace_kbps, float),
            "extra": cpacks[:, 0].astype(float),
            "area": cpacks[:, 1].astype(float),
            "alloc_kbps": cpacks[:, 2].astype(float),
        }
