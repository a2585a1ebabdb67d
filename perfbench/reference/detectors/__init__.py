"""The plain reference's server detectors, one module per architecture.

A fleet configuration names its server detector's architecture under
``detectors.server_arch``; the module ``<server_arch>.py`` in this folder
(or in the ``detectors`` folder of a copied benchmark) computes it in
plain torch and imports nothing of the program.  Each module gives:

- ``load(config, weights_dir, device)``: the detector's parameters, read
  or made without the program;
- ``forward(params, frames, dtype)``: frames (B, H, W) in [0, 1] -> the
  raw output, the layers computed in ``dtype`` (float32 as configured;
  bfloat16 for the correctness check's control);
- ``decode(raw, conf_thresh, k)``: -> boxes (B, k, 4) xyxy in frame
  pixels, scores (B, k) and valid flags (B, k);
- ``flops(config)``: the floating-point operations of one frame.
"""
from __future__ import annotations

import importlib
import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent
_LOADED: Dict[Path, ModuleType] = {}


def server_module(config: Dict, root: Optional[Path] = None) -> ModuleType:
    """The module of ``config``'s server detector, from ``root`` (default:
    this folder)."""
    arch = config["detectors"]["server_arch"]
    folder = HERE if root is None else Path(root).resolve()
    if folder == HERE:
        return importlib.import_module(f"{__name__}.{arch}")
    path = folder / f"{arch}.py"
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"perfbench_detector_{arch}", path)
        if spec is None or spec.loader is None:
            raise ImportError(f"cannot load {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
