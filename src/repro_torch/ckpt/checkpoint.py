"""Read-only restore of the JAX package's committed checkpoints.

The detector weights ship as checkpoint directories
(``artifacts/detector_{light,server}/``): ``manifest.json`` lists each leaf
under its pytree key string (``"['c1']"``) with shape, dtype, codec
(``zlib``; ``zstd`` where the ``zstandard`` module exists), byte
``offset``/``nbytes`` into ``data.<pid>.bin`` and, from format 2 on, the
crc32 and length of the raw bytes.  This module reads that layout with
numpy and the standard library only, so the port loads its weights on a
machine with no JAX.
"""
from __future__ import annotations

import json
import re
import zlib
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

COMMIT_MARKER = "COMMITTED"
_KEY = re.compile(r"^\['([^']+)'\]$")


class CheckpointCorruptError(RuntimeError):
    """A leaf failed its bounds, decompression or checksum check."""


def _decompress(blob: bytes, codec: str) -> bytes:
    if codec == "zlib":
        try:
            return zlib.decompress(blob)
        except zlib.error as e:
            raise CheckpointCorruptError(f"zlib: {e}") from e
    if codec == "zstd":
        import zstandard
        try:
            return zstandard.ZstdDecompressor().decompress(blob)
        except zstandard.ZstdError as e:
            raise CheckpointCorruptError(f"zstd: {e}") from e
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _leaf_name(key: str) -> str:
    m = _KEY.match(key)
    if m is None:
        raise ValueError(f"only flat dict checkpoints are supported, got "
                         f"leaf key {key!r}")
    return m.group(1)


def restore(path) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Checkpoint directory -> (``{name: array}``, metadata with ``step``).

    Every leaf is bounds-checked and, where the manifest records them, its
    raw length and crc32 are verified."""
    path = Path(path)
    if path.name.endswith(".tmp") or not (path / COMMIT_MARKER).exists():
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    manifest = json.loads((path / "manifest.json").read_text())
    out: Dict[str, np.ndarray] = {}
    for key, ent in manifest["leaves"].items():
        fp = path / ent["file"]
        size = fp.stat().st_size
        if ent["offset"] + ent["nbytes"] > size:
            raise CheckpointCorruptError(f"{path.name}: leaf {key}: data "
                                         "file truncated")
        with open(fp, "rb") as f:
            f.seek(ent["offset"])
            blob = f.read(ent["nbytes"])
        try:
            raw = _decompress(blob, ent.get("codec", "zstd"))
        except CheckpointCorruptError as e:
            raise CheckpointCorruptError(f"{path.name}: leaf {key}: "
                                         f"decompress failed: {e}") from e
        if "raw_nbytes" in ent and len(raw) != ent["raw_nbytes"]:
            raise CheckpointCorruptError(f"{path.name}: leaf {key}: raw "
                                         "length mismatch")
        if "crc32" in ent and zlib.crc32(raw) != ent["crc32"]:
            raise CheckpointCorruptError(f"{path.name}: leaf {key}: crc32 "
                                         "mismatch")
        arr = np.frombuffer(raw, dtype=ent["dtype"]).reshape(ent["shape"])
        out[_leaf_name(key)] = arr.copy()
    return out, manifest.get("metadata", {}) | {"step": manifest["step"]}
