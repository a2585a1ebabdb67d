"""Atomic, checksummed, self-healing checkpoints in the JAX package's format.

The counterpart of ``repro.ckpt.checkpoint``, with numpy, the standard
library and torch only, so the port saves and restores on a machine with
no JAX.  The layout is the JAX package's format 2, byte for byte:

  * one directory per step: ``manifest.json`` (format, step, user
    metadata, the leaf keys, and per leaf its shape, dtype, codec,
    ``offset``/``nbytes`` into ``data.0.bin`` and the crc32 and length of
    its raw bytes) + ``data.0.bin`` (one compressed frame per leaf:
    ``zstd`` where the ``zstandard`` module exists, else ``zlib``);
  * leaves are named by JAX's key strings (``['est'].a_ema``, ``['ref']``;
    dict keys sorted, NamedTuple fields by name, sequence items by index),
    so a checkpoint written by either package restores in the other;
  * atomic commit: everything goes to ``<dir>.tmp``, then the ``COMMITTED``
    marker, an fsync'd rename and an fsync of the parent; a ``*.tmp``
    directory is never committed, so a crash mid-save leaves the previous
    generation as the newest restorable one.

``AsyncSaver`` takes the snapshot on the calling thread (``snapshot``:
every device tensor of the tree in ONE device-to-host transfer) and hands
numpy arrays to a writer thread, which compresses, writes and commits;
the serving loop pays for the snapshot only.  ``restore(path, target)``
verifies every leaf (bounds, decompression, raw length, crc32) and raises
``CheckpointCorruptError`` naming the leaf and the field that failed;
``verify_checkpoint`` runs the same battery without building arrays,
``latest_valid`` falls back through the generations to the newest one that
verifies, and ``gc_generations`` keeps the newest N but never deletes the
newest valid generation.  A leaf whose dtype differs from the target's is
cast on restore (the run key: uint32 in the file, int64 in the port).
A bfloat16 leaf (the LM's weights) is written with JAX's dtype name
``"bfloat16"`` and its 2-byte patterns; numpy has no bfloat16 of its own,
so on the host it is a ``Bf16Bits`` array of those patterns (uint16).

Under a camera mesh the caller hands ``save`` the whole fleet's tree and
calls it on rank 0 only (``serve.stream`` gathers the carry first); every
rank restores from the same files, at any world size.

Under the LM mesh every rank calls ``save(tree, path, mesh=mesh,
placements=specs)`` with its pieces and their specs (a tree of
``sharding.rules`` specs in the tree's structure): leaf by leaf, rank 0
gathers every rank's piece (``dist.gather``), puts the whole logical
array together, brings it to the host and writes it, so rank 0 holds one
whole leaf at a time and the others nothing beyond their pieces; then
rank 0 commits JAX's format; ``restore(path, target, mesh=mesh,
placements=specs)`` reads the whole arrays and gives each rank its piece.
The file holds whole arrays only, so a checkpoint saved on one mesh
restores onto any other mesh, or onto none (JAX's elastic restore).

``restore(path)`` without a target reads a flat ``{name: array}``
checkpoint (the committed detector weights) into numpy.

``AsyncSaver`` accepts a duck-typed ``chaos`` engine (``ft.chaos``) and
calls ``on_save_start(step)`` before writing and ``on_save_committed(path,
step)`` after the atomic rename: corruption is injected at the boundaries
where real storage rot happens, never inside the commit protocol.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import trace
from repro_torch.common.device import upload

try:
    import zstandard as zstd
    HAVE_ZSTD = True
except ImportError:          # no zstandard: write zlib frames
    zstd = None
    HAVE_ZSTD = False

COMMIT_MARKER = "COMMITTED"
# format 2: per-leaf raw-byte crc32 and length (format-1 checkpoints
# restore without checksum verification)
MANIFEST_FORMAT = 2
_FLAT_KEY = re.compile(r"^\['([^']+)'\]$")
BF16 = "bfloat16"


class Bf16Bits(np.ndarray):
    """A bfloat16 leaf on the host: its bit patterns as uint16."""


def _dtype_name(arr: np.ndarray) -> str:
    return BF16 if isinstance(arr, Bf16Bits) else str(arr.dtype)


def _itemsize(name: str) -> int:
    return 2 if name == BF16 else np.dtype(name).itemsize


def _from_raw(raw: bytes, ent: Dict) -> np.ndarray:
    """A leaf's raw bytes as an array of its manifest dtype and shape."""
    if ent["dtype"] == BF16:
        arr = np.frombuffer(raw, np.uint16).view(Bf16Bits)
    else:
        arr = np.frombuffer(raw, dtype=ent["dtype"])
    return arr.reshape(ent["shape"])


class CheckpointCorruptError(RuntimeError):
    """A committed checkpoint failed content verification (checksum
    mismatch, truncated data, torn manifest).  Callers holding generation
    history fall back (``latest_valid``)."""


def _compress(data: bytes) -> Tuple[bytes, str]:
    if HAVE_ZSTD:
        return zstd.ZstdCompressor(level=3).compress(data), "zstd"
    return zlib.compress(data, 3), "zlib"


def _decompress(blob: bytes, codec: str) -> bytes:
    if codec == "zstd":
        if not HAVE_ZSTD:
            raise RuntimeError("checkpoint was written with zstd but "
                               "zstandard is not installed")
        return zstd.ZstdDecompressor().decompress(blob)
    if codec == "zlib":
        return zlib.decompress(blob)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


# -- trees ---------------------------------------------------------------------
# A tree is a nest of dicts, NamedTuples, tuples and lists with tensors,
# numpy arrays or scalars at the leaves (None is an empty subtree), walked
# in JAX's order.

def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(key string suffix, child) pairs of an inner node, None for a
    leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(JAX key string, leaf)] in JAX's flattening order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [kv for k, v in kids for kv in _flatten(v, prefix + k)]


def _rebuild(tree, leaves):
    """``tree`` with its leaves replaced, in order, from the iterator
    ``leaves``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    vals = [_rebuild(v, leaves) for _, v in kids]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), vals))
    if hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)


def _np_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((0,), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _bytes_as(raw: np.ndarray, x: torch.Tensor) -> np.ndarray:
    """``x``'s bytes (uint8) as a host array of its dtype and shape."""
    if x.dtype == torch.bfloat16:
        return raw.view(np.uint16).reshape(tuple(x.shape)).view(Bf16Bits)
    return raw.view(_np_dtype(x.dtype)).reshape(tuple(x.shape))


def snapshot(tree):
    """``tree`` with every leaf as a numpy array.  All tensors that lie on
    a device come back in ONE transfer (their bytes concatenated on the
    device), so a snapshot waits on the card once; CPU tensors and numpy
    leaves are copied."""
    leaves = [v for _, v in _flatten(tree)]
    on_dev = [x for x in leaves
              if torch.is_tensor(x) and x.device.type != "cpu"]
    fetched: Dict[int, np.ndarray] = {}
    if on_dev:
        flat = torch.cat([x.detach().contiguous().reshape(-1)
                          .view(torch.uint8) for x in on_dev])
        host = flat.cpu().numpy()
        off = 0
        for x in on_dev:
            n = x.numel() * x.element_size()
            fetched[id(x)] = _bytes_as(host[off:off + n], x).copy()
            off += n

    def host_of(x) -> np.ndarray:
        if id(x) in fetched:
            return fetched[id(x)]
        if torch.is_tensor(x):
            x = x.detach().contiguous().cpu()
            return _bytes_as(x.reshape(-1).view(torch.uint8).numpy(),
                             x).copy()
        return np.array(x)
    return _rebuild(tree, iter([host_of(x) for x in leaves]))


# -- save ---------------------------------------------------------------------

class AsyncSaver:
    """Background-thread checkpoint writer with atomic commit, bounded
    retention (``keep``) and chaos hooks (``chaos``).  ``write_s`` holds
    the writer's seconds per committed save (span ``ckpt.write``:
    compress, write, commit, gc); ``snapshot_s`` the calling thread's
    seconds per snapshot (span ``ckpt.snapshot``)."""

    def __init__(self, keep: Optional[int] = None, chaos: Any = None):
        if keep is not None and keep < 1:
            raise ValueError(f"keep must be >= 1 (got {keep})")
        self.keep = keep
        self.chaos = chaos
        self.gc_removed: List[str] = []   # generation dirs gc deleted
        self.write_s: List[float] = []
        self.snapshot_s: List[float] = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, tree: Any, path, *, step: int = 0,
             metadata: Optional[Dict] = None, blocking: bool = False,
             dtypes: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot ``tree`` now, write it to ``path`` on the writer thread
        (or here, ``blocking``).  ``dtypes`` maps leaf key strings to the
        dtype they are written in (the port's int64 run key as uint32).
        Spans: ``ckpt.wait`` (for the previous write), ``ckpt.snapshot``;
        on the writer, ``ckpt.write`` with ``window=step`` and its parts
        (``_write_checkpoint``, ``ckpt.gc``)."""
        with trace.span("ckpt.wait"):
            self.wait()  # one outstanding save at a time
        with trace.timer("ckpt.snapshot") as tm:
            host = snapshot(tree)
        self.snapshot_s.append(tm.seconds)
        host_leaves = [(k, v.astype(dtypes[k]) if dtypes and k in dtypes
                        else v) for k, v in _flatten(host)]
        # the manifest's tree field (the JAX package writes its PyTreeDef;
        # restore reads the leaf keys, never this)
        treedef_str = repr([k for k, _ in host_leaves])

        def _write():
            try:
                with trace.timer("ckpt.write", window=step) as tm:
                    if self.chaos is not None:
                        self.chaos.on_save_start(step)
                    _write_checkpoint(host_leaves, treedef_str, Path(path),
                                      step=step, metadata=metadata or {})
                    if self.chaos is not None:
                        self.chaos.on_save_committed(Path(path), step)
                    if self.keep is not None:
                        with trace.span("ckpt.gc"):
                            self.gc_removed.extend(
                                str(p) for p in gc_generations(
                                    Path(path).parent, self.keep))
                self.write_s.append(tm.seconds)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if blocking:
            _write()
            if self._error:
                err, self._error = self._error, None
                raise err
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()


def _write_file(path: Path, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


def _write_checkpoint(host_leaves, treedef_str: str, path: Path, *,
                      step: int, metadata: Dict) -> None:
    """Write and commit one generation.  Spans: ``ckpt.compress`` (each
    leaf compressed, checksummed and written), ``ckpt.data_fsync``,
    ``ckpt.manifest`` (its JSON, the metadata's logs included, written and
    fsync'd) and ``ckpt.commit`` (the marker, the rename and the
    directory's fsync); counter ``ckpt.bytes`` (the data and manifest
    bytes written)."""
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"format": MANIFEST_FORMAT, "step": step, "metadata": metadata,
                "treedef": treedef_str, "leaves": {}}
    data_path = tmp / "data.0.bin"
    with open(data_path, "wb") as f:
        with trace.span("ckpt.compress"):
            for key, arr in host_leaves:
                raw = np.ascontiguousarray(arr).tobytes()
                blob, codec = _compress(raw)
                off = f.tell()
                f.write(blob)
                manifest["leaves"][key] = {
                    "shape": list(arr.shape), "dtype": _dtype_name(arr),
                    "offset": off, "nbytes": len(blob),
                    "file": data_path.name, "codec": codec,
                    "crc32": zlib.crc32(raw), "raw_nbytes": len(raw),
                }
        with trace.span("ckpt.data_fsync"):
            f.flush()
            os.fsync(f.fileno())
        nbytes = f.tell()
    with trace.span("ckpt.manifest"):
        text = json.dumps(manifest)
        _write_file(tmp / "manifest.json", text)
    trace.count("ckpt.bytes", nbytes + len(text))
    with trace.span("ckpt.commit"):
        _write_file(tmp / COMMIT_MARKER, "ok")
        if path.exists():
            shutil.rmtree(path)
        os.rename(tmp, path)
        dfd = os.open(path.parent, os.O_RDONLY)   # make the rename durable
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)


def _spec_leaves(tree, specs) -> List[Any]:
    """The specs of ``tree``'s leaves, in ``_flatten`` order (``specs``
    has the tree's structure with a spec tuple at each leaf)."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [specs]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k],
                                                              specs[k])]
    if hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _spec_leaves(getattr(tree, f), getattr(specs, f))]
    return [x for t, sp in zip(tree, specs) for x in _spec_leaves(t, sp)]


def _whole_leaves(tree, mesh, placements, dtypes):
    """(key, whole host array) of each leaf of ``tree`` (this rank's
    pieces, laid out by ``placements``), one leaf at a time, on rank 0;
    the other ranks send their pieces and get nothing.  Every rank must
    drain the generator: each leaf is one collective."""
    import torch.distributed as dist
    from repro_torch.sharding.rules import axes_size, spec_axes
    rank0 = dist.get_rank() == 0
    for (key, x), spec in zip(_flatten(tree), _spec_leaves(tree,
                                                           placements)):
        if torch.is_tensor(x):
            x = x.detach().contiguous()
            parts = ([torch.empty_like(x) for _ in range(dist.get_world_size())]
                     if rank0 else None)
            dist.gather(x, parts, dst=0)
            if not rank0:
                continue
            dims = list(zip(x.shape, tuple(spec) + (None,) * x.dim()))
            whole = x.new_empty([n * axes_size(mesh, e) for n, e in dims])
            for r, part in enumerate(parts):
                # rank r's piece sits at its index along each cut's axes
                at = [mesh.index(spec_axes(e), r) * n for n, e in dims]
                whole[tuple(slice(a, a + n) for a, (n, _) in zip(at, dims))] \
                    = part
            x = snapshot(whole)
            del whole, parts
        elif not rank0:
            continue
        else:
            x = np.array(x)
        yield key, (x.astype(dtypes[key]) if dtypes and key in dtypes else x)


def _piece(arr: np.ndarray, spec, mesh) -> np.ndarray:
    """This rank's piece of a whole host array laid out by ``spec``."""
    from repro_torch.sharding.rules import axes_size, spec_axes
    for dim, e in enumerate(spec):
        n = axes_size(mesh, e)
        if n > 1:
            k = arr.shape[dim] // n
            i = mesh.index(spec_axes(e))
            arr = arr[(slice(None),) * dim + (slice(i * k, (i + 1) * k),)]
    return arr.copy()


def save(tree: Any, path, *, step: int = 0, metadata: Optional[Dict] = None,
         dtypes: Optional[Dict[str, Any]] = None, mesh=None,
         placements: Any = None) -> None:
    """Blocking save of ``tree`` to ``path``.  With ``mesh`` every rank
    calls it with its pieces (``placements``: their specs); rank 0
    gathers and writes one whole leaf at a time, the others wait for its
    commit."""
    if mesh is not None:
        import torch.distributed as dist
        leaves = _whole_leaves(tree, mesh, placements, dtypes)
        if dist.get_rank() == 0:
            _write_checkpoint(leaves, repr([k for k, _ in _flatten(tree)]),
                              Path(path), step=step, metadata=metadata or {})
        else:
            for _ in leaves:
                pass
        dist.barrier()
        return
    AsyncSaver().save(tree, path, step=step, metadata=metadata, blocking=True,
                      dtypes=dtypes)


# -- generations --------------------------------------------------------------

def is_committed(path) -> bool:
    """Committed = the atomic rename happened.  A ``*.tmp`` staging
    directory is never committed, even with its marker file written."""
    path = Path(path)
    return (not path.name.endswith(".tmp")
            and (path / COMMIT_MARKER).exists())


def generations(root) -> List[Path]:
    """Every committed checkpoint directory under ``root``, oldest first
    (names sort by generation: the serving loop's ``window_%08d``)."""
    root = Path(root)
    if not root.exists():
        return []
    return sorted((p for p in root.iterdir() if is_committed(p)),
                  key=lambda p: p.name)


def latest_committed(root) -> Optional[Path]:
    cands = generations(root)
    return cands[-1] if cands else None


def _load_manifest(path: Path) -> Dict:
    """Parse and check a manifest, raising ``CheckpointCorruptError``
    naming the failed file or field."""
    mf = path / "manifest.json"
    if not mf.exists():
        raise CheckpointCorruptError(f"{path.name}: manifest.json missing")
    try:
        manifest = json.loads(mf.read_text())
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(
            f"{path.name}: manifest.json unreadable (torn write?): {e}")
    for field in ("step", "treedef", "leaves"):
        if field not in manifest:
            raise CheckpointCorruptError(
                f"{path.name}: manifest.json missing field {field!r}")
    for key, ent in manifest["leaves"].items():
        for field in ("shape", "dtype", "offset", "nbytes", "file"):
            if field not in ent:
                raise CheckpointCorruptError(
                    f"{path.name}: leaf {key}: manifest missing field "
                    f"{field!r}")
    return manifest


def _read_leaf_raw(path: Path, files: Dict[str, Path], key: str,
                   ent: Dict) -> bytes:
    """One leaf's raw bytes, read, decompressed and checked, raising
    ``CheckpointCorruptError`` naming the leaf and the failed field."""
    fp = files.get(ent["file"])
    if fp is None:
        raise CheckpointCorruptError(
            f"{path.name}: leaf {key}: data file {ent['file']!r} missing")
    size = fp.stat().st_size
    if ent["offset"] + ent["nbytes"] > size:
        raise CheckpointCorruptError(
            f"{path.name}: leaf {key}: data file truncated "
            f"(need {ent['offset'] + ent['nbytes']} bytes, have {size})")
    with open(fp, "rb") as f:
        f.seek(ent["offset"])
        blob = f.read(ent["nbytes"])
    try:
        raw = _decompress(blob, ent.get("codec", "zstd"))
    except Exception as e:
        raise CheckpointCorruptError(
            f"{path.name}: leaf {key}: decompress failed "
            f"(corrupt data.bin?): {e}")
    if "raw_nbytes" in ent and len(raw) != ent["raw_nbytes"]:
        raise CheckpointCorruptError(
            f"{path.name}: leaf {key}: field raw_nbytes mismatch "
            f"({len(raw)} != {ent['raw_nbytes']})")
    if "crc32" in ent and zlib.crc32(raw) != ent["crc32"]:
        raise CheckpointCorruptError(
            f"{path.name}: leaf {key}: field crc32 checksum mismatch")
    return raw


def verify_checkpoint(path) -> List[str]:
    """Every check ``restore`` makes, without building arrays: commit
    marker, manifest, per-leaf bounds, decompression, checksums and the
    payload size against shape and dtype.  Returns the errors (empty =
    valid), each naming the leaf or field that failed."""
    path = Path(path)
    if not is_committed(path):
        return [f"{path.name}: not committed (no marker / staging dir)"]
    try:
        manifest = _load_manifest(path)
    except CheckpointCorruptError as e:
        return [str(e)]
    files = {p.name: p for p in path.glob("data.*.bin")}
    errors = []
    for key, ent in manifest["leaves"].items():
        try:
            raw = _read_leaf_raw(path, files, key, ent)
            expect = int(np.prod(ent["shape"])) * _itemsize(ent["dtype"])
            if len(raw) != expect:
                errors.append(f"{path.name}: leaf {key}: field shape/dtype "
                              f"inconsistent with payload ({len(raw)} bytes "
                              f"!= {expect})")
        except CheckpointCorruptError as e:
            errors.append(str(e))
    return errors


def latest_valid(root) -> Optional[Path]:
    """The newest committed generation that passes ``verify_checkpoint``."""
    for p in reversed(generations(root)):
        if not verify_checkpoint(p):
            return p
    return None


def gc_generations(root, keep: int) -> List[Path]:
    """Delete committed generations beyond the newest ``keep``, never the
    newest valid one (when every newer generation is corrupt it is the
    only restorable state).  Staging directories are never touched.
    Returns the deleted paths."""
    gens = generations(root)
    if keep < 1 or len(gens) <= keep:
        return []
    protect = latest_valid(root)
    removed = []
    for p in gens[:-keep]:
        if protect is not None and p == protect:
            continue
        shutil.rmtree(p)
        removed.append(p)
    return removed


# -- restore ------------------------------------------------------------------

def _restore_flat(path: Path, manifest: Dict, files: Dict[str, Path]
                  ) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, ent in manifest["leaves"].items():
        m = _FLAT_KEY.match(key)
        if m is None:
            raise ValueError(f"a flat restore needs a dict checkpoint, got "
                             f"leaf key {key!r}; pass a target")
        out[m.group(1)] = _from_raw(_read_leaf_raw(path, files, key, ent),
                                    ent).copy()
    return out


def _leaf_like(arr: np.ndarray, tgt: Any, device) -> Any:
    """A restored host leaf as the target leaf is: a tensor of its dtype
    on ``device`` (default: the target's), or a numpy array of its
    dtype."""
    if torch.is_tensor(tgt):
        dev = tgt.device if device is None else device
        if isinstance(arr, Bf16Bits):
            t = upload(arr.view(np.int16), dev).view(torch.bfloat16)
        elif tgt.dtype == torch.bfloat16:
            t = upload(arr, dev)
        else:
            want = _np_dtype(tgt.dtype)
            t = upload(arr.astype(want) if arr.dtype != want else arr, dev)
        return t.to(tgt.dtype)
    want = _np_dtype(tgt.dtype)
    if isinstance(arr, Bf16Bits):   # exact: bfloat16 is float32's top half
        arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return arr.astype(want) if arr.dtype != want else arr.copy()


def restore(path, target: Any = None, *, device=None, mesh=None,
            placements: Any = None) -> Tuple[Any, Dict]:
    """Restore ``path`` -> (tree, metadata with ``step``).

    With ``target`` (a tree of tensors or numpy arrays of the expected
    shapes), each leaf is read by its key string, checked, cast to the
    target leaf's dtype when it differs, and returned like the target
    leaf: a tensor on ``device`` (default: the target tensor's device), or
    a numpy array.  With ``mesh`` the target holds this rank's pieces
    (``placements``: their specs) and each rank gets its piece of the
    whole array in the file.  Without ``target``: a flat ``{name: array}``
    of numpy arrays.  A failed check raises ``CheckpointCorruptError``
    naming the leaf and the field."""
    path = Path(path)
    if not is_committed(path):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    manifest = _load_manifest(path)
    files = {p.name: p for p in path.glob("data.*.bin")}
    meta = manifest.get("metadata", {}) | {"step": manifest["step"]}
    if target is None:
        return _restore_flat(path, manifest, files), meta
    out = []
    specs = (_spec_leaves(target, placements) if mesh is not None
             else [None] * len(_flatten(target)))
    for (key, tgt), spec in zip(_flatten(target), specs):
        if key not in manifest["leaves"]:
            raise KeyError(f"leaf {key} missing from checkpoint")
        ent = manifest["leaves"][key]
        arr = _from_raw(_read_leaf_raw(path, files, key, ent), ent)
        if spec is not None:
            arr = _piece(arr, spec, mesh)
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs target {tuple(tgt.shape)}")
        out.append(_leaf_like(arr, tgt, device))
    return _rebuild(target, iter(out)), meta
