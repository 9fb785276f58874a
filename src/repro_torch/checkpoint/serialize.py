"""Checkpoint serialization: tree of tensors -> per-leaf binary blobs + JSON
manifest (the twin of ``src/repro/checkpoint/serialize.py``).

A tree is nested ``dict``, ``list``, ``tuple`` and ``NamedTuple``
containers of tensors (or numpy arrays).  Leaves are keyed by their tree
path in exactly the strings ``jax.tree_util.keystr`` gives for the same
structure (``.field`` for a NamedTuple, ``['key']`` for a dict with keys
in sorted order, ``[i]`` for a sequence), so a manifest written by either
package restores in the other.  Restore fills a template tree; a tree of
``torch.empty(..., device="meta")`` tensors is the twin of ``eval_shape``.

Host leaves are numpy arrays.  numpy has no bfloat16, so a bfloat16 leaf
crosses as its raw bits: an int16 array whose dtype carries the name
``"bfloat16"`` in its metadata (`BFLOAT16_BITS`), recorded under that
name in the manifest, as the reference records it.
"""
from __future__ import annotations

import json
import math
import warnings
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

try:
    import zstandard as zstd
except ImportError:  # pragma: no cover
    zstd = None

MANIFEST = "manifest.json"

#: numpy's stand-in for bfloat16: the raw bits as int16, named in metadata
BFLOAT16_BITS = np.dtype(np.int16, metadata={"name": "bfloat16"})


def dtype_name(dt: np.dtype) -> str:
    """The manifest name of a host dtype ("bfloat16" for the raw bits)."""
    return (dt.metadata or {}).get("name") or str(dt)


def np_dtype(name: str) -> np.dtype:
    """The host dtype a manifest name decodes to."""
    return BFLOAT16_BITS if name == "bfloat16" else np.dtype(name)


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key string, child) pairs of a container, None for a leaf."""
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    if node is None:
        return []
    return None


# The walkers are module-level functions, not closures: a nested function
# that calls itself is a reference cycle, and one that also holds the
# leaves would keep every tensor of the tree allocated until Python's
# cyclic collector runs (gigabytes of a model's state on the card).


def _collect_leaves(node, prefix: str, out: list) -> None:
    kids = _children(node)
    if kids is None:
        out.append((prefix, node))
        return
    for key, child in kids:
        _collect_leaves(child, prefix + key, out)


def leaf_paths(tree) -> List[Tuple[str, Any]]:
    """[(path_key, leaf), ...] in ``jax.tree_util`` flattening order."""
    out: List[Tuple[str, Any]] = []
    _collect_leaves(tree, "", out)
    return out


def _map_leaves(fn, node, prefix: str):
    if _is_namedtuple(node):
        return type(node)(*(_map_leaves(fn, getattr(node, f), f"{prefix}.{f}")
                            for f in node._fields))
    if isinstance(node, dict):
        return {k: _map_leaves(fn, node[k], f"{prefix}[{k!r}]") for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_map_leaves(fn, c, f"{prefix}[{i}]")
                          for i, c in enumerate(node))
    if node is None:
        return None
    return fn(prefix, node)


def map_with_path(fn: Callable[[str, Any], Any], tree):
    """The tree with each leaf replaced by ``fn(path_key, leaf)``; dicts,
    lists, tuples and NamedTuples keep their types."""
    return _map_leaves(fn, tree, "")


def to_numpy(leaf) -> np.ndarray:
    """A leaf on the host: a tensor is always copied, from the card or
    from host memory alike, so that the array is a snapshot that a later
    in-place update of the tensor (a train step) cannot change; bfloat16
    becomes `BFLOAT16_BITS`."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).to("cpu", copy=True).numpy().view(
                BFLOAT16_BITS)
        return t.to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``arr``'s buffer (no copy; callers copy).  The
    bfloat16 bits, ours or ``ml_dtypes``', become a bfloat16 tensor."""
    bf16 = dtype_name(arr.dtype) == "bfloat16"
    if bf16:
        arr = arr.view(np.int16)
    with warnings.catch_warnings():
        # blobs read from disk are read-only buffers; every caller copies
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if bf16 else t


def save_tree(
    tree,
    out_dir: Path,
    *,
    compress: Optional[int] = None,      # zstd level, None = raw
) -> Dict:
    """Serialize a tree; returns the manifest dict."""
    return save_leaf_dict(dict(leaf_paths(tree)), out_dir, compress=compress)


def save_leaf_dict(
    leaves_by_key: Dict[str, Any],
    out_dir: Path,
    *,
    compress: Optional[int] = None,
) -> Dict:
    """Serialize an already-flattened {path_key: array} dict (tier promotion
    path — keys must stay exactly as the original tree produced them)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    manifest: Dict[str, Any] = {"leaves": {}, "compress": compress}
    for i, (key, leaf) in enumerate(sorted(leaves_by_key.items())):
        arr = to_numpy(leaf)
        raw = arr.tobytes()
        blob = raw
        if compress and zstd is not None:
            blob = zstd.ZstdCompressor(level=compress).compress(raw)
        fname = f"leaf_{i:05d}.bin"
        (out_dir / fname).write_bytes(blob)
        manifest["leaves"][key] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": dtype_name(arr.dtype),
            "nbytes_raw": len(raw),
            "nbytes_stored": len(blob),
            "crc32": zlib.crc32(raw),
            # chunk metadata (multi-host layout; single chunk here)
            "chunks": [{"offset": [0] * arr.ndim, "shape": list(arr.shape)}],
        }
    (out_dir / MANIFEST).write_text(json.dumps(manifest, indent=1))
    return manifest


def load_manifest(in_dir: Path) -> Dict:
    return json.loads((Path(in_dir) / MANIFEST).read_text())


def load_leaves(in_dir: Path, *, verify: bool = True) -> Dict[str, np.ndarray]:
    """path_key -> numpy array (host memory)."""
    in_dir = Path(in_dir)
    manifest = load_manifest(in_dir)
    out = {}
    for key, meta in manifest["leaves"].items():
        blob = (in_dir / meta["file"]).read_bytes()
        if manifest.get("compress") and zstd is not None:
            blob = zstd.ZstdDecompressor().decompress(blob, max_output_size=meta["nbytes_raw"])
        if verify and zlib.crc32(blob) != meta["crc32"]:
            raise IOError(f"checkpoint corruption in {key} ({meta['file']})")
        out[key] = np.frombuffer(blob, dtype=np_dtype(meta["dtype"])).reshape(meta["shape"])
    return out


def _host_put(key: str, arr: np.ndarray, tleaf) -> torch.Tensor:
    dtype = getattr(tleaf, "dtype", None)
    return host_tensor(arr).to(dtype=dtype, copy=True)


def fill_template(template, leaves: Dict[str, np.ndarray], *,
                  put: Optional[Callable] = None):
    """Rebuild a tree from ``leaves`` using ``template``'s structure.

    ``put`` maps (path_key, np_array, template_leaf) -> leaf (default: a
    CPU tensor with the template's dtype) — reshard.py passes one that
    places each leaf on the target device here.
    """
    put = put or _host_put

    def fill(key, tleaf):
        if key not in leaves:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = leaves[key]
        expect = tuple(getattr(tleaf, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {expect}")
        return put(key, arr, tleaf)

    return map_with_path(fill, template)


def tree_bytes(tree) -> int:
    return sum(
        math.prod(leaf.shape) * (leaf.element_size()
                                 if isinstance(leaf, torch.Tensor)
                                 else np.dtype(leaf.dtype).itemsize)
        for _, leaf in leaf_paths(tree)
    )
