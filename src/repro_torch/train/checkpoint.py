"""Checkpointing: atomic msgpack snapshots of a state tree with an optional
wire codec (port of ``repro.train.checkpoint``). The ternary codec stores
2-bit weights plus one scale per leaf, the T-FedAvg wire format on disk.

Layout: ``<dir>/step_<N:012d>/state.msgpack`` and ``meta.json``, written to
``step_<N>.tmp`` and renamed, so a crash mid-write never corrupts the latest
checkpoint.

The file is the reference's, record for record. Its leaves are those of
JAX's ``tree_flatten(state, is_leaf=...)``: dataclass fields in declaration
order, dict keys sorted, list items in order, and ``None`` a leaf of its
own (the ``__none__`` record). Each leaf record (``__nd__``, ``__tern__``,
``__down__``, ``__topk__``, ``__none__``) has the reference's fields in its
order, so for the same state the records are the reference's bytes and a
checkpoint restores across the two packages in both directions. Only the
``"treedef"`` string is the port's own description; neither package reads
it back.

Raw records keep numpy's ``dtype.str`` (``'<f4'``, ``'<i4'``), the other
records the dtype's name. A bfloat16 raw leaf is written as ``'<V2'``, as
the reference writes it; the port reads ``'<V2'`` back as bfloat16, which
the reference cannot.

On a sharded mesh (a "model" or "data" axis of size > 1, with the params'
specs) the file is still the one-device file: ``save_checkpoint`` gathers
the shards over both axes into whole leaves first (every rank calls it;
the mesh's first rank writes), and ``restore_checkpoint`` cuts the whole
leaves to the rank's shards.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.core.compression import (
    CodecSpec, DowncastTensor, TopKTensor, compress_pytree, decompress_pytree,
)
from repro_torch.core.ternary import TernaryTensor
from repro_torch.device import resolve_device
from repro_torch.dtypes import dtype_name, from_numpy, storage_numpy_dtype, to_numpy
from repro_torch.train._msgpack import packb, unpackb

Pytree = Any

_SENTINEL_ARRAY = "__nd__"
_SENTINEL_TERNARY = "__tern__"
_SENTINEL_DOWNCAST = "__down__"
_SENTINEL_TOPK = "__topk__"
_SENTINEL_NONE = "__none__"
_WIRE_LEAVES = (TernaryTensor, DowncastTensor, TopKTensor)


# --------------------------------------------------------------------------
# The tree walk: JAX's flatten order, None kept as a leaf.
# --------------------------------------------------------------------------


def _children(node) -> list | None:
    """(name, child) pairs of a container, None for a leaf. Names follow the
    reference's ``fttq._path_str``: a dict key or list index as itself, a
    dataclass field as ``.field``."""
    if node is None or isinstance(node, _WIRE_LEAVES):
        return None
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name)) for f in dataclasses.fields(node)]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten_into(out: list, node, name: str) -> None:
    kids = _children(node)
    if kids is None:
        out.append((name, node))
        return
    for key, child in kids:
        _flatten_into(out, child, f"{name}/{key}" if name else key)


def flatten(tree: Pytree) -> list[tuple[str, Any]]:
    """(path name, leaf) pairs in JAX's flatten order, ``None`` included."""
    out: list = []
    _flatten_into(out, tree, "")
    return out


def _build(node, it):
    kids = _children(node)
    if kids is None:
        return next(it)
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(
            node, **{f.name: _build(getattr(node, f.name), it) for f in dataclasses.fields(node)})
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    items = [_build(v, it) for v in node]
    return type(node)(items) if isinstance(node, tuple) else items


def unflatten(example: Pytree, leaves: list) -> Pytree:
    """``example``'s structure with ``leaves`` in flatten order."""
    n = len(flatten(example))
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a structure of {n}")
    return _build(example, iter(leaves))


def _describe(node) -> str:
    kids = _children(node)
    if kids is None:
        return "None" if node is None else "*"
    if dataclasses.is_dataclass(node):
        inner = ", ".join(f"{k[1:]}={_describe(v)}" for k, v in kids)
        return f"{type(node).__name__}({inner})"
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(v)}" for k, v in kids) + "}"
    inner = ", ".join(_describe(v) for _, v in kids)
    return f"({inner},)" if isinstance(node, tuple) else f"[{inner}]"


# --------------------------------------------------------------------------
# Leaf records.
# --------------------------------------------------------------------------


def _name_of(leaf) -> str:
    return dtype_name(leaf.dtype) if isinstance(leaf, torch.Tensor) else np.asarray(leaf).dtype.name


def _arr_obj(leaf) -> dict:
    arr = to_numpy(leaf)          # bfloat16 as its uint16 bits; tobytes is C order
    return {"data": arr.tobytes(), "dtype": _name_of(leaf),
            "shape": [int(d) for d in arr.shape]}


def _tensor(arr: np.ndarray, name: str, dev) -> torch.Tensor:
    return from_numpy(arr.copy(), name).to(dev)


def _arr_from(obj, dev) -> torch.Tensor:
    arr = np.frombuffer(obj["data"], storage_numpy_dtype(obj["dtype"]))
    return _tensor(arr.reshape(obj["shape"]), obj["dtype"], dev)


def _pack_leaf(leaf) -> dict:
    if leaf is None:
        return {_SENTINEL_NONE: True}
    if isinstance(leaf, DowncastTensor):
        return {_SENTINEL_DOWNCAST: True, "payload": _arr_obj(leaf.data),
                "orig_dtype": leaf.orig_dtype}
    if isinstance(leaf, TopKTensor):
        # the reference's indices are lax.top_k's int32
        indices = to_numpy(leaf.indices).astype(np.int32)
        return {_SENTINEL_TOPK: True, "indices": _arr_obj(indices),
                "values": _arr_obj(leaf.values), "shape": [int(d) for d in leaf.shape],
                "dtype": leaf.dtype}
    if isinstance(leaf, TernaryTensor):
        packed = to_numpy(leaf.packed).reshape(-1)
        # the scale's value as fp32, as the reference writes it (a bf16
        # scale's host bytes are its uint16 bits, not its value)
        w_q = to_numpy(leaf.w_q.to(torch.float32) if isinstance(leaf.w_q, torch.Tensor)
                       else leaf.w_q).astype(np.float32)
        return {
            _SENTINEL_TERNARY: True,
            "packed": packed.tobytes(),
            "packed_len": int(packed.size),
            "w_q": w_q.tobytes(),
            "w_q_shape": [int(d) for d in w_q.shape],
            "shape": [int(d) for d in leaf.shape],
            "dtype": leaf.dtype,
        }
    arr = to_numpy(leaf)
    bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
    return {
        _SENTINEL_ARRAY: True,
        "data": arr.tobytes(),
        "dtype": "<V2" if bf16 else arr.dtype.str,
        "shape": [int(d) for d in arr.shape],
    }


def _unpack_leaf(obj: dict, dev):
    if _SENTINEL_NONE in obj:
        return None
    if _SENTINEL_DOWNCAST in obj:
        return DowncastTensor(data=_arr_from(obj["payload"], dev), orig_dtype=obj["orig_dtype"])
    if _SENTINEL_TOPK in obj:
        return TopKTensor(indices=_arr_from(obj["indices"], dev),
                          values=_arr_from(obj["values"], dev),
                          shape=tuple(obj["shape"]), dtype=obj["dtype"])
    if _SENTINEL_TERNARY in obj:
        packed = np.frombuffer(obj["packed"], np.uint8)[:obj["packed_len"]]
        w_q = np.frombuffer(obj["w_q"], np.float32).reshape(obj["w_q_shape"])
        return TernaryTensor(packed=_tensor(packed, "uint8", dev),
                             w_q=_tensor(w_q, "float32", dev),
                             shape=tuple(obj["shape"]), dtype=obj["dtype"])
    if obj["dtype"] == "<V2":
        arr = np.frombuffer(obj["data"], np.uint16).reshape(obj["shape"])
        return _tensor(arr, "bfloat16", dev)
    arr = np.frombuffer(obj["data"], np.dtype(obj["dtype"])).reshape(obj["shape"])
    return _tensor(arr, arr.dtype.name, dev)


# --------------------------------------------------------------------------
# Save, list, restore.
# --------------------------------------------------------------------------


def _compress(pairs: list, compression: CodecSpec) -> list:
    """The leaves through ``compress_pytree``, keyed by their path names so
    the codec's quantizable-leaf policy sees the reference's names."""
    named = {name: leaf for name, leaf in pairs if leaf is not None}
    wire, _ = compress_pytree(named, compression)
    return [None if leaf is None else wire[name] for name, leaf in pairs]


def save_checkpoint(directory: str, step: int, state: Pytree, *,
                    compression: CodecSpec | None = None, keep: int = 3,
                    metadata: dict | None = None, mesh=None, specs: Pytree | None = None) -> str:
    """Atomically persist ``state`` at ``<directory>/step_<step>``.

    compression: a codec for the quantizable leaves on disk (ternary: one
    ``quantize_pack`` launch for the whole tree on the card).
    keep: retain only the newest ``keep`` checkpoints (0 = keep all).
    mesh, specs: every rank of ``mesh`` calls this and the mesh's first
    rank writes; a state of shards over "model" and "data" (a params tree
    or a ``TrainState``; ``specs`` the params' ``param_specs``) is gathered
    into whole leaves first."""
    if mesh is not None:
        from repro_torch.parallel.tensor import gather_state

        state = gather_state(state, specs, mesh)
        if mesh.rank != mesh.ranks[0]:
            return os.path.join(directory, f"step_{step:012d}")
    os.makedirs(directory, exist_ok=True)
    compressed = compression is not None and not compression.is_identity
    pairs = flatten(state)
    leaves = _compress(pairs, compression) if compressed else [leaf for _, leaf in pairs]
    payload = {"leaves": [_pack_leaf(leaf) for leaf in leaves], "treedef": _describe(state)}
    final = os.path.join(directory, f"step_{step:012d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "state.msgpack"), "wb") as f:
        f.write(packb(payload))
    meta = dict(metadata or {})
    meta.update({"step": step, "compressed": compressed})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish

    if keep:
        for s in latest_steps(directory)[:-keep]:
            shutil.rmtree(os.path.join(directory, f"step_{s:012d}"), ignore_errors=True)
    return final


def latest_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = latest_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int | None = None, *,
                       example_state: Pytree | None = None,
                       compression: CodecSpec | None = None, sharding: Any | None = None,
                       device: str | torch.device = "cuda", mesh=None,
                       specs: Pytree | None = None) -> tuple[Pytree, dict]:
    """Load a checkpoint (the newest if ``step`` is None) into
    ``example_state``'s structure, every leaf on ``device``; a compressed
    checkpoint is decoded to dense tensors. Returns (state, metadata).
    ``sharding`` (a ``NamedSharding`` or a tree of them) then re-places
    every leaf over its mesh, as ``train.fault.elastic_reshard`` does;
    ``mesh`` and ``specs`` (as for ``save_checkpoint``) instead cut the
    whole leaves to this rank's shards over "model" and "data"."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    if example_state is None:
        raise ValueError("restore_checkpoint requires example_state for treedef")
    path = os.path.join(directory, f"step_{step:012d}")
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        payload = unpackb(f.read())
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    leaves = [_unpack_leaf(obj, dev) for obj in payload["leaves"]]
    if (compression is not None and not compression.is_identity) or meta.get("compressed"):
        leaves = decompress_pytree(leaves, dev)
    state = unflatten(example_state, leaves)
    if mesh is not None:
        from repro_torch.parallel.tensor import shard_state

        state = shard_state(state, specs, mesh)
    if sharding is not None:
        from repro_torch.train.fault import elastic_reshard

        state = elastic_reshard(state, sharding)
    return state, meta
