"""Checkpoints: a tree of tensors -> npz + structure manifest
(counterpart of ``repro/checkpoint/ckpt.py``, the same file format).

A checkpoint is ``<dir>/ckpt_{step:08d}.npz`` plus ``<dir>/manifest.json``
(``latest_step``, ``keys``, ``dtypes``).  Each leaf is keyed by its tree
path as ``jax.tree_util.tree_flatten_with_path`` spells it: a TrainState
field as ``.params``, ``.opt_state``, ``.step``, ``.extras``, dict keys
and list indices after it, ``/``-joined (``.params/blocks/0/w``,
``.opt_state/m/...``, ``.opt_state/count``, ``.extras/ef_state/...``,
``.step``: a 0-d int32, where the port's ``TrainState.step`` is a Python
int).  Either package restores the other's files.

The file is written leaf by leaf in the zip layout ``np.savez`` writes
(an uncompressed zip of ``<key>.npy`` members, ``np.lib.format``
headers), so host memory holds one leaf at a time, however large the
state; each leaf is copied to the host before the call returns, so the
next step may overwrite the device tensors it came from.

* **dtype manifest** — npz cannot hold bfloat16 or fp8: such leaves are
  saved as same-width unsigned-int **bit views** (uint16/uint8, taken in
  torch) and their dtype recorded under the reference's (ml_dtypes)
  names, ``bfloat16``, ``float8_e4m3fn``, ``float8_e5m2``, in the npz's
  own ``__dtype_manifest__`` entry (authoritative, per step) and in
  ``manifest.json``'s ``dtypes`` (the latest save).  Restore views the
  bits back; a bit view whose entry is missing is reinterpreted through
  the template's dtype, never value-cast.
* **extras reconcile** — ``TrainState.extras`` slots are
  config-dependent.  A checkpointed slot the template lacks grows into
  the template (a params-mirroring subtree as params-shaped fp32, other
  shapes from the npz itself); a template slot the checkpoint predates is
  backfilled by the slot's registered kind — **ones** for
  ``push_weight``, zeros otherwise (``core.algo.backfill_kind``).

Checkpoints written before the extras dict (top-level ``.ef_state/...``,
``.push_weight``, ``.slow_params/...``) restore through a per-key alias.
Restore places each leaf on its template leaf's device and dtype.  A
checkpoint or restore error raises.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import zipfile
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_unflatten

PyTree = Any
_MANIFEST = "manifest.json"
_EXTRAS_PREFIX = ".extras/"                # TrainState extras slots
_DTYPES_KEY = "__dtype_manifest__"         # reserved npz entry, not a leaf
# TrainState fields that are NOT extras slots: a leading ".<name>" on any
# other key is a legacy (pre-extras) slot spelling
_CORE_FIELDS = ("params", "opt_state", "step", "extras")

# dtypes npz cannot hold: their reference (ml_dtypes) names and the
# same-width integer their bits are saved as
_BIT_VIEWS: Dict[torch.dtype, Tuple[str, torch.dtype, np.dtype]] = {
    torch.bfloat16: ("bfloat16", torch.int16, np.dtype(np.uint16)),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.dtype(np.uint8)),
    torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.dtype(np.uint8)),
}
_BY_NAME = {name: (dt, tview) for dt, (name, tview, _) in _BIT_VIEWS.items()}


class _Spec:
    """A template leaf known by shape, dtype and device only (a slot grown
    from the checkpoint; the restored tensor replaces it)."""

    __slots__ = ("shape", "dtype", "device")

    def __init__(self, shape, dtype, device):
        self.shape, self.dtype, self.device = tuple(shape), dtype, device


# ---------------------------------------------------------------------------
# Tree paths, as jax.tree_util.tree_flatten_with_path names them
# ---------------------------------------------------------------------------
def _walk(tree, prefix: str, out: List[Tuple[str, Any]]) -> None:
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _walk(getattr(tree, f.name), _join(prefix, "." + f.name), out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], _join(prefix, str(k)), out)
    elif isinstance(tree, (list, tuple)):
        for i, c in enumerate(tree):
            _walk(c, _join(prefix, str(i)), out)
    elif tree is not None:
        out.append((prefix, tree))


def _join(prefix: str, part: str) -> str:
    return part if not prefix else f"{prefix}/{part}"


def _flatten(tree: PyTree) -> Dict[str, Any]:
    """``{path key: leaf}`` in the reference's key spelling."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, "", out)
    return dict(out)


def _rebuild(template: PyTree, leaves: Dict[str, Any], prefix: str = ""):
    """``template``'s structure with each leaf replaced by ``leaves[key]``
    (the inverse of :func:`_flatten`)."""
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), leaves,
                             _join(prefix, "." + f.name))
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves, _join(prefix, str(k)))
                for k in template}
    if isinstance(template, (list, tuple)):
        out = [_rebuild(c, leaves, _join(prefix, str(i)))
               for i, c in enumerate(template)]
        return tuple(out) if isinstance(template, tuple) else out
    if template is None:
        return None
    return leaves[prefix]


def _slot_of_key(key: str, known) -> Optional[str]:
    """Extras slot name a flat key addresses, else None.  Accepts the
    ``.extras/<slot>...`` spelling and the legacy top-level ``.<slot>...``
    one."""
    if key.startswith(_EXTRAS_PREFIX):
        return key[len(_EXTRAS_PREFIX):].split("/", 1)[0]
    if key.startswith("."):
        name = key[1:].split("/", 1)[0]
        if name not in _CORE_FIELDS and name in known:
            return name
    return None


def _legacy_alias(key: str) -> Optional[str]:
    """Pre-extras spelling of an ``.extras/...`` key."""
    if key.startswith(_EXTRAS_PREFIX):
        return "." + key[len(_EXTRAS_PREFIX):]
    return None


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------
def _host_leaves(flat: Dict[str, Any]
                 ) -> Iterator[Tuple[str, np.ndarray, Optional[str]]]:
    """``(key, host array, bit-view dtype name or None)`` leaf by leaf:
    tensors copied to the host one at a time, bf16/fp8 as their bits."""
    for key, leaf in flat.items():
        if torch.is_tensor(leaf):
            t = leaf.detach()
            view = _BIT_VIEWS.get(t.dtype)
            if view is not None:
                name, tview, npview = view
                yield key, t.view(tview).cpu().numpy().view(npview), name
            else:
                yield key, t.cpu().numpy(), None
        elif isinstance(leaf, int):        # the host step counter
            yield key, np.asarray(leaf, np.int32), None
        else:
            yield key, np.asarray(leaf), None


def _write_member(zf: zipfile.ZipFile, key: str, arr: np.ndarray) -> None:
    with zf.open(key + ".npy", "w", force_zip64=True) as f:
        np.lib.format.write_array(f, np.asanyarray(arr), allow_pickle=False)


def save_checkpoint(ckpt_dir: str, state: PyTree, step: int) -> str:
    """Write ``state`` as ``<ckpt_dir>/ckpt_{step:08d}.npz`` (and the
    manifest); returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(state)
    dtypes: Dict[str, str] = {}
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    tmp = path + ".part"
    with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr, name in _host_leaves(flat):
            if name is not None:
                dtypes[key] = name
            _write_member(zf, key, arr)
            del arr
        # the dtype manifest rides inside the npz (authoritative, per
        # step): manifest.json only describes the latest save
        _write_member(zf, _DTYPES_KEY, np.asarray(json.dumps(dtypes)))
    os.replace(tmp, path)
    with open(os.path.join(ckpt_dir, _MANIFEST), "w") as f:
        json.dump({"latest_step": step, "keys": sorted(flat),
                   "dtypes": dtypes}, f, indent=1)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def _load_manifest(ckpt_dir: str) -> Dict[str, Any]:
    path = os.path.join(ckpt_dir, _MANIFEST)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------
def _params_device(params: PyTree) -> torch.device:
    for lf in tree_flatten(params)[0]:
        if torch.is_tensor(lf) or isinstance(lf, _Spec):
            return lf.device
    return torch.device("cpu")


def _reconcile_extras(template: PyTree, data) -> PyTree:
    """Grow extras slots the checkpoint carries but the template lacks
    (see the module docstring).  Non-TrainState templates pass through."""
    from repro_torch.core.algo import known_slot_names
    from repro_torch.train.state import TrainState
    if not isinstance(template, TrainState):
        return template
    known = set(known_slot_names())
    present: Dict[str, list] = {}
    for k in data.files:
        if k == _DTYPES_KEY:
            continue
        name = _slot_of_key(k, known)
        if name is not None:
            present.setdefault(name, []).append(k)
    grow = {n: ks for n, ks in present.items() if n not in template.extras}
    if not grow:
        return template
    dev = _params_device(template.params)
    params_suffixes = set(_flatten(template.params))
    extras = dict(template.extras)
    for name, keys in sorted(grow.items()):
        bare_new, bare_old = _EXTRAS_PREFIX + name, "." + name
        if keys == [bare_new] or keys == [bare_old]:
            # bare single-array slot: the shape comes from the npz
            extras[name] = _Spec(data[keys[0]].shape, torch.float32, dev)
            continue
        suffixes = {}
        for k in keys:
            base = bare_new if k.startswith(_EXTRAS_PREFIX) else bare_old
            suffixes[k[len(base) + 1:]] = k
        if set(suffixes) == params_suffixes:
            # params-mirroring slot (EF memory, GT tracker): params-shaped
            # fp32
            leaves, treedef = tree_flatten(template.params)
            extras[name] = tree_unflatten(treedef, [
                _Spec(p.shape, torch.float32, p.device) for p in leaves])
        else:
            # arbitrary subtree: a nested dict from the npz paths
            nested: Dict[str, Any] = {}
            for suffix, k in sorted(suffixes.items()):
                parts = suffix.split("/")
                d = nested
                for p in parts[:-1]:
                    d = d.setdefault(p, {})
                d[parts[-1]] = _Spec(data[k].shape, torch.float32, dev)
            extras[name] = nested
    return dataclasses.replace(template, extras=extras)


def _as_tensor(arr: np.ndarray, bit_dtype: Optional[torch.dtype],
               tmpl) -> torch.Tensor:
    """A host array as a tensor on ``tmpl``'s device and dtype, its bits
    reinterpreted first when they are a bit view (``bit_dtype``)."""
    # np.require keeps a 0-d array 0-d (np.ascontiguousarray would not)
    src = np.require(arr, requirements="C")
    if bit_dtype is not None:
        view = _BIT_VIEWS[bit_dtype][1]
        t = torch.from_numpy(src.view(_np_of(view))).view(bit_dtype)
    else:
        t = torch.from_numpy(src)
    return t.to(device=tmpl.device, dtype=tmpl.dtype)


def _np_of(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def restore_checkpoint(ckpt_dir: str, template: PyTree,
                       step: Optional[int] = None) -> PyTree:
    """The checkpoint at ``step`` (default: the latest) in ``template``'s
    structure, each leaf on its template leaf's device and dtype."""
    from repro_torch.core.algo import backfill_kind, known_slot_names
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    with np.load(os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")) as data:
        if _DTYPES_KEY in data.files:            # per-step, authoritative
            dtypes = json.loads(str(data[_DTYPES_KEY]))
        else:                                    # older save: the latest's
            dtypes = _load_manifest(ckpt_dir).get("dtypes", {})
        template = _reconcile_extras(template, data)
        flat = _flatten(template)
        known = set(known_slot_names())
        leaves: Dict[str, Any] = {}
        for key, tmpl in flat.items():
            src = key
            if key not in data.files:
                slot = _slot_of_key(key, known)
                legacy = _legacy_alias(key)
                if legacy is not None and legacy in data.files:
                    src = legacy     # pre-extras checkpoint: old spelling
                elif slot is not None:
                    # a slot the checkpoint predates: ones for push
                    # weights (zeros would blow up x/w), zeros otherwise
                    fill = (torch.ones if backfill_kind(slot) == "ones"
                            else torch.zeros)
                    leaves[key] = fill(tmpl.shape, dtype=tmpl.dtype,
                                       device=tmpl.device)
                    continue
                else:
                    raise KeyError(f"restore_checkpoint: {key!r} is not in "
                                   f"{ckpt_dir} step {step}")
            arr = data[src]
            if not (torch.is_tensor(tmpl) or isinstance(tmpl, _Spec)):
                leaves[key] = type(tmpl)(arr.item())   # the host step
                continue
            bit = None
            if src in dtypes:
                if dtypes[src] not in _BY_NAME:
                    raise ValueError(f"restore_checkpoint: {src!r} has the "
                                     f"unknown dtype {dtypes[src]!r}")
                bit = _BY_NAME[dtypes[src]][0]
            elif arr.dtype.kind == "V":
                # written before the dtype manifest: raw void bits,
                # reinterpreted through the template
                bit = tmpl.dtype if tmpl.dtype in _BIT_VIEWS else None
                arr = arr.view(_np_of(_BIT_VIEWS[bit][1]) if bit is not None
                               else _np_of(tmpl.dtype))
            elif (arr.dtype.kind == "u" and tmpl.dtype in _BIT_VIEWS and
                  arr.dtype.itemsize == torch.empty(
                      (), dtype=tmpl.dtype).element_size()):
                # a bit view whose manifest entry is missing: reinterpret
                # the bits through the template, never value-cast
                bit = tmpl.dtype
            leaves[key] = _as_tensor(arr, bit, tmpl)
            del arr
    return _rebuild(template, leaves)
