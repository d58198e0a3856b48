"""Checkpointing with atomic commit and integrity checksums (the port of the
JAX package's ``checkpoint/manager.py``, same on-disk layout).

Layout (one directory per step)::

    <dir>/step_000000123.tmp/       # written first
        manifest.json               # step, extra, per-leaf meta + CRC32
        arr_<leaf id>.shard0.npy    # one file per leaf
    <dir>/step_000000123/           # os.replace on commit

* **atomic commit** — readers only ever see committed directories, so a
  crash mid-write never corrupts the newest checkpoint;
* **per-leaf CRC32** in the manifest, recomputed on every restore
  (``verify=False`` opts out): a truncated file or a flipped bit raises
  :class:`CheckpointCorruptionError` instead of restoring garbage;
* ``latest_verified_step`` / ``restore_latest_verified`` walk committed
  steps newest first and skip corrupt ones;
* keep-last-N garbage collection that **never deletes the newest verified
  step**, and removes stale ``.tmp`` directories;
* a manifest leaf with several shards is concatenated along axis 0, as the
  reference's multi-host writers leave them.

A tree is nested dicts, tuples, lists and NamedTuples; its leaves are
tensors, Python ints, floats and bools (the optimizers' step counters), and
``None`` is no leaf.  A leaf's path joins its dict keys, NamedTuple field
names and sequence indices with ``/``, as the reference's ``tree_paths``
does, so a parameter tree written by either package restores in the other.
Leaves are visited in the tree's own order (dict insertion order: the
port's ``{path: tensor}`` trees are already in the reference's leaf order).
``restore`` puts each leaf on the device and dtype of the template's leaf,
and gives an int leaf back as a Python ``int``.  A bfloat16 leaf is written
in the reference's layout (its 2-byte words under an ``'<V2'`` header,
manifest dtype ``"bfloat16"``) and restored bit for bit, from either
package's checkpoint; the reference's own restore cannot read it back
(numpy has no cast from its void type).

``save(..., observer=...)`` calls ``observer(leaf_index, total)`` after each
leaf is written (fault-injection kill hooks, progress).  With a telemetry
bus (``telemetry=``, a :class:`repro_torch.telemetry.Telemetry`) each save,
GC and corrupt-skip is a ``checkpoint`` event, as in the reference; without
one only problems print.

A checkpoint holds whole arrays, as the reference's do: a sharded run
gathers its split leaves before it saves, and ``restore(shardings=)`` puts
them back on a rank — each rank loads the whole leaf, then keeps its part
(the per-leaf rule of :func:`repro_torch.sharding.row_splits`: one dim, or
two dims, one over each mesh axis, under tensor parallelism).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

PyTree = Any
_STEP_RE = re.compile(r"^step_(\d{9})$")
_SCALARS = (bool, int, float)


class CheckpointCorruptionError(ValueError):
    """A committed checkpoint failed integrity verification (truncated
    shard, checksum mismatch, unreadable manifest)."""


def _children(tree) -> Optional[list[tuple[str, Any]]]:
    """(path part, child) pairs of a container node; None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten_with_paths(tree: PyTree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` in tree order; ``None`` is no leaf."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        if not isinstance(tree, (torch.Tensor, *_SCALARS)):
            raise TypeError(f"{prefix or '<root>'}: cannot checkpoint a "
                            f"{type(tree).__name__} leaf")
        return [(prefix, tree)]
    out = []
    for part, child in kids:
        out += flatten_with_paths(child, f"{prefix}/{part}" if prefix else part)
    return out


def _rebuild(like: PyTree, leaves) -> PyTree:
    """``like``'s structure with its leaves taken in order from the iterator
    ``leaves``."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return next(leaves)
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    vals = [_rebuild(v, leaves) for _, v in kids]
    if hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


# numpy has no bfloat16: a bf16 leaf's words travel as int16, are written
# under the header the reference's (ml_dtypes) arrays get, and load back as
# a 2-byte void type.
_BF16 = "bfloat16"
_BF16_DESCR = "<V2"


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf's values on the host and its manifest dtype: a bfloat16
    tensor's words as int16 with ``"bfloat16"``, a Python scalar as a 0-d
    array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_npy(path: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``, with the reference's ``'<V2'`` header for bf16 words."""
    if dtype != _BF16:
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = _BF16_DESCR
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(arr.tobytes())


def _from_numpy(arr: np.ndarray, ref, dtype: str = ""):
    """``arr`` as ``ref``'s kind of leaf: a tensor on its device and of its
    dtype, or a Python scalar of its type.  ``dtype`` is the manifest's:
    ``"bfloat16"`` reads ``arr``'s 2-byte words as bfloat16, bit for bit."""
    if isinstance(ref, torch.Tensor):
        # (ascontiguousarray makes a 0-d array 1-d: reshape it back)
        if dtype == _BF16:
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.reshape(arr.shape).to(device=ref.device, dtype=ref.dtype)
    return type(ref)(arr.item())


def _shape(leaf) -> list[int]:
    return list(leaf.shape) if isinstance(leaf, torch.Tensor) else []


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, checksums: bool = True,
                 telemetry=None):
        self.dir = directory
        self.keep = keep
        self.checksums = checksums   # False skips CRC computation on save
        # Optional telemetry bus: save / GC / corrupt-skip become structured
        # "checkpoint" events instead of bare prints.
        self.telemetry = telemetry
        os.makedirs(directory, exist_ok=True)

    def _event(self, detail: str, *, step=None, severity: str = "info", **data) -> None:
        if self.telemetry is not None:
            self.telemetry.event("checkpoint", detail, step=step, severity=severity, **data)
        elif severity not in ("info", "debug"):
            # without a bus only problems print, as in the reference
            print(detail, flush=True)

    # ------------------------------------------------------------- paths

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------- save

    def save(self, step: int, tree: PyTree, *, extra: Optional[dict] = None,
             observer: Optional[Callable[[int, int], None]] = None) -> str:
        """Write a committed checkpoint for ``step``; returns its path.

        ``observer(leaf_index, total)`` fires after each leaf's file is
        written."""
        t0 = time.time()
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        flat = flatten_with_paths(tree)
        manifest = {"step": step, "treedef": f"{len(flat)} leaves", "extra": extra or {},
                    "leaves": []}
        for i, (path, leaf) in enumerate(flat):
            arr, dtype = _to_numpy(leaf)
            fname = f"arr_{i:05d}.shard0.npy"
            _write_npy(os.path.join(tmp, fname), arr, dtype)
            meta = {"id": i, "path": path, "shape": list(arr.shape), "dtype": dtype,
                    "shards": [fname]}
            if self.checksums:
                meta["crc32"] = [_crc(arr)]
            manifest["leaves"].append(meta)
            if observer is not None:
                observer(i, len(flat))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic commit
        self._event(f"checkpoint: saved step {step} ({len(flat)} leaves, "
                    f"{(time.time() - t0) * 1e3:.0f} ms)", step=step, severity="debug",
                    action="save", leaves=len(flat))
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        doomed = steps[: -self.keep] if self.keep > 0 else []
        if doomed:
            # Never evict the newest VERIFIED checkpoint: corrupt or partial
            # newer saves must not count toward ``keep``.
            protect = next((s for s in reversed(steps) if self.verify_step(s)), None)
            doomed = [s for s in doomed if s != protect]
        for s in doomed:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            self._event(f"checkpoint: gc step {s}", severity="debug", action="gc", gc_step=s)
        # stale tmp dirs of crashed writers
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # ------------------------------------------------------------- verify

    def _manifest(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)

    def _checked_manifest(self, step: int) -> dict:
        try:
            return self._manifest(step)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptionError(f"step {step}: unreadable manifest ({e})") from e

    def verify_step(self, step: int) -> bool:
        """Full integrity check of a committed checkpoint: every shard loads
        and matches its recorded CRC32 (a leaf without a CRC just needs to
        load)."""
        try:
            self._verify(step)
            return True
        except (CheckpointCorruptionError, OSError):
            return False

    def _verify(self, step: int) -> None:
        d = self._step_dir(step)
        for meta in self._checked_manifest(step)["leaves"]:
            crcs = meta.get("crc32")
            for k, fn in enumerate(meta["shards"]):
                self._load_shard(d, meta, fn, crcs[k] if crcs else None, step)

    @staticmethod
    def _load_shard(d: str, meta: dict, fn: str, crc: Optional[int],
                    step: int) -> np.ndarray:
        try:
            arr = np.load(os.path.join(d, fn), allow_pickle=False)
        except Exception as e:   # a truncated or garbled .npy raises ValueError
            raise CheckpointCorruptionError(
                f"step {step}: shard {fn} of {meta['path']} unreadable "
                f"({type(e).__name__}: {e})") from e
        if crc is not None and _crc(arr) != crc:
            raise CheckpointCorruptionError(
                f"step {step}: checksum mismatch on {meta['path']} (shard {fn}) — the "
                "file is corrupt (bit flip / partial write); restore falls back to the "
                "previous verified step")
        return arr

    def latest_verified_step(self) -> Optional[int]:
        """Newest committed step that passes full verification."""
        for s in reversed(self.all_steps()):
            if self.verify_step(s):
                return s
        return None

    # ------------------------------------------------------------- load

    def read_extra(self, step: int) -> dict:
        """The ``extra`` dict of a committed checkpoint, restoring nothing."""
        return self._manifest(step)["extra"]

    @staticmethod
    def _layout_mismatch_check(saved_paths, target_paths) -> None:
        """Name the structural mismatch users hit: an optimizer state saved
        with the other ``fuse_families`` setting.  Per-leaf low-rank states
        keep projectors under ``.../projs/<param path>``, the family-stacked
        ones under ``.../projs/<family index>``, so the two differ."""
        sp = [p for p in saved_paths if "/projs/" in p]
        tp = [p for p in target_paths if "/projs/" in p]
        if (sp or tp) and sp != tp:
            raise ValueError(
                "optimizer-state layout mismatch: the checkpoint stores "
                f"{len(sp)} projector leaves ({sp[:2]}...), the restore target expects "
                f"{len(tp)} ({tp[:2]}...).  This is what a fused-vs-per-leaf state "
                "difference looks like — the `fuse_families` flag "
                "(OptimizerConfig.fuse_families) of the restoring run must match the "
                "run that wrote the checkpoint.")

    def restore(self, step: int, like: PyTree, *, shardings: Optional[PyTree] = None,
                verify: bool = True) -> tuple[PyTree, dict]:
        """Restore into the structure of ``like``; returns ``(tree, extra)``.
        ``verify=True`` checks every shard against its CRC32 while loading
        and raises :class:`CheckpointCorruptionError` on a mismatch.

        ``shardings``, a tree of ``like``'s structure, gives each leaf's
        rule: ``None`` keeps the whole leaf, a
        :class:`~repro_torch.sharding.RowSplit` keeps this rank's rows of
        it, a :class:`~repro_torch.sharding.GridSplit` its block of two
        dims (``like`` holds the whole shapes)."""
        d = self._step_dir(step)
        manifest = self._checked_manifest(step)
        flat = flatten_with_paths(like)
        # runs even at equal leaf counts: a fused-vs-per-leaf flip can keep
        # both the counts and the shapes
        self._layout_mismatch_check([m["path"] for m in manifest["leaves"]],
                                    [p for p, _ in flat])
        if len(manifest["leaves"]) != len(flat):
            raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                             f"restore target has {len(flat)}")
        out = []
        for meta, (_, ref) in zip(manifest["leaves"], flat):
            crcs = meta.get("crc32") if verify else None
            parts = [self._load_shard(d, meta, fn, crcs[k] if crcs else None, step)
                     for k, fn in enumerate(meta["shards"])]
            arr = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
            if list(arr.shape) != _shape(ref):
                hint = ""
                if "/projs/" in meta["path"] or "/inner/" in meta["path"]:
                    hint = ("  (a rank-axis mismatch on low-rank optimizer state usually "
                            "means the checkpoint was written at a different rank / "
                            "rank-policy state — restore with the saved RankMap, e.g. via "
                            "the rank_policy extras the Trainer stores, or "
                            "migrate_opt_state)")
                raise ValueError(f"{meta['path']}: saved shape {tuple(arr.shape)} != "
                                 f"target {tuple(_shape(ref))}{hint}")
            out.append(_from_numpy(arr, ref, meta.get("dtype", "")))
        tree = _rebuild(like, iter(out))
        if shardings is not None:
            from repro_torch.sharding import zip_map

            tree = zip_map(lambda x, rule: x if rule is None else rule.apply(x), tree,
                            shardings)
        return tree, manifest["extra"]

    def restore_latest(self, like: PyTree, shardings: Optional[PyTree] = None):
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, like, shardings=shardings)
        return step, tree, extra

    def restore_latest_verified(self, like: PyTree, shardings: Optional[PyTree] = None):
        """Restore the newest checkpoint that passes verification, walking
        past corrupt ones (each skip printed).  Returns ``(step, tree,
        extra)`` or None when nothing restorable exists."""
        for step in reversed(self.all_steps()):
            try:
                tree, extra = self.restore(step, like, shardings=shardings, verify=True)
                return step, tree, extra
            except CheckpointCorruptionError as e:
                self._event(f"checkpoint: skipping corrupt step {step} ({e})",
                            severity="warn", action="corrupt_skip", corrupt_step=step)
        return None
