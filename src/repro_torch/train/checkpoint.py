"""Fault-tolerant checkpointing: atomic, crash-recoverable, defensive reads.

The port's counterpart of ``repro.train.checkpoint``, with the same
on-disk format, so a checkpoint written by either package restores in the
other:

    <dir>/step_000100.tmp.<unique>/   (written + fsynced first)
    <dir>/step_000100/                (atomic rename when complete)
        manifest.json           (tree structure, shapes, dtypes, checksums)
        arrays.npz              (flattened leaves, keys a0, a1, ...)

Leaves are flattened as the reference flattens its pytrees: dict keys in
sorted order, a NamedTuple's fields by name in field order (an
``AdamWState`` gives ``opt/step``, ``opt/m/...``, ``opt/v/...``), list and
tuple items by index, paths joined with ``/``
(``{"cold_in", "cold_out", "hot_in", "hot_out"}`` gives ``a0..a3`` in that
order). Leaves may be torch tensors (any device; copied to the host with a
blocking ``.cpu()``, which orders the copy after the work already queued
on the current stream) or numpy arrays. bfloat16 leaves are stored as
uint16 bytes with ``bfloat16`` in the manifest, as the reference stores
them.

Publication is crash-atomic (DESIGN.md §9): files and the tmp directory
are fsynced before the rename, a same-step re-save displaces the old
directory by *rename*, and the parent directory is fsynced after publish.
:func:`_clean_stale` — run at every save and consulted by
:func:`latest_step` — deletes interrupted ``*.tmp.*`` writes and recovers
a displaced ``*.old.*`` directory whose final name went missing
mid-publish, but only once such a directory is :data:`STALE_GRACE_S` old,
so a concurrent reader never disturbs a live publisher.

Reads are defensive: a directory that cannot be read back (truncated
``arrays.npz``, unparseable manifest, checksum mismatch) raises
:class:`CorruptCheckpoint`; :func:`restore` with ``step=None`` and
:func:`latest_step` *quarantine* such a directory (rename to
``step_N.corrupt*``) and fall back to the previous step. Structural
mismatches (wrong shapes, missing leaves) still raise.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import re
import shutil
import tempfile
import time
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map_with_path

log = logging.getLogger("repro_torch.checkpoint")


class CorruptCheckpoint(IOError):
    """A checkpoint directory that cannot be read back: truncated or
    missing ``arrays.npz``, unparseable ``manifest.json``, or a checksum
    mismatch. Latest-step restores quarantine the directory and fall back
    to the previous step; explicit-step restores quarantine and re-raise."""


@dataclasses.dataclass
class PipelineCursor:
    """Host-pipeline position stored with every W2V checkpoint.

    Because batching randomness is keyed by ``(seed, epoch, batch_index)``
    (DESIGN.md §4.1), this pair is the *complete* input-pipeline state: on
    resume the pipeline fast-forwards with ``skip_batches=epoch_batch`` and
    reproduces the exact remainder of the interrupted epoch — for any
    ``prefetch_workers`` count, including one different from the run that
    wrote the checkpoint. ``prefetch_workers`` is recorded for provenance
    only, never replayed.
    """
    epoch: int = 0
    epoch_batch: int = 0        # batches already trained in `epoch`
    prefetch_workers: int = 0   # worker count of the writing run (info only)

    def to_extra(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "epoch_batch": self.epoch_batch,
                "prefetch_workers": self.prefetch_workers}

    @classmethod
    def from_extra(cls, extra: Dict[str, Any]) -> "PipelineCursor":
        return cls(epoch=int(extra.get("epoch", 0)),
                   epoch_batch=int(extra.get("epoch_batch", 0)),
                   prefetch_workers=int(extra.get("prefetch_workers", 0)))


def np_dtype(name: str) -> np.dtype:
    """Resolve a manifest dtype string that numpy knows (``float32``,
    ``int8``, ...). ``bfloat16`` has no numpy dtype without ``ml_dtypes``;
    :func:`restore` reads such leaves through torch instead, and this
    raises ``TypeError`` naming the dtype."""
    try:
        return np.dtype(name)
    except TypeError as e:
        raise TypeError(f"manifest dtype {name!r} has no numpy dtype; "
                        f"read it with restore() into a torch tensor of "
                        f"that dtype") from e


def _dtype_name(like) -> str:
    """The manifest name of a leaf's dtype (torch or numpy)."""
    dt = like.dtype
    if isinstance(dt, str):
        return dt
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return str(np.dtype(dt))


def _flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in the reference's pytree order
    (:func:`repro_torch.tree.tree_map_with_path`'s walk and names), ``None``
    dropped (an empty subtree)."""
    out: List[Tuple[str, Any]] = []
    tree_map_with_path(
        lambda path, leaf: out.append((path, leaf)) if leaf is not None
        else None, tree)
    return out


def _unflatten(tree: Any, leaves: Dict[str, Any]) -> Any:
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    return tree_map_with_path(
        lambda path, leaf: None if leaf is None else leaves[path], tree)


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as ``(numpy array as stored, manifest dtype name)``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    # np.ascontiguousarray would lift a 0-d leaf (an optimizer step) to 1-d
    return np.require(arr, requirements="C"), str(arr.dtype)


def _fsync_path(path: str) -> None:
    """fsync a file or directory by path (directory entries need their own
    fsync for the rename to be durable)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# How old a step_N.tmp.* / step_N.old.* directory must be before
# maintenance touches it. A live publisher's in-flight dirs are always
# younger than this (a publish is seconds at most); anything older is a
# crash leftover.
STALE_GRACE_S = 60.0


def _older_than(path: str, grace_s: float) -> bool:
    if grace_s <= 0:
        return True
    try:
        return (time.time() - os.path.getmtime(path)) >= grace_s
    except OSError:        # vanished under a concurrent cleaner
        return False


def _clean_stale(ckpt_dir: str, grace_s: float = STALE_GRACE_S) -> None:
    """Remove interrupted publishes; recover displaced finals.

    ``step_N.tmp*`` directories are incomplete writes — deleted. A
    ``step_N.old.*`` directory is a *complete* checkpoint displaced by a
    re-save of the same step: if the crash hit the window between the two
    renames (so ``step_N`` itself is missing), rename it back; otherwise
    delete it. Both actions wait until the directory is ``grace_s`` old.
    """
    if not os.path.isdir(ckpt_dir):
        return
    for name in sorted(os.listdir(ckpt_dir)):
        path = os.path.join(ckpt_dir, name)
        if re.fullmatch(r"step_\d+\.tmp(\..*)?", name):
            if _older_than(path, grace_s):
                shutil.rmtree(path, ignore_errors=True)
            continue
        m = re.fullmatch(r"(step_\d+)\.old\..*", name)
        if m and _older_than(path, grace_s):
            final = os.path.join(ckpt_dir, m.group(1))
            if (not os.path.exists(final)
                    and os.path.exists(os.path.join(path, "manifest.json"))):
                log.warning("recovering displaced checkpoint %s -> %s "
                            "(crash during publish)", name, m.group(1))
                try:
                    os.rename(path, final)
                except OSError:   # lost the race to another recoverer
                    pass
            else:
                shutil.rmtree(path, ignore_errors=True)


def quarantine(ckpt_dir: str, step: int) -> str:
    """Move a corrupt/poisoned step directory out of the restore path
    (renamed to ``step_N.corrupt*``, kept for post-mortem). Returns the
    quarantine path."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    dst = d + ".corrupt"
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{d}.corrupt.{n}"
    os.rename(d, dst)
    log.warning("quarantined checkpoint step %d -> %s", step,
                os.path.basename(dst))
    return dst


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Crash-atomically write a checkpoint; prune to the newest `keep`.

    Write path: unique tmp dir -> fsync files + tmp dir -> displace any
    existing final by rename -> rename tmp into place -> fsync parent ->
    delete the displaced dir. A crash at any point leaves either the old
    or the new checkpoint recoverable (``_clean_stale``).
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    _clean_stale(ckpt_dir)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp.", dir=ckpt_dir)
    unique = tmp.rsplit(".", 1)[-1]

    arrays = {}
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (path, leaf) in enumerate(_flatten_with_paths(tree)):
        arr, dtype_name = _host_array(leaf)
        key = f"a{i}"
        arrays[key] = arr
        manifest["leaves"].append({
            "path": path, "key": key, "shape": list(arr.shape),
            "dtype": dtype_name,
            "sha1": hashlib.sha1(arr.tobytes()).hexdigest(),
        })
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(tmp)
    displaced = None
    if os.path.exists(final):
        # same-step re-save (the trainer re-checkpointing at the same
        # batches_seen after a rollback): displace by rename, never rmtree
        displaced = f"{final}.old.{unique}"
        os.rename(final, displaced)
    os.rename(tmp, final)
    _fsync_path(ckpt_dir)
    if displaced is not None:
        shutil.rmtree(displaced, ignore_errors=True)
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = list_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def _dir_state(d: str) -> str:
    """The light completeness check of a step directory: ``"complete"``
    (parseable manifest, arrays file present), ``"gone"`` (no such
    directory) or ``"partial"``."""
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            json.load(f)
        if os.path.exists(os.path.join(d, "arrays.npz")):
            return "complete"
    except (OSError, ValueError):
        pass
    return "partial" if os.path.isdir(d) else "gone"


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step whose directory passes a light completeness check
    (parseable manifest + arrays file present). An incomplete directory
    is quarantined and the previous step returned instead; a publish
    interrupted mid-rename is recovered first (``_clean_stale``).

    A directory that fails the check is read a second time before it is
    quarantined: a same-step re-save displaces the old directory and
    renames the new one into place, so between the two reads the name can
    have gone and come back whole. A directory that passes the second read
    is returned; one that is gone at the second read is skipped, never
    quarantined (a republish may land under its name next)."""
    _clean_stale(ckpt_dir)
    steps = list_steps(ckpt_dir)
    while steps:
        step = steps.pop()
        d = os.path.join(ckpt_dir, f"step_{step:08d}")
        if _dir_state(d) == "complete":
            return step
        state = _dir_state(d)
        if state == "complete":
            return step
        if state == "gone":
            continue
        log.warning("checkpoint step %d is partial — quarantining and "
                    "falling back", step)
        try:
            quarantine(ckpt_dir, step)
        except OSError:
            # a concurrent pruner removed the dir between our read and
            # the rename — nothing left to quarantine
            pass
    return None


def _read_manifest(d: str) -> Dict:
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CorruptCheckpoint(f"unreadable manifest in {d}: {e}") from e


def peek(ckpt_dir: str, step: Optional[int] = None
         ) -> Tuple[Dict[str, Dict], Dict]:
    """Inspect a checkpoint without loading arrays: leaf metadata
    (``path -> {shape, dtype}``) plus the ``extra`` dict. Lets callers
    decide what structure to :func:`restore` into — e.g. the trainer
    detecting a split-table (vocab-sharded) checkpoint and reassembling it
    for a replicated session, or vice versa."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = _read_manifest(d)
    leaves = {l["path"]: {"shape": tuple(l["shape"]), "dtype": l["dtype"]}
              for l in manifest["leaves"]}
    return leaves, manifest["extra"]


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """A leaf's shape and manifest dtype name, for :func:`restore`'s
    ``tree_like`` when no tensor of that shape exists yet."""
    shape: Tuple[int, ...]
    dtype: str


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None,
            device=None, verify: bool = True) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like`` (tensors, arrays or
    :class:`ArraySpec`). With ``device`` every leaf comes back as a new
    torch tensor on it; without, as a numpy array (bfloat16 leaves come
    back as torch tensors either way: numpy has no such dtype).

    With ``step=None`` a corrupt newest checkpoint is quarantined and the
    previous one restored instead (repeating as needed); an explicit
    ``step`` that turns out corrupt is quarantined and
    :class:`CorruptCheckpoint` re-raised so the caller can pick the
    fallback itself.
    """
    if step is not None:
        try:
            return _restore_step(ckpt_dir, step, tree_like, device, verify)
        except CorruptCheckpoint:
            quarantine(ckpt_dir, step)
            raise
    steps = list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    while steps:
        s = steps.pop()
        try:
            return _restore_step(ckpt_dir, s, tree_like, device, verify)
        except CorruptCheckpoint as e:
            log.warning("checkpoint step %d corrupt (%s) — quarantining "
                        "and falling back", s, e)
            quarantine(ckpt_dir, s)
    raise FileNotFoundError(
        f"no readable checkpoints under {ckpt_dir} (all quarantined)")


def _leaf_out(arr: np.ndarray, stored: str, want: str, device):
    """One loaded array as the caller asked for it: converted to the
    ``want`` dtype, on ``device`` (a new tensor) or as numpy."""
    if stored == "bfloat16" or want == "bfloat16":
        t = (torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
             if stored == "bfloat16" else torch.from_numpy(arr.copy()))
        t = t.to(getattr(torch, want))
        return t if device is None else t.to(device)
    arr = arr.astype(np_dtype(want), copy=False)
    if device is None:
        return arr
    return torch.tensor(arr, device=device)


def _restore_step(ckpt_dir: str, step: int, tree_like: Any, device,
                  verify: bool) -> Tuple[Any, Dict]:
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = _read_manifest(d)
    try:
        data = np.load(os.path.join(d, "arrays.npz"))
    except (OSError, ValueError, zipfile.BadZipFile, EOFError) as e:
        raise CorruptCheckpoint(f"unreadable arrays.npz in {d}: {e}") from e
    by_path = {l["path"]: l for l in manifest["leaves"]}
    leaves = {}
    with data:
        for path, like in _flatten_with_paths(tree_like):
            meta = by_path.get(path)
            if meta is None:
                raise KeyError(f"checkpoint {d} missing leaf {path!r}")
            try:
                # a truncated zip member surfaces here, not at np.load
                arr = data[meta["key"]]
            except (KeyError, OSError, ValueError, zipfile.BadZipFile,
                    EOFError, zlib.error) as e:
                raise CorruptCheckpoint(
                    f"unreadable leaf {path!r} in {d}: {e}") from e
            if (verify and hashlib.sha1(arr.tobytes()).hexdigest()
                    != meta["sha1"]):
                raise CorruptCheckpoint(
                    f"checksum mismatch for {path!r} in {d}")
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(
                    f"shape mismatch for {path!r}: ckpt {arr.shape} vs "
                    f"model {tuple(like.shape)}")
            leaves[path] = _leaf_out(arr, meta["dtype"], _dtype_name(like),
                                     device)
    return _unflatten(tree_like, leaves), manifest["extra"]
