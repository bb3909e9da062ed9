"""Checkpoint/resume: parameters + optimizer state + step, as torch files.

The counterpart of ``accl_tpu/utils/checkpoint.py``, with
``torch.save`` / ``torch.load(weights_only=True)`` in place of orbax. A
checkpoint is a directory holding one file, ``state.pt``, of a nested
dict (lists and tuples too) of tensors and Python scalars, such as
``{"params": model.state_dict(), "opt_state": opt.state_dict(),
"step": n}``. The contract is the reference's:

* Saves are atomic: the tree is written into a temporary sibling
  directory, which ``os.replace`` moves into place (over an existing
  checkpoint, its file replaces the old one's), so a save cut short
  never replaces a good checkpoint, and the path never lacks a whole
  tree.
* Every save writes a manifest of per-file crc32 checksums beside the
  checkpoint (``<dir>/.integrity/<step>.json`` for the manager,
  ``<path>.integrity.json`` for a one-shot checkpoint), and every load
  verifies it first: a torn, truncated or bit-rotted checkpoint raises
  ``ACCLError(DATA_INTEGRITY_ERROR)`` instead of restoring garbage. A
  checkpoint without a manifest loads as it is.
* :class:`CheckpointManager` keeps ``max_to_keep`` step directories
  ``<dir>/<step>/`` and prunes the evicted steps' manifests.

A ``target`` tree places each loaded tensor on the target leaf's device
and dtype; without one, tensors land on the CPU.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import warnings
import zlib
from typing import Any

import torch

from ..constants import ACCLError, ErrorCode

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "write_integrity_manifest", "verify_integrity_manifest"]

_MANIFEST_DIRNAME = ".integrity"  # not a number: skipped by the step scan
_MANIFEST_VERSION = 1
_CRC_CHUNK = 1 << 20
_STATE_FILE = "state.pt"


# -- content-integrity manifests --------------------------------------------

def _file_crc(path: str) -> tuple[int, int]:
    """(crc32, size) of one file, streamed in 1 MiB chunks (a checkpoint
    file can be GBs; never hold one whole)."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CRC_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return crc & 0xFFFFFFFF, size


def _tree_files(root: str) -> list[str]:
    """Every regular file under ``root``, as sorted relative paths: the
    enumeration both the writer and the verifier use."""
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            out.append(os.path.relpath(os.path.join(dirpath, name), root))
    return sorted(out)


def _write_pending_manifest(ckpt_dir: str, manifest_path: str) -> dict:
    """Checksum every file of ``ckpt_dir`` into the manifest JSON
    ``manifest_path + ".tmp"``, which a rename then puts in place."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    files = {}
    for rel in _tree_files(ckpt_dir):
        crc, size = _file_crc(os.path.join(ckpt_dir, rel))
        files[rel] = [crc, size]
    manifest = {"version": _MANIFEST_VERSION, "files": files}
    os.makedirs(os.path.dirname(manifest_path), exist_ok=True)
    with open(manifest_path + ".tmp", "w") as f:
        json.dump(manifest, f)
    return manifest


def write_integrity_manifest(ckpt_dir: str, manifest_path: str) -> dict:
    """Checksum every file of a written checkpoint directory into a
    manifest JSON, written atomically (tmp + rename, like the checkpoint:
    a torn manifest must not condemn a good checkpoint)."""
    manifest = _write_pending_manifest(ckpt_dir, manifest_path)
    os.replace(manifest_path + ".tmp", manifest_path)
    return manifest


def verify_integrity_manifest(ckpt_dir: str, manifest_path: str) -> None:
    """Verify a checkpoint directory against its manifest before any load
    touches it. Raises ``ACCLError(DATA_INTEGRITY_ERROR)`` naming the
    first offending file: a missing file (torn checkpoint), a size change
    (truncation) or a crc change (bit rot). A missing manifest is not an
    error: refusing a checkpoint written without one would turn the
    upgrade itself into data loss."""
    if not os.path.exists(manifest_path):
        return

    def _fail(detail: str):
        raise ACCLError(
            int(ErrorCode.DATA_INTEGRITY_ERROR),
            f"checkpoint integrity check failed for {ckpt_dir}: {detail}")

    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
        files = manifest["files"]
    except (OSError, ValueError, KeyError) as exc:
        _fail(f"unreadable integrity manifest {manifest_path} ({exc})")
    ckpt_dir = os.path.abspath(ckpt_dir)
    for rel, (want_crc, want_size) in sorted(files.items()):
        path = os.path.join(ckpt_dir, rel)
        if not os.path.exists(path):
            _fail(f"missing file {rel} (torn checkpoint)")
        got_crc, got_size = _file_crc(path)
        if got_size != want_size:
            _fail(f"{rel}: size {got_size} != manifest {want_size} "
                  f"(truncated)")
        if got_crc != want_crc:
            _fail(f"{rel}: crc32 {got_crc:#x} != manifest "
                  f"{want_crc:#x} (bit rot)")


def _oneshot_manifest_path(path: str) -> str:
    """Manifest location of a one-shot checkpoint: a sibling file, so the
    checkpoint directory holds only what the save wrote."""
    path = os.path.abspath(path).rstrip(os.sep)
    return path + ".integrity.json"


# -- the tree on disk ---------------------------------------------------------

def _write_tree(path: str, tree: Any, manifest: str) -> None:
    """Write ``tree`` as the checkpoint directory ``path``, and its
    ``manifest``. The tree goes into a temporary sibling directory,
    fsynced, and its manifest to a temporary name; then a rename puts the
    tree in place (the directory, or over an existing checkpoint its
    file, so that ``path`` always holds a whole tree), and a second one
    the manifest. A save cut short before the first rename leaves the
    old checkpoint and its manifest as they were; one cut between the
    two leaves a tree that its old manifest refuses, never one that
    loads unchecked. Temporaries of earlier saves cut short go first."""
    path = os.path.abspath(path).rstrip(os.sep)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    prefix = os.path.basename(path) + ".tmp-"
    for name in os.listdir(parent):
        if name.startswith(prefix):
            shutil.rmtree(os.path.join(parent, name), ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix=prefix, dir=parent)
    try:
        file = os.path.join(tmp, _STATE_FILE)
        with open(file, "wb") as f:
            torch.save(tree, f)
            f.flush()
            os.fsync(f.fileno())
        _write_pending_manifest(tmp, manifest)
        if os.path.isdir(path):
            os.replace(file, os.path.join(path, _STATE_FILE))
        else:
            os.replace(tmp, path)
        os.replace(manifest + ".tmp", manifest)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _place(loaded: Any, target: Any, where: str = "tree") -> Any:
    """``loaded`` with each tensor moved to the device and dtype of the
    matching leaf of ``target``; a structure that differs raises."""
    if isinstance(target, torch.Tensor):
        if not isinstance(loaded, torch.Tensor):
            raise ValueError(f"checkpoint {where}: a tensor in the target, "
                             f"{type(loaded).__name__} on disk")
        if tuple(loaded.shape) != tuple(target.shape):
            raise ValueError(f"checkpoint {where}: shape "
                             f"{tuple(loaded.shape)} on disk, "
                             f"{tuple(target.shape)} in the target")
        # a copy: the loaded tensor maps the file
        return loaded.to(device=target.device, dtype=target.dtype,
                         copy=True)
    if isinstance(target, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(target):
            have = (sorted(map(str, loaded)) if isinstance(loaded, dict)
                    else type(loaded).__name__)
            raise ValueError(f"checkpoint {where}: {have} on disk, keys "
                             f"{sorted(map(str, target))} in the target")
        return {k: _place(loaded[k], t, f"{where}[{k!r}]")
                for k, t in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or len(loaded) != len(target):
            raise ValueError(f"checkpoint {where}: a sequence of "
                             f"{len(target)} in the target differs on disk")
        out = [_place(x, t, f"{where}[{i}]")
               for i, (x, t) in enumerate(zip(loaded, target))]
        return type(target)(out)
    return loaded


def _read_tree(path: str, target: Any = None) -> Any:
    file = os.path.join(os.path.abspath(path), _STATE_FILE)
    if target is None:
        return torch.load(file, map_location="cpu", weights_only=True)
    # mapped, so that each tensor is read as it is placed
    return _place(torch.load(file, map_location="cpu", weights_only=True,
                             mmap=True), target)


# -- the manager and the one-shot calls -------------------------------------

class CheckpointManager:
    """Step-indexed checkpoint directory with retention.

    Usage::

        mgr = CheckpointManager("/ckpts/run1", max_to_keep=3)
        mgr.save(step, {"params": model.state_dict(),
                        "opt_state": opt.state_dict()})
        restored = mgr.restore(target={"params": model.state_dict(),
                                       "opt_state": opt.state_dict()})
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, _MANIFEST_DIRNAME,
                            f"{int(step)}.json")

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _steps(self) -> list[int]:
        """The saved steps, ascending: the directories named by a number
        (``.integrity`` and a save's temporary directories are not)."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def save(self, step: int, tree: Any, wait: bool = True):
        if not wait:
            # kept for signature compatibility; a save always waits: the
            # manifest can only checksum finalized bytes. Loud, so that a
            # loop counting on overlapped saves learns why it slowed.
            warnings.warn(
                "CheckpointManager.save(wait=False) now blocks until "
                "the write finishes: the content-integrity manifest "
                "must checksum finalized bytes",
                RuntimeWarning, stacklevel=2)
        _write_tree(self._step_dir(step), tree, self._manifest_path(step))
        if self.max_to_keep is not None:
            for old in self._steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        self._prune_manifests()

    def _prune_manifests(self):
        mdir = os.path.join(self.directory, _MANIFEST_DIRNAME)
        if not os.path.isdir(mdir):
            return
        for name in os.listdir(mdir):
            step_name, ext = os.path.splitext(name)
            if ext == ".json" and step_name.isdigit() \
                    and not os.path.isdir(self._step_dir(int(step_name))):
                try:
                    os.remove(os.path.join(mdir, name))
                except OSError:
                    pass

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, target: Any = None) -> Any:
        """Restore ``step`` (default: the latest). ``target`` gives each
        tensor's device and dtype. The step's checksums are verified
        first: a torn or bit-rotted checkpoint raises
        DATA_INTEGRITY_ERROR instead of restoring garbage."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
        if not os.path.isdir(self._step_dir(step)):
            raise FileNotFoundError(
                f"no checkpoint of step {step} under {self.directory}")
        verify_integrity_manifest(self._step_dir(step),
                                  self._manifest_path(step))
        return _read_tree(self._step_dir(step), target)

    def close(self):
        """Nothing stays open between calls; kept for the reference's
        interface."""


def save_checkpoint(path: str, tree: Any):
    """One-shot atomic save of a tree to the directory ``path`` (+ the
    sibling integrity manifest, verified by :func:`load_checkpoint`)."""
    _write_tree(path, tree, _oneshot_manifest_path(path))


def load_checkpoint(path: str, target: Any = None) -> Any:
    """One-shot load; ``target`` gives each tensor's device and dtype.
    Verifies the sibling integrity manifest first (see
    :func:`verify_integrity_manifest`)."""
    verify_integrity_manifest(os.path.abspath(path),
                              _oneshot_manifest_path(path))
    return _read_tree(path, target)
