"""Checkpoints (port of ``imaginaire_tpu/utils/checkpoint.py``, without
orbax).

The JAX package's loop contract, on torch files:
  - a checkpoint is the directory
    ``<logdir>/epoch_EEEEE_iteration_IIIIIIIII_checkpoint`` holding
    ``state.pt``: ``{"state": {path: tensor}, "meta": {...}}``;
  - ``<logdir>/latest_checkpoint.txt`` names the latest one;
  - ``<ckpt>.integrity.json`` beside it holds the per-tensor crc32
    records and the files' digests (``resilience/integrity.py``).

Save: ``torch.save`` of CPU copies into a temporary directory (flushed
to disk), the integrity sidecar, an atomic rename of the directory, then
the pointer; retention GC last. Load: the files' digests are checked
before ``torch.load(..., weights_only=True)`` reads a byte, and the
tensors' records after, before the caller sees them.
``load_latest_verified`` quarantines every corrupt candidate and falls
back to the newest one that verifies.
"""

from __future__ import annotations

import errno
import json
import logging
import os
import pickle
import re
import shutil
import zipfile

import torch

from imaginaire_tpu_torch.resilience.integrity import (
    CheckpointIntegrityError,
    file_digests,
    quarantine_checkpoint,
    sidecar_files,
    tree_checksums,
    verify_files,
    verify_tree,
)

logger = logging.getLogger(__name__)

POINTER = "latest_checkpoint.txt"
STATE_FILE = "state.pt"
_CKPT_RE = re.compile(r"^epoch_(\d+)_iteration_(\d+)_checkpoint$")


def checkpoint_name(epoch, iteration):
    return f"epoch_{epoch:05d}_iteration_{iteration:09d}_checkpoint"


def parse_checkpoint_name(name):
    m = re.search(r"epoch_(\d+)_iteration_(\d+)", os.path.basename(str(name)))
    if not m:
        return 0, 0
    return int(m.group(1)), int(m.group(2))


def scan_checkpoints(logdir):
    """Committed checkpoints under ``logdir``, oldest first, as
    ``[(epoch, iteration, path), ...]``; quarantined and temporary
    directories never match."""
    try:
        names = os.listdir(logdir)
    except OSError:
        return []
    out = []
    for name in names:
        m = _CKPT_RE.match(name)
        path = os.path.join(logdir, name)
        if m and os.path.isdir(path):
            out.append((int(m.group(1)), int(m.group(2)), path))
    out.sort()
    return out


def _write_atomic(path, text):
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_pointer(logdir):
    try:
        with open(os.path.join(logdir, POINTER)) as f:
            return f.read().strip()
    except OSError:
        return None


def read_integrity_sidecar(path):
    try:
        with open(str(path) + ".integrity.json") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def save_checkpoint(logdir, state, meta, epoch, iteration, max_to_keep=None):
    """Write ``{"state": state, "meta": meta}`` (``state``: a flat
    {path: tensor} dict, on any device) with its integrity sidecar as the
    checkpoint of (epoch, iteration), then move the pointer to it. A
    checkpoint that already exists under that name is kept and only the
    pointer is rewritten."""
    name = checkpoint_name(epoch, iteration)
    path = os.path.abspath(os.path.join(logdir, name))
    if os.path.exists(path):
        _write_atomic(os.path.join(logdir, POINTER), name + "\n")
        return path
    cpu_state = {k: v.detach().cpu() for k, v in state.items()}
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        torch.save({"state": cpu_state, "meta": dict(meta)}, f)
        f.flush()
        os.fsync(f.fileno())
    integrity = dict(tree_checksums(cpu_state), files=file_digests(tmp))
    _write_atomic(path + ".integrity.json", json.dumps(integrity, indent=1))
    os.replace(tmp, path)
    _write_atomic(os.path.join(logdir, POINTER), name + "\n")
    gc_checkpoints(logdir, max_to_keep, protect=(path,))
    return path


def latest_checkpoint_path(logdir):
    """The pointed checkpoint, or the newest one in ``logdir`` when the
    pointer names a missing path; None without a pointer file."""
    name = _read_pointer(logdir)
    if name is None:
        return None
    path = os.path.join(logdir, name) if name else None
    if path and os.path.exists(path):
        return path
    entries = scan_checkpoints(logdir)
    if not entries:
        return None
    logger.warning("%s names %r, which does not exist; falling back to the "
                   "newest checkpoint in the logdir: %s", POINTER, name, entries[-1][2])
    return entries[-1][2]


def gc_checkpoints(logdir, max_to_keep, protect=()):
    """Keep the newest ``max_to_keep`` checkpoints. Never deletes the
    pointer's target, anything in ``protect``, or the newest checkpoint
    that carries integrity records."""
    if not max_to_keep or int(max_to_keep) <= 0:
        return []
    entries = scan_checkpoints(logdir)
    if len(entries) <= int(max_to_keep):
        return []
    protected = {os.path.abspath(str(p)) for p in protect}
    pointed = _read_pointer(logdir)
    if pointed:
        protected.add(os.path.abspath(os.path.join(logdir, pointed)))
    for _, _, path in reversed(entries):
        if read_integrity_sidecar(path) is not None:
            protected.add(os.path.abspath(path))
            break
    deleted = []
    for _, _, path in entries[:-int(max_to_keep)]:
        if os.path.abspath(path) in protected:
            continue
        for sidecar in sidecar_files(path):
            os.remove(sidecar)
        shutil.rmtree(path)
        deleted.append(path)
    if deleted:
        logger.info("checkpoint GC deleted %s", [os.path.basename(p) for p in deleted])
    return deleted


def load_checkpoint(path, map_location=None):
    """The ``{"state", "meta"}`` payload of one checkpoint, its tensors
    on ``map_location``. Where the checkpoint has a sidecar, the files'
    digests are checked before loading and the tensors' records after;
    either mismatch raises ``CheckpointIntegrityError``."""
    path = os.path.abspath(str(path))
    integrity = read_integrity_sidecar(path)
    verify_files(path, (integrity or {}).get("files"), context=path)
    payload = torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                         weights_only=True)
    verify_tree(payload["state"], integrity, context=path)
    return payload


def is_corrupt_checkpoint_error(exc):
    """Whether ``exc``, raised while loading a checkpoint, is evidence
    about the checkpoint's bytes: an integrity mismatch, a missing,
    truncated or unreadable file, an unreadable pickle or zip archive, a
    payload without its keys. Any other error (a device fault, an
    allocator failure, a process out of file handles) says nothing about
    the checkpoint and must not condemn it."""
    if isinstance(exc, (CheckpointIntegrityError, FileNotFoundError, EOFError,
                        pickle.UnpicklingError, zipfile.BadZipFile, KeyError)):
        return True
    # torch.load's zip reader: a seek past a truncated file's end, a read
    # the storage fails, or its own report of a damaged archive
    if isinstance(exc, OSError):
        return exc.errno in (errno.EINVAL, errno.EIO)
    return isinstance(exc, RuntimeError) and "PytorchStreamReader" in str(exc)


def load_latest_verified(logdir, map_location=None):
    """The resume path: restore the pointed checkpoint, quarantining each
    candidate that fails to verify or load and falling back to the next
    newest. Returns ``(payload, path, fallbacks)``; ``payload`` is None
    without a pointer file (a fresh run). Raises when a pointer exists
    but every candidate failed."""
    pointed_name = _read_pointer(logdir)
    if pointed_name is None:
        return None, None, 0
    pointed = (os.path.abspath(os.path.join(logdir, pointed_name))
               if pointed_name else None)
    candidates = [pointed] if pointed and os.path.exists(pointed) else []
    candidates += [os.path.abspath(p) for _, _, p in reversed(scan_checkpoints(logdir))
                   if os.path.abspath(p) != pointed]
    if not candidates:
        logger.warning("%s names %r but %s holds no checkpoint", POINTER,
                       pointed_name, logdir)
        return None, None, 0
    errors = []
    for fallbacks, cand in enumerate(candidates):
        try:
            payload = load_checkpoint(cand, map_location=map_location)
        except Exception as e:  # noqa: BLE001 -- sorted by is_corrupt_checkpoint_error
            if not is_corrupt_checkpoint_error(e):
                raise  # the device or the runtime, not this checkpoint
            errors.append(f"{cand}: {type(e).__name__}: {e}")
            quarantine_checkpoint(cand, reason=f"{type(e).__name__}")
            logger.error("checkpoint %s failed to restore (%s); falling back "
                         "to the next newest", cand, str(e)[:500])
            continue
        return payload, cand, fallbacks
    raise RuntimeError(
        f"no verifiable checkpoint in {logdir}: every candidate failed to "
        f"restore ({len(errors)} quarantined). Delete or repair the logdir to "
        "restart from scratch. Errors: " + " | ".join(errors[:3]))
