"""Checkpoint integrity (port of ``imaginaire_tpu/resilience/integrity.py``).

Two layers, as in the JAX package. ``file_digests`` records each file's
size and crc32 under a committed checkpoint directory and
``verify_files`` replays them with plain reads before the deserializer
touches a byte. ``tree_checksums`` records each tensor's crc32 over its
raw bytes, its shape and its dtype, over a flat ``{path: tensor}`` tree,
and ``verify_tree`` replays them on the loaded tensors. A mismatch
raises ``CheckpointIntegrityError``; ``quarantine_checkpoint`` renames
a corrupt checkpoint and its sidecars ``*.corrupt`` so scans skip it.
"""

from __future__ import annotations

import logging
import os
import zlib

import torch

logger = logging.getLogger(__name__)

INTEGRITY_VERSION = 1
SIDECAR_SUFFIXES = (".integrity.json",)


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint's bytes do not match its saved checksums."""


def sidecar_files(path):
    """The existing sidecar files of a checkpoint."""
    return [str(path) + s for s in SIDECAR_SUFFIXES if os.path.exists(str(path) + s)]


def tensor_record(t):
    """{crc, shape, dtype} of one tensor's raw bytes (any dtype, any
    device; a CPU copy is made when needed)."""
    data = t.detach().to("cpu").contiguous().reshape(-1)
    return {"crc": int(zlib.crc32(data.view(torch.uint8).numpy())),
            "shape": [int(s) for s in t.shape],
            "dtype": str(t.dtype).removeprefix("torch.")}


def tree_checksums(tree):
    """Per-tensor crc32 records of a flat ``{path: tensor}`` tree:
    ``{"version", "algo", "leaves": {path: record}, "skipped": {path:
    reason}, "n_leaves"}``. Leaves that are not tensors are skipped with a
    reason."""
    leaves, skipped = {}, {}
    for key, leaf in tree.items():
        if torch.is_tensor(leaf):
            leaves[key] = tensor_record(leaf)
        else:
            skipped[key] = "not_tensor"
    return {"version": INTEGRITY_VERSION, "algo": "crc32", "leaves": leaves,
            "skipped": skipped, "n_leaves": len(leaves)}


def verify_tree(tree, integrity, context=""):
    """Raise ``CheckpointIntegrityError`` when ``tree`` differs from a
    ``tree_checksums`` record (a missing, extra or changed tensor); no-op
    for an empty record."""
    if not integrity or not integrity.get("leaves"):
        return None
    got = tree_checksums(tree)
    want = integrity["leaves"]
    mismatches = [f"{k}: missing" for k in want if k not in got["leaves"]]
    mismatches += [f"{k}: not in the record" for k in got["leaves"] if k not in want]
    for key, rec in want.items():
        have = got["leaves"].get(key)
        if have is None:
            continue
        for field in ("crc", "shape", "dtype"):
            if have[field] != rec[field]:
                mismatches.append(f"{key}: {field} {rec[field]} -> {have[field]}")
                break
    if mismatches:
        raise CheckpointIntegrityError(
            f"checkpoint integrity verification failed"
            f"{' for ' + context if context else ''}: " + "; ".join(mismatches[:8])
            + (f" (+{len(mismatches) - 8} more)" if len(mismatches) > 8 else ""))
    return got


def _file_crc(path):
    crc, size = 0, 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return size, int(crc)


def file_digests(root):
    """{relative path: {size, crc}} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(str(root)):
        for name in files:
            path = os.path.join(dirpath, name)
            size, crc = _file_crc(path)
            out[os.path.relpath(path, str(root))] = {"size": size, "crc": crc}
    return out


def verify_files(root, records, context=""):
    """Raise ``CheckpointIntegrityError`` when the files under ``root``
    differ from a ``file_digests`` record; no-op for an empty record."""
    if not records:
        return
    mismatches = []
    for rel, want in records.items():
        path = os.path.join(str(root), rel)
        if not os.path.isfile(path):
            mismatches.append(f"{rel}: missing")
            continue
        try:
            size, crc = _file_crc(path)
        except OSError as e:
            mismatches.append(f"{rel}: unreadable ({e})")
            continue
        if size != want.get("size"):
            mismatches.append(f"{rel}: size {want.get('size')} -> {size}")
        elif crc != want.get("crc"):
            mismatches.append(f"{rel}: file crc {want.get('crc')} -> {crc}")
    if mismatches:
        raise CheckpointIntegrityError(
            f"checkpoint file verification failed"
            f"{' for ' + context if context else ''} (refusing to "
            "deserialize corrupt bytes): " + "; ".join(mismatches[:8]))


def quarantine_checkpoint(path, reason="corrupt"):
    """Rename a corrupt checkpoint and its sidecars to ``<ckpt>.corrupt``
    (numbered on collision). Returns the new path, or None when nothing
    was moved."""
    path = str(path)
    if not os.path.exists(path):
        return None
    target = path + ".corrupt"
    n = 0
    while os.path.exists(target):
        n += 1
        target = f"{path}.corrupt{n}"
    sidecars = sidecar_files(path)
    try:
        os.replace(path, target)
    except OSError as e:
        logger.error("failed to quarantine corrupt checkpoint %s: %s", path, e)
        return None
    suffix = target[len(path):]
    for sidecar in sidecars:
        try:
            os.replace(sidecar, path + suffix + sidecar[len(path):])
        except OSError as e:
            logger.warning("quarantine left the sidecar %s: %s", sidecar, e)
    logger.error("quarantined corrupt checkpoint %s -> %s (%s)", path, target, reason)
    return target
