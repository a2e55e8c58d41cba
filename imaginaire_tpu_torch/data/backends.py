"""Storage backends (port of ``imaginaire_tpu/data/backends.py``).

One interface, ``getitem(key) -> np.ndarray (HWC)``, on the JAX
package's on-disk formats, so a dataset built by either package reads in
the other:

  FolderBackend : raw files under ``root/<data_type>/<sequence>/<file>.<ext>``;
  PackedBackend : one ``data.bin`` blob + ``index.json`` ({key: [offset,
                  length, ext]}) per data type, and ``all_filenames.json``
                  ({sequence: [stems]}) at the root, written by
                  ``build_packed_dataset``; a read is one ``os.pread``.

Decoding: ``npy`` through numpy; PNG through the port's own codec
(``data/png.py``); JPEG and any other image format through OpenCV,
imported only there, and an error naming the file and the codec where
OpenCV is absent. The text, pickle and video payloads of the JAX
package's video and pose datasets, and the LMDB backend, are not in the
port.
"""

from __future__ import annotations

import json
import os
import threading
from io import BytesIO

import numpy as np

from imaginaire_tpu_torch.data.png import PNG_SIGNATURE, decode_png

_JPEG_SIGNATURE = b"\xff\xd8\xff"


def _decode_with_opencv(buf, name, codec):
    try:
        import cv2  # only image formats the port does not decode need it
    except ImportError as e:
        raise ImportError(
            f"{name}: decoding {codec} needs OpenCV (cv2), which is not "
            "installed; the port decodes PNG and npy itself (store the "
            "data as PNG, or install OpenCV)") from e
    arr = cv2.imdecode(np.frombuffer(buf, dtype=np.uint8), cv2.IMREAD_UNCHANGED)
    if arr is None:
        raise ValueError(f"{name}: OpenCV failed to decode the {codec} bytes")
    if arr.ndim == 2:
        return arr[:, :, None]
    if arr.shape[2] == 3:
        return cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
    if arr.shape[2] == 4:
        return cv2.cvtColor(arr, cv2.COLOR_BGRA2RGBA)
    return arr


def decode_image(buf, ext, name="<buffer>"):
    """Bytes of one stored image -> an HWC array."""
    if ext == "npy":
        return np.load(BytesIO(buf))
    if buf.startswith(PNG_SIGNATURE):
        return decode_png(buf, name)
    codec = "JPEG" if buf.startswith(_JPEG_SIGNATURE) else f"{ext!r} images"
    return _decode_with_opencv(buf, name, codec)


class FolderBackend:
    def __init__(self, root, ext=None):
        self.root = root
        self.ext = ext

    def getitem(self, key):
        path = os.path.join(self.root, key)
        if self.ext:
            path = f"{path}.{self.ext}"
        with open(path, "rb") as f:
            buf = f.read()
        return decode_image(buf, path.rsplit(".", 1)[-1], name=path)


class LMDBBackend:
    def __init__(self, root, ext=None):
        raise NotImplementedError(
            "LMDB datasets are not in the port (ROADMAP.md); build a packed "
            "dataset with build_packed_dataset and set is_packed: True")


class PackedBackend:
    """A packed shard: ``data.bin`` + ``index.json``. Reads are
    ``os.pread`` calls on one descriptor, safe from the loader's
    threads."""

    def __init__(self, root, ext=None):
        with open(os.path.join(root, "index.json")) as f:
            self.index = json.load(f)
        self.bin_path = os.path.join(root, "data.bin")
        self.ext = ext
        self._fd = None
        self._lock = threading.Lock()

    def _descriptor(self):
        with self._lock:
            if self._fd is None:
                self._fd = os.open(self.bin_path, os.O_RDONLY)
            return self._fd

    def close(self):
        """Release the descriptor; call only once reads have stopped."""
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    def __del__(self):
        self.close()

    def getitem(self, key):
        off, length, ext = self.index[key]
        buf = os.pread(self._descriptor(), length, off)
        if len(buf) != length:
            raise OSError(f"{self.bin_path}: short read of {key!r} "
                          f"({len(buf)} of {length} bytes)")
        return decode_image(buf, ext or self.ext, name=f"{self.bin_path}:{key}")


def _walk_dataset_files(data_root, data_types, sequence_files):
    """Yield (data_type, seq, stem, ext, raw bytes) over the
    ``data_root/<data_type>/<sequence>/<file>`` tree in sorted order,
    recording {seq: [stems]} into ``sequence_files``."""
    seen = {}
    for data_type in data_types:
        type_root = os.path.join(data_root, data_type)
        for seq in sorted(os.listdir(type_root)):
            seq_dir = os.path.join(type_root, seq)
            if not os.path.isdir(seq_dir):
                continue
            for fname in sorted(os.listdir(seq_dir)):
                stem, ext = os.path.splitext(fname)
                with open(os.path.join(seq_dir, fname), "rb") as f:
                    buf = f.read()
                if stem not in seen.setdefault(seq, set()):
                    seen[seq].add(stem)
                    sequence_files.setdefault(seq, []).append(stem)
                yield data_type, seq, stem, ext.lstrip("."), buf


def build_packed_dataset(data_root, out_root, data_types):
    """Pack ``data_root/<data_type>/<sequence>/<file>`` trees into one
    blob per data type + ``all_filenames.json``."""
    os.makedirs(out_root, exist_ok=True)
    sequence_files, outs, indices = {}, {}, {}
    for data_type in data_types:
        os.makedirs(os.path.join(out_root, data_type), exist_ok=True)
        outs[data_type] = open(os.path.join(out_root, data_type, "data.bin"), "wb")
        indices[data_type] = {}
    try:
        for data_type, seq, stem, ext, buf in _walk_dataset_files(
                data_root, data_types, sequence_files):
            out = outs[data_type]
            indices[data_type][f"{seq}/{stem}"] = [out.tell(), len(buf), ext]
            out.write(buf)
    finally:
        for f in outs.values():
            f.close()
    for data_type in data_types:
        with open(os.path.join(out_root, data_type, "index.json"), "w") as f:
            json.dump(indices[data_type], f)
    with open(os.path.join(out_root, "all_filenames.json"), "w") as f:
        json.dump(sequence_files, f)
    return out_root


def create_folder_metadata(data_root, data_types):
    """Walk a raw folder tree -> {sequence: [stems]} of the first type."""
    type_root = os.path.join(data_root, data_types[0])
    sequences = {}
    for seq in sorted(os.listdir(type_root)):
        seq_dir = os.path.join(type_root, seq)
        if os.path.isdir(seq_dir):
            sequences[seq] = [os.path.splitext(f)[0] for f in sorted(os.listdir(seq_dir))]
    return sequences
