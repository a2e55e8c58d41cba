"""Meters (port of ``imaginaire_tpu/utils/meters.py``).

``Meter.write`` buffers values (floats or tensors still on the device);
``flush`` averages them, drops non-finite values with a warning (and
records how many as ``<name>/nonfinite_count``), and writes one scalar.
The machine with the card has no TensorBoard, so scalars go to
``<logdir>/meters.jsonl`` through a ``ScalarWriter``: one JSON object a
scalar, ``{"kind": "counter", "name", "value", "step", "t"}``, the record
the JAX package's telemetry sink writes for the same scalar.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time

logger = logging.getLogger(__name__)


class ScalarWriter:
    """Appends scalar records to ``<logdir>/meters.jsonl``."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "meters.jsonl")
        self._lock = threading.Lock()

    def write(self, record):
        line = json.dumps(record, default=str) + "\n"
        with self._lock, open(self.path, "a") as f:
            f.write(line)

    def read(self):
        """Every record written so far, oldest first."""
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


def write_summary(writer, name, data, step):
    """One scalar; a None writer drops it."""
    if writer is not None:
        writer.write({"kind": "counter", "name": name, "value": float(data),
                      "step": step, "t": time.time()})


def add_hparams(writer, hparam_dict, metric_dict):
    """The run's hyper-parameters beside their metrics: one ``meta``
    record, then each metric as a scalar."""
    if not isinstance(hparam_dict, dict) or not isinstance(metric_dict, dict):
        raise TypeError("hparam_dict and metric_dict should be dictionaries.")
    if writer is None:
        return
    writer.write({"kind": "meta", "name": "hparams", "hparams": hparam_dict,
                  "metrics": metric_dict, "t": time.time()})
    for key, value in metric_dict.items():
        write_summary(writer, key, value, 0)


class Meter:
    def __init__(self, name, writer=None):
        self.name = name
        self.writer = writer
        self.values = []

    def reset(self):
        self.values = []

    def write(self, value):
        if value is not None:
            self.values.append(value)

    def flush(self, step):
        values = [float(v) for v in self.values]  # device values sync here
        finite = [v for v in values if math.isfinite(v)]
        dropped = len(values) - len(finite)
        if dropped:
            logger.warning("meter %s has %d non-finite value(s) at step %s",
                           self.name, dropped, step)
            write_summary(self.writer, f"{self.name}/nonfinite_count", dropped, step)
        if finite:
            write_summary(self.writer, self.name, sum(finite) / len(finite), step)
        self.reset()
