"""Read a run's metrics back for offline analysis, the counterpart of
``mmdgan_tpu/utils/events.py`` (``read_event_file``, input_func.py:1166-1200).

``read_metrics_jsonl`` reads the JSONL stream that ``MetricWriter`` always
writes. ``read_event_file`` parses a TensorBoard event file itself, with no
TensorFlow: the TFRecord framing of ``data/tfrecord.py``, then the
``Event`` and ``Summary`` messages with the wire reader of
``metrics/graph_proto.py`` (field numbers of tensorflow/core/util/event.proto
and tensorflow/core/framework/summary.proto).
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmdgan_torch.data.tfrecord import TFRecordReader
from mmdgan_torch.metrics.graph_proto import _fields, _signed, make_ndarray, parse_tensor


def read_metrics_jsonl(path: str, keys: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """Parse a metrics.jsonl (or its directory) into {key: array}; always
    includes 'step'. A record without a key reads NaN there. Histogram
    records (``MetricWriter.histogram``) are not scalars and are skipped:
    JAX's reader raises on them (ROADMAP C10)."""
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.jsonl")
    records: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                record = json.loads(line)
                if "hist" not in record:
                    records.append(record)
    if not records:
        return {}
    if keys is None:
        keys = sorted({k for r in records for k in r if k != "time"})
    return {k: np.asarray([r.get(k, np.nan) for r in records]) for k in keys}


def _scalar(buf: bytes) -> Tuple[str, Optional[float]]:
    """(tag, value) of one Summary.Value: its simple_value (field 2), or a
    tensor (field 8) that holds one number; None for anything else."""
    tag, value = "", None
    for field, _, v in _fields(buf):
        if field == 1:
            tag = bytes(v).decode()
        elif field == 2:
            value = struct.unpack("<f", v)[0]
        elif field == 8:
            try:
                value = float(make_ndarray(parse_tensor(v)))
            except (NotImplementedError, TypeError, ValueError):
                value = None   # a histogram, an image or a string
    return tag, value


def read_event_file(event_path: str, tags: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """Scalar series of a TensorBoard event file (or the newest
    ``events.out.tfevents.*`` of a directory): {tag: [[step, value], ...]}."""
    if os.path.isdir(event_path):
        candidates = sorted(glob.glob(os.path.join(event_path, "events.out.tfevents.*")))
        if not candidates:
            raise FileNotFoundError(f"no event files in {event_path}")
        event_path = candidates[-1]
    series: Dict[str, list] = {}
    for record in TFRecordReader(event_path):
        step, values = 0, []
        for field, _, v in _fields(record):
            if field == 2:                       # Event.step
                step = _signed(v)
            elif field == 5:                     # Event.summary
                values += [_scalar(value) for f, _, value in _fields(v) if f == 1]
        for tag, value in values:
            if value is not None and (tags is None or tag in tags):
                series.setdefault(tag, []).append((step, value))
    return {k: np.asarray(v) for k, v in series.items()}
