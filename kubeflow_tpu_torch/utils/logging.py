"""Structured JSON logging with trace correlation: the port's copy of
kubeflow_tpu/utils/logging.py.

The reference logs through controller-runtime's zap JSON logger; the piece
that matters for observability is CORRELATION — a log line emitted inside a
reconcile must carry the ids of the live span so operators can pivot from a
log line to the exact trace timeline (and back) in one query.  This module
is that layer: a stdlib `logging.Formatter` that renders one JSON object
per line and injects `trace_id`/`span_id` from the active span context
(utils.tracing), plus a `setup_structured_logging` entrypoint `main.py`
wires behind `--log-format json`.

Extra key/values travel via ``logger.info(..., extra={"namespace": ns})``
— any non-reserved record attribute lands in the JSON object.
"""

from __future__ import annotations

import io
import json
import logging
import time
from typing import Optional

from . import tracing

# logging.LogRecord's own attributes; everything else on a record came in
# via `extra=` and belongs in the rendered object
_RESERVED = frozenset(vars(
    logging.LogRecord("", 0, "", 0, "", (), None)
)) | {"message", "asctime", "taskName"}


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts/level/logger/msg plus trace correlation
    ids from the live span (omitted when no span is active) and any
    `extra=` fields."""

    def format(self, record: logging.LogRecord) -> str:
        data: dict = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S",
                                time.gmtime(record.created))
            + ".%03dZ" % (record.msecs),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        span = tracing.current_span()
        if span.recording:
            data["trace_id"] = span.trace_id
            data["span_id"] = span.span_id
        for key, value in record.__dict__.items():
            if key not in _RESERVED and not key.startswith("_"):
                data[key] = value
        if record.exc_info and record.exc_info[0] is not None:
            data["exc"] = self.formatException(record.exc_info)
        return json.dumps(data, default=str)


def setup_structured_logging(level: int = logging.INFO,
                             stream: Optional[io.TextIOBase] = None
                             ) -> logging.Handler:
    """Install a JSON handler on the root logger (replacing existing
    handlers, as logging.basicConfig(force=True) would) and return it so
    callers/tests can detach or inspect it."""
    handler = logging.StreamHandler(stream)
    handler.setFormatter(JsonFormatter())
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    root.addHandler(handler)
    root.setLevel(level)
    return handler
