"""Structured logging and a metrics sink (port of :mod:`mmtpu.utils.logging`).

The reference prints to stdout and writes loss curves to text files
(SURVEY.md §5 "Metrics / logging"); the port routes its messages through a
standard logger and offers a JSONL metrics sink that tools can tail.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional


def get_logger(name: str = "mmtpu_torch", level: int = logging.INFO) -> logging.Logger:
    """A logger with one stream handler (added once), not propagating."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s",
                                               datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class MetricsLogger:
    """Append-only JSONL metrics stream, one record per event; without a
    path it only returns the records."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")

    def log(self, **record) -> dict:
        record.setdefault("ts", time.time())
        if self._f is not None:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()
        return record

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
