"""Structured JSONL metrics logging: a copy of the JAX package's
``tpu_pillars/utils/logging.py`` (one JSON object per event, with the
seconds since the logger opened as ``"t"``)."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Optional


class JsonlLogger:
    """Append one JSON object per event; mirrors to stderr when `echo`."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self._fh: Optional[IO[str]] = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self.echo = echo
        self._t0 = time.time()

    def log(self, event: str, **fields) -> None:
        rec = {"event": event, "t": round(time.time() - self._t0, 3), **fields}
        line = json.dumps(rec, default=float)
        if self._fh:
            self._fh.write(line + "\n")
        if self.echo:
            sys.stderr.write(line + "\n")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
