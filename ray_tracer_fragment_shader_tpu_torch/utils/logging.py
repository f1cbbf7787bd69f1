"""Structured metrics logging (JSONL) — SURVEY.md section 5,
"Metrics / logging / observability".  The reference logs nothing but stdin
prompts; training/benchmark harnesses here emit one JSON object per step.
A copy of the JAX package's ``utils/logging.py``, which uses no framework."""
from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, IO, Optional


class JsonlLogger:
    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None,
                 flush_every: int = 1):
        self._file = open(path, "a") if path else None
        self._stream = stream
        self._flush_every = flush_every
        self._count = 0
        self._t0 = time.time()

    def log(self, record: Dict[str, Any]) -> None:
        record = dict(record)
        record.setdefault("t", round(time.time() - self._t0, 4))
        line = json.dumps(record)
        self._count += 1
        for out in (self._file, self._stream):
            if out is not None:
                out.write(line + "\n")
                if self._count % self._flush_every == 0:
                    out.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def stderr_logger() -> JsonlLogger:
    return JsonlLogger(stream=sys.stderr)
