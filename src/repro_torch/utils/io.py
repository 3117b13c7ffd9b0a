"""Crash-consistent file writes: a temp file in the same directory, then
``os.replace`` (atomic on POSIX), so a reader sees the old complete file
or the new complete one, never a part."""
from __future__ import annotations

import json
import os
from typing import Any


def atomic_write_json(path: str, obj: Any, *, indent: int = 1) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=indent)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path
