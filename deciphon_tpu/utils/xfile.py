"""File utilities: XXH3-64 content hashing and a content-addressed cache.

Reference: src/core/xfile.c:60-100 (XXH3-64 of the file's bytes) and
src/server/file.c:21-34 (file_ensure_local: skip download when the local
file's hash matches; else fetch and re-verify).  Hashes are reported to the
scheduler as *signed* 64-bit integers, matching the reference's int64
convention (e.g. test/sched.c:92).
"""

from __future__ import annotations

import os
from typing import Callable

from deciphon_tpu.utils.rc import RC, DcpError
from deciphon_tpu.utils.xxh3 import xxh3_64_file


def xxh3_64(path: str) -> int:
    """XXH3-64 of a file, returned as a signed int64."""
    value = xxh3_64_file(path)
    return value - (1 << 64) if value >= (1 << 63) else value


def ensure_local(path: str, xxh3: int, fetch: Callable[[str, int], None]) -> str:
    """Content-addressed download cache.

    If ``path`` exists and hashes to ``xxh3``, reuse it; otherwise call
    ``fetch(path, xxh3)`` and verify the result.  Mirrors file_ensure_local
    (reference: src/server/file.c:21-34).
    """
    if os.path.exists(path) and xxh3_64(path) == xxh3:
        return path
    fetch(path, xxh3)
    if xxh3_64(path) != xxh3:
        raise DcpError(RC.EIO, f"downloaded file {path} fails integrity check")
    return path
