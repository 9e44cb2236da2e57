"""XXH3-64 (seed 0): the native library's (native/xxh3.cpp) or numpy's.

The scheduler identifies .hmm / .dcp files by this hash (reference
src/core/xfile.c:60-100).  The native build is used when it loads; the
numpy version computes the same value, block by block for long inputs.
"""

from __future__ import annotations

import ctypes

import numpy as np

_M64 = (1 << 64) - 1
P32_1, P32_2, P32_3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
P64_1, P64_2, P64_3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
P64_4, P64_5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
PMX_1, PMX_2 = 0x165667919E3779F9, 0x9FB21C651E98DF25

SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e"
)


def _r64(b: bytes, off: int) -> int:
    return int.from_bytes(b[off : off + 8], "little")


def _r32(b: bytes, off: int) -> int:
    return int.from_bytes(b[off : off + 4], "little")


def _fold64(a: int, b: int) -> int:
    p = a * b
    return (p & _M64) ^ (p >> 64)


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * PMX_1) & _M64
    return h ^ (h >> 32)


def _avalanche64(h: int) -> int:
    h ^= h >> 33
    h = (h * P64_2) & _M64
    h ^= h >> 29
    h = (h * P64_3) & _M64
    return h ^ (h >> 32)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _mix16(d: bytes, off: int, soff: int) -> int:
    return _fold64(_r64(d, off) ^ _r64(SECRET, soff),
                   _r64(d, off + 8) ^ _r64(SECRET, soff + 8))


def _short(d: bytes) -> int:
    n = len(d)
    s = SECRET
    if n == 0:
        return _avalanche64(_r64(s, 56) ^ _r64(s, 64))
    if n <= 3:
        c = (d[0] << 16) | (d[n >> 1] << 24) | d[n - 1] | (n << 8)
        return _avalanche64(c ^ (_r32(s, 0) ^ _r32(s, 4)))
    if n <= 8:
        v = _r32(d, n - 4) + (_r32(d, 0) << 32)
        h = v ^ (_r64(s, 8) ^ _r64(s, 16))
        h ^= _rotl(h, 49) ^ _rotl(h, 24)
        h = (h * PMX_2) & _M64
        h ^= (h >> 35) + n
        h = (h * PMX_2) & _M64
        return h ^ (h >> 28)
    if n <= 16:
        lo = _r64(d, 0) ^ (_r64(s, 24) ^ _r64(s, 32))
        hi = _r64(d, n - 8) ^ (_r64(s, 40) ^ _r64(s, 48))
        swapped = int.from_bytes(lo.to_bytes(8, "little"), "big")
        return _avalanche((n + swapped + hi + _fold64(lo, hi)) & _M64)
    if n <= 128:
        acc = n * P64_1
        pairs = [(0, 0), (n - 16, 16)]
        if n > 32:
            pairs += [(16, 32), (n - 32, 48)]
        if n > 64:
            pairs += [(32, 64), (n - 48, 80)]
        if n > 96:
            pairs += [(48, 96), (n - 64, 112)]
        for off, soff in pairs:
            acc += _mix16(d, off, soff)
        return _avalanche(acc & _M64)
    acc = n * P64_1
    for i in range(8):
        acc += _mix16(d, 16 * i, 16 * i)
    acc = _avalanche(acc & _M64)
    end = _mix16(d, n - 16, 136 - 17)
    for i in range(8, n // 16):
        end += _mix16(d, 16 * i, 16 * (i - 8) + 3)
    return _avalanche((acc + end) & _M64)


def _stripes(acc: np.ndarray, data: np.ndarray, keys: np.ndarray) -> None:
    """acc += the summed 512-bit accumulations of stripes ``data`` [n, 8]
    with secret words ``keys`` [n, 8] (addition mod 2**64 commutes, so
    a block's stripes reduce in any order)."""
    k = data ^ keys
    prod = (k & np.uint64(0xFFFFFFFF)) * (k >> np.uint64(32))
    acc += prod.sum(axis=0, dtype=np.uint64)
    acc += data[:, [1, 0, 3, 2, 5, 4, 7, 6]].sum(axis=0, dtype=np.uint64)


def _long(d: bytes) -> int:
    n = len(d)
    words = np.frombuffer(SECRET[: 8 * 24], "<u8")
    per_block = (len(SECRET) - 64) // 8  # 16 stripes of 64 bytes
    block_len = 64 * per_block
    nblocks = (n - 1) // block_len
    keys = np.stack([words[s : s + 8] for s in range(per_block)])
    scr = [int(x) for x in np.frombuffer(SECRET[-64:], "<u8")]
    acc = np.array([P32_3, P64_1, P64_2, P64_3, P64_4, P32_2, P64_5, P32_1],
                   np.uint64)
    data = np.frombuffer(d, "<u8", count=nblocks * block_len // 8)
    data = data.reshape(nblocks, per_block, 8)
    with np.errstate(over="ignore"):
        k = data ^ keys[None]
        prod = ((k & np.uint64(0xFFFFFFFF)) * (k >> np.uint64(32))).sum(
            axis=1, dtype=np.uint64)
        swap = data[:, :, [1, 0, 3, 2, 5, 4, 7, 6]].sum(axis=1, dtype=np.uint64)
        contrib = [[int(x) for x in row] for row in prod + swap]
        a = [int(x) for x in acc]
        for row in contrib:
            for i in range(8):
                v = (a[i] + row[i]) & _M64
                v ^= v >> 47
                v ^= scr[i]
                a[i] = (v * P32_1) & _M64
        acc = np.array(a, np.uint64)
        nstripes = ((n - 1) - block_len * nblocks) // 64
        tail = np.frombuffer(d, "<u8", count=nstripes * 8,
                             offset=nblocks * block_len).reshape(nstripes, 8)
        _stripes(acc, tail, keys[:nstripes])
        last = np.frombuffer(d, "<u8", count=8, offset=n - 64)[None]
        lastkey = np.frombuffer(SECRET, "<u8", count=8,
                                offset=len(SECRET) - 64 - 7)[None]
        _stripes(acc, last, lastkey)
    a = [int(x) for x in acc]
    h = n * P64_1
    for i in range(4):
        h += _fold64(a[2 * i] ^ _r64(SECRET, 11 + 16 * i),
                     a[2 * i + 1] ^ _r64(SECRET, 19 + 16 * i))
    return _avalanche(h & _M64)


def _native():
    from deciphon_tpu import native

    lib = native.load()
    return lib if lib is not None and hasattr(lib, "dcp_xxh3_64") else None


def xxh3_64_bytes(data: bytes, use_native: bool = True) -> int:
    """Unsigned XXH3-64 of ``data``."""
    data = bytes(data)
    lib = _native() if use_native else None
    if lib is not None:
        return lib.dcp_xxh3_64(data, len(data))
    return _short(data) if len(data) <= 240 else _long(data)


def xxh3_64_file(path: str, use_native: bool = True) -> int:
    """Unsigned XXH3-64 of a file's bytes."""
    lib = _native() if use_native else None
    if lib is not None:
        ok = ctypes.c_int(0)
        h = lib.dcp_xxh3_64_file(path.encode(), ctypes.byref(ok))
        if not ok.value:
            raise OSError(f"cannot read {path}")
        return h
    with open(path, "rb") as fp:
        return xxh3_64_bytes(fp.read(), use_native=False)
