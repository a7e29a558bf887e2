"""Burn-key proof of work (the reference's tests/main.py:47-56): the least
key from a seeded start whose keccak(BE32(key) || BE32(reveal) || BE32(extra)
|| "EIP-7503") begins with the given number of zero bytes.

The search runs in the benchmark's copy of the repository's C++ grinder,
built with g++ at first use into benchmark/_build/ (a fixed path inside the
checkout, so later runs find it), or in plain Python where g++ is missing."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

from ..reference.keccak import keccak256

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(HERE, "native", "pow_grinder.cpp")
BUILD = os.path.join(HERE, "_build")

_lib = None


def _load():
    global _lib
    if _lib is None:
        with open(SRC, "rb") as f:
            key = hashlib.sha256(f.read()).hexdigest()[:16]
        out = os.path.join(BUILD, f"pow_grinder-{key}.so")
        if not os.path.exists(out):
            os.makedirs(BUILD, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, SRC], check=True,
                           capture_output=True)
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        lib.grind_burn_key.restype = ctypes.c_longlong
        lib.grind_burn_key.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_int, ctypes.c_longlong]
        _lib = lib
    return _lib


def digest(key: int, reveal: int, extra: int) -> bytes:
    return keccak256(key.to_bytes(32, "big") + reveal.to_bytes(32, "big")
                     + extra.to_bytes(32, "big") + b"EIP-7503")


def grind(start: int, reveal: int, extra: int, zero_bytes: int) -> int:
    try:
        lib = _load()
    except (OSError, FileNotFoundError, subprocess.CalledProcessError):
        lib = None
    if lib is not None:
        buf = ctypes.create_string_buffer(start.to_bytes(32, "big"), 32)
        if lib.grind_burn_key(buf, reveal.to_bytes(32, "big"), extra.to_bytes(32, "big"),
                              zero_bytes, 1 << 40) < 0:
            raise RuntimeError("no proof of work found")
        return int.from_bytes(buf.raw[:32], "big")
    key = start
    while digest(key, reveal, extra)[:zero_bytes] != bytes(zero_bytes):
        key += 1
    return key
