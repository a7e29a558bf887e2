"""Burn-key proof-of-work grinding (reference tests/main.py:47-56), the
port's copy of pob_tpu's harness/pow_grind.py: the same API and results.

The native grinder is the repo's ``native/pow_grinder.cpp``, compiled at
first use with g++ into ``build/pob_tpu_torch/pow_grinder-<source hash>/``
(ignored by git; nothing is written under ``native/``) and loaded with
ctypes. Without g++ or a loadable library, a pure-Python loop does the same
search."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import secrets
import subprocess

from .. import _build
from ..field.ref import FR_MOD
from ..hash.keccak_ref import keccak256

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                   "native", "pow_grinder.cpp")


def native_path() -> str:
    """The grinder library for the current source, compiled if missing (to
    a temporary name, then renamed, so concurrent processes never load a
    half-written file)."""
    with open(SRC, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_build.BUILD, f"pow_grinder-{key}", "libpowgrind.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, SRC], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    """The native grinder, or None where it cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(native_path())
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.grind_burn_key.restype = ctypes.c_longlong
    lib.grind_burn_key.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_int, ctypes.c_longlong]
    lib.pow_digest.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    return lib


def pow_digest(burn_key: int, reveal: int, extra: int) -> bytes:
    msg = (burn_key.to_bytes(32, "big") + reveal.to_bytes(32, "big")
           + extra.to_bytes(32, "big") + b"EIP-7503")
    return keccak256(msg)


def find_burn_key(reveal: int, extra: int, min_zero_bytes: int = 2,
                  start_key: int | None = None, max_iters: int = 1 << 40) -> int:
    """Grind burnKey upward from start_key (random if None) until
    keccak(key||reveal||extra||'EIP-7503') starts with min_zero_bytes zero
    bytes."""
    key = start_key if start_key is not None else secrets.randbelow(FR_MOD)
    lib = _lib()
    if lib is not None:
        buf = ctypes.create_string_buffer(key.to_bytes(32, "big"), 32)
        it = lib.grind_burn_key(buf, reveal.to_bytes(32, "big"), extra.to_bytes(32, "big"),
                                min_zero_bytes, max_iters)
        if it < 0:
            raise RuntimeError("PoW not found within max_iters")
        return int.from_bytes(buf.raw[:32], "big")
    for _ in range(max_iters):
        if pow_digest(key, reveal, extra)[:min_zero_bytes] == b"\x00" * min_zero_bytes:
            return key
        key += 1
    raise RuntimeError("PoW not found within max_iters")
