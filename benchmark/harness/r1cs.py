"""The program's constraint system as the plain arrays the reference reads,
and their SHA-256, which each configuration file states as its
"r1cs_sha256" (taken once from the program's build): a change to the
circuit's builder that kept the counts but moved a term or a coefficient
would move the program and the reference together, so the check holds the
arrays themselves against the configuration."""

from __future__ import annotations

import hashlib

import numpy as np


def arrays(cs) -> dict:
    a, b, c, pal = cs.matrices_indexed()
    return {"a": a, "b": b, "c": c, "palette": [int(p) for p in pal],
            "num_constraints": cs.num_constraints, "num_public": cs.num_public,
            "num_wires": cs.num_wires}


def sha256(r1cs: dict) -> str:
    """Over the counts, each matrix's (rows, columns, palette indices) as
    little-endian int64 and each palette coefficient as 32 little-endian
    bytes: independent of the arrays' own integer types."""
    h = hashlib.sha256()
    for key in ("num_constraints", "num_wires", "num_public"):
        h.update(int(r1cs[key]).to_bytes(8, "little"))
    for name in ("a", "b", "c"):
        for arr in r1cs[name]:
            arr = np.asarray(arr)
            h.update(len(arr).to_bytes(8, "little"))
            h.update(np.ascontiguousarray(arr, dtype="<i8").tobytes())
    h.update(len(r1cs["palette"]).to_bytes(8, "little"))
    for p in r1cs["palette"]:
        h.update(int(p).to_bytes(32, "little"))
    return h.hexdigest()
