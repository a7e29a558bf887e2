"""The least work of the h stage of one proof: from the witness and the two
matrices A (with the public binding rows) and B, the coset evaluations of
A.B - C over a domain of 2^k (C = A.B on the domain).

Operations, in field products: one per nonzero of A and of B (the two
mat-vecs); the pointwise product A.B on the domain and A.B on the coset;
(n/2) log2 n butterflies, one product each, for each of the six transforms
(three inverse, three forward); the three coset scalings (n products each,
the inverse transforms' 1/n folded into them). Bytes: each input read once
(a nonzero as its row, its column and its coefficient: 4 + 4 + 32 bytes;
the witness, 32 bytes a wire) and h written once (32 bytes a point)."""

from __future__ import annotations

from .prices import ELEMENT_BYTES, FIELD_MUL


def work(ctx: dict) -> dict:
    r1cs = ctx["r1cs"]
    binding = r1cs["num_public"] + 1  # A's rows that bind the public inputs
    return count(ctx["domain_log2"], len(r1cs["a"][0]) + binding, len(r1cs["b"][0]),
                 r1cs["num_wires"])


def count(domain_log2: int, nnz_a: int, nnz_b: int, num_wires: int) -> dict:
    n = 1 << domain_log2
    products = nnz_a + nnz_b + 2 * n + 6 * (n // 2) * domain_log2 + 3 * n
    nbytes = (nnz_a + nnz_b) * (8 + ELEMENT_BYTES) + num_wires * ELEMENT_BYTES + n * ELEMENT_BYTES
    return {"int32_muls": products * FIELD_MUL, "bytes": nbytes}
