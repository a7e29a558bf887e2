"""The least work of the MSM stage of one proof: the five sums of its
Groth16 proof, from the scalars (the witness; h) and the key's points.

Each query's points at infinity (a wire absent from the query's matrices)
need no addition. A scalar of 0 needs nothing, a scalar of 1 one addition
(its point). Dense scalars (the h query, and witness values above 1) are
priced at a bucket method with signed digits at its best window width c:
ceil(255 / c) windows, in each a nonzero digit adds its point to a bucket
(all but a 2^-c share of the scalars), the 2^(c-1) buckets are summed with
2^c additions, and the windows are joined with one addition each.
Doublings between windows (c per window, on a few points) are not counted.
Bytes: the points that have to be added, read once, and the scalars."""

from __future__ import annotations

import numpy as np

from .prices import ELEMENT_BYTES, G1_ADD, G1_AFFINE_BYTES, G2_ADD, G2_AFFINE_BYTES


def dense_additions(m: int) -> int:
    """Least additions of a signed-digit bucket method over m dense scalars."""
    if m <= 0:
        return 0
    best = None
    for c in range(1, 32):
        windows = -(-255 // c)
        adds = windows * (m * (1 - 2.0 ** -c) + (1 << c)) + windows - 1
        best = adds if best is None else min(best, adds)
    return int(round(best))


def work(ctx: dict) -> dict:
    return count(ctx["domain_log2"], query_scalars(ctx["r1cs"], ctx["witnesses"]))


def query_scalars(r1cs: dict, witnesses) -> dict:
    """Per proof, averaged over the witnesses: for each witness query, its
    scalars equal to 1 and above 1 over the wires whose point is finite (a
    term in the query's matrices; the C query's private wires only)."""
    nw, npub = r1cs["num_wires"], r1cs["num_public"]
    present = {}
    for name in ("a", "b", "c"):
        mask = np.zeros(nw, bool)
        mask[np.asarray(r1cs[name][1])] = True
        present[name] = mask
    present["a"][:npub + 1] = True  # the binding rows
    l_mask = present["a"] | present["b"] | present["c"]
    l_mask[:npub + 1] = False
    masks = {"a_query": ("g1", present["a"]), "b1_query": ("g1", present["b"]),
             "b2_query": ("g2", present["b"]), "l_query": ("g1", l_mask)}
    sums = {q: [0, 0] for q in masks}
    n_proofs = 0
    for W in witnesses:
        w = np.asarray(W)
        high_zero = (w[..., 1:] == 0).all(-1)
        one = high_zero & (w[..., 0] == 1)
        full = ~(high_zero & (w[..., 0] <= 1))
        for q, (_, mask) in masks.items():
            sums[q][0] += int(one[:, mask].sum())
            sums[q][1] += int(full[:, mask].sum())
        n_proofs += w.shape[0]
    return {q: (g, sums[q][0] // n_proofs, sums[q][1] // n_proofs) for q, (g, _) in masks.items()}


def count(domain_log2: int, queries: dict) -> dict:
    """queries: {name: (group "g1" or "g2", scalars equal to 1, scalars above
    1)} over the query's finite points, for the witness queries; the h
    query's 2^k dense scalars are added here."""
    ops = G1_ADD * dense_additions(1 << domain_log2)
    nbytes = (1 << domain_log2) * (G1_AFFINE_BYTES + ELEMENT_BYTES)
    for group, ones, full in queries.values():
        add, pt = (G1_ADD, G1_AFFINE_BYTES) if group == "g1" else (G2_ADD, G2_AFFINE_BYTES)
        ops += add * (ones + dense_additions(full))
        nbytes += (ones + full) * (pt + ELEMENT_BYTES)
    return {"int32_muls": ops, "bytes": nbytes}
