"""The Groth16 proof that a witness must get, worked out from the toxic waste.

The benchmark draws the toxic waste (tau, alpha, beta, gamma, delta) and each
proof's blinding (r, s) from the seed and hands them to the program's setup
and prove. Knowing them, every point of the proof is a known multiple of a
generator, so the reference needs no key, no MSM and no pairing:

    A = (alpha + a(tau) + r delta) G1
    B = (beta + b(tau) + s delta) G2,  B1 = the same scalar in G1
    C = ((sum_{i > npub} w_i (beta u_i + alpha v_i + w_i)(tau)
          + a(tau) b(tau) - c(tau)) / delta + s A + r B1 - r s delta) G1

with a(tau) = sum_i w_i u_i(tau) and u_i(tau) = sum_j A_ji L_j(tau) over the
Lagrange basis of the domain of size n (its generator the 2^k-th root of
unity 5^((r-1) / 2^28)^(2^(28-k)); A with snarkjs's npub+1 binding rows),
likewise b, c over B, C. a b - c is h(tau) t(tau) exactly when the witness
satisfies the R1CS, so a witness that breaks a constraint gets another C
than the program's quotient gives. Comparing points is exact: the limit is 0.

The R1CS (rows, columns, palette indices, palette) is the program's own
constraint system, read as plain arrays: the reference follows it from
there. Everything else (the key's scalars, the proof) it works out again."""

from __future__ import annotations

import numpy as np
import torch

from . import curve, fr

R = fr.R_MOD
TWO_ADIC_ROOT = pow(5, (R - 1) >> 28, R)


def domain_log2(num_constraints: int, num_public: int) -> int:
    k = 1
    while (1 << k) < num_constraints + num_public + 1:
        k += 1
    return k


class Shadow:
    """u, v, w and the C-query scalars of every wire at tau, on `device`.

    r1cs: {"a", "b", "c": (rows, cols, palette index) int arrays;
    "palette": python ints; "num_constraints", "num_public", "num_wires"}."""

    def __init__(self, r1cs: dict, toxic, device, nnz_chunk: int = 1 << 22):
        tau, alpha, beta, gamma, delta = toxic
        self.toxic = toxic
        m, npub, nw = r1cs["num_constraints"], r1cs["num_public"], r1cs["num_wires"]
        self.num_public, self.num_wires = npub, nw
        k = domain_log2(m, npub)
        n = 1 << k
        omega = pow(TWO_ADIC_ROOT, 1 << (28 - k), R)
        # L_j(tau) = (tau^n - 1) / n * omega^j / (tau - omega^j), Montgomery form
        pw = fr.powers_mont(omega, n, device)
        inv = fr.batch_inv_mont(fr.sub(fr.const(tau * fr.MONT_R % R, device), pw))
        c0 = (pow(tau, n, R) - 1) * pow(n, -1, R) % R
        lag = fr.mont_mul(fr.mont_mul(pw, fr.const(c0 * fr.MONT_R % R, device)),
                          inv)
        del pw, inv
        pal = torch.from_numpy(fr.to_limbs(r1cs["palette"])).to(device)
        bind = np.arange(npub + 1, dtype=np.int64)
        cols = []
        for name in ("a", "b", "c"):
            rows, wires, cidx = (np.asarray(x) for x in r1cs[name])
            if name == "a":
                rows = np.concatenate([rows, m + bind])
                wires = np.concatenate([wires, bind])
                cidx = np.concatenate([cidx, np.full(len(bind), _index_of_one(r1cs["palette"]))])
            cols.append(_column_sums(lag, pal, rows, wires, cidx, nw, nnz_chunk))
        del lag
        u, v, w = cols
        kq = fr.add(fr.add(fr.mont_mul(u, fr.const(beta * fr.MONT_R % R, device)),
                           fr.mont_mul(v, fr.const(alpha * fr.MONT_R % R, device))), w)
        kq[:npub + 1] = 0
        self.vecs = torch.stack([u, v, w, kq], 1)  # (nw, 4, 16)

    def scalars(self, witnesses: torch.Tensor) -> list:
        """(B, nw, 16) witness limbs -> B lists (a, b, c, sum of the C query)."""
        return fr.dot_many(witnesses, self.vecs)

    def expected(self, dots, r: int, s: int, blind: bool = True):
        """The proof (A, B2, C) as affine tuples for one witness's scalars.
        blind=False leaves r and s out: the control of the check."""
        _, alpha, beta, _, delta = self.toxic
        a, b, c, kq = dots
        if not blind:
            r = s = 0
        a_s = (alpha + a + r * delta) % R
        b_s = (beta + b + s * delta) % R
        c_s = ((kq + a * b - c) * pow(delta, -1, R) + s * a_s + r * b_s - r * s * delta) % R
        return (curve.g1(a_s), curve.g2(b_s), curve.g1(c_s))


def _index_of_one(palette) -> int:
    for i, c in enumerate(palette):
        if int(c) % R == 1:
            return i
    raise ValueError("the palette has no coefficient 1")


def _column_sums(lag, pal, rows, wires, cidx, nw: int, chunk: int):
    """sum over the matrix's terms of coeff * L_row(tau), by wire: (nw, 16).
    The coefficients are canonical and L in Montgomery form, so each
    Montgomery product is the plain product; the int64 limb sums of up to
    2^22 terms (below 2^38) are reduced once at the end."""
    dev = lag.device
    acc = torch.zeros(nw, fr.L, dtype=torch.int64, device=dev)
    for o in range(0, len(rows), chunk):
        r_ = torch.from_numpy(rows[o:o + chunk].astype(np.int64)).to(dev)
        w_ = torch.from_numpy(wires[o:o + chunk].astype(np.int64)).to(dev)
        c_ = torch.from_numpy(cidx[o:o + chunk].astype(np.int64)).to(dev)
        acc.index_add_(0, w_, fr.mont_mul(pal[c_], lag[r_]))
    counts = np.bincount(wires, minlength=nw) if len(wires) else np.zeros(nw)
    if counts.max(initial=0) >= 1 << 22:
        raise ValueError("a wire with 2^22 terms or more would overflow the limb sums")
    # sum S -> S / R (redc) -> S (times R^2, Montgomery product)
    back = fr.const(fr.MONT_R * fr.MONT_R % R, dev)
    out = torch.empty_like(acc)
    for o in range(0, nw, fr.CHUNK):
        out[o:o + fr.CHUNK] = fr.mont_mul(fr.redc(acc[o:o + fr.CHUNK]), back)
    return out
