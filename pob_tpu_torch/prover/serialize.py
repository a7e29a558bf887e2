"""Serialization compatible with the circom/snarkjs toolchain formats, byte
for byte what pob_tpu's serialize writes:

- .wtns binary witness files (version 2, 32-byte LE field elements),
- .r1cs binary constraint systems (the format `circom -c` emits and snarkjs
  consumes for Groth16 setup),
- snarkjs proof.json / public.json / verification_key.json,
- snarkjs Groth16 .zkey proving keys.

Keys reach millions of points and coefficients (the ProofOfBurn key at
domain 2^22: 12,193,895 coefficients, a 2.07 GB file), so every array is
converted with numpy in one step: limbs to bytes as 16-bit little-endian
words, coefficient records through one structured dtype, the palette to
Montgomery bytes once. A point section is window 0 of the key's packed
affine bases (K3's table: x then y, Montgomery, (0, 0) for infinity), which
is exactly the zkey's layout."""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

from ..field.ref import FQ_MOD, FR_MOD
from . import groth16, msm

_WTNS_MAGIC = b"wtns"
_R1CS_MAGIC = b"r1cs"
_ZKEY_MAGIC = b"zkey"
_R_FR = (1 << 256) % FR_MOD
_R_FQ = (1 << 256) % FQ_MOD

# one zkey coefficient: matrix, row, wire, value (c R, 16-bit LE limbs)
_COEFF = np.dtype([("m", "<u4"), ("c", "<u4"), ("s", "<u4"), ("v", "<u2", (16,))])
ZKEY_CHUNK = 1 << 20  # points per host copy of a point section


def _sec(f, sid: int, nbytes: int):
    f.write(struct.pack("<iq", sid, nbytes))


def write_wtns(path: str, witness_limbs, prime: int = FR_MOD):
    """Write a circom-format .wtns file (version 2, 32-byte LE field
    elements) from (n, 16) canonical limbs (numpy or a tensor)."""
    n8 = 32
    if torch.is_tensor(witness_limbs):
        witness_limbs = witness_limbs.cpu().numpy()
    w = np.ascontiguousarray(witness_limbs).astype("<u2")
    n = w.shape[0]
    with open(path, "wb") as f:
        f.write(_WTNS_MAGIC)
        f.write(struct.pack("<II", 2, 2))  # version, n_sections
        body1 = struct.pack("<I", n8) + prime.to_bytes(n8, "little") + struct.pack("<I", n)
        _sec(f, 1, len(body1))
        f.write(body1)
        _sec(f, 2, n * n8)
        f.write(w.tobytes())


def read_wtns(path: str):
    """Read a circom-format .wtns file -> (prime, [ints])."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != _WTNS_MAGIC:
        raise ValueError("bad wtns magic")
    _version, n_sections = struct.unpack_from("<II", data, 4)
    off, prime, n8, count, values = 12, None, 32, 0, []
    for _ in range(n_sections):
        sec_id, sec_len = struct.unpack_from("<iq", data, off)
        off += 12
        body = data[off:off + sec_len]
        off += sec_len
        if sec_id == 1:
            n8 = struct.unpack_from("<I", body, 0)[0]
            prime = int.from_bytes(body[4:4 + n8], "little")
            count = struct.unpack_from("<I", body, 4 + n8)[0]
        elif sec_id == 2:
            values = [int.from_bytes(body[i * n8:(i + 1) * n8], "little")
                      for i in range(len(body) // n8)]
    if len(values) != count:
        raise ValueError(f"wtns holds {len(values)} values, its header says {count}")
    return prime, values


def write_r1cs(path: str, cs, prime: int = FR_MOD):
    """Write a ConstraintSystem as a circom/snarkjs binary .r1cs file
    (version 1: header, constraints, wire2label). Public wires are public
    outputs (nPubOut). The constraint section is built as one array of u32
    words: per constraint and matrix a term count, then per term the wire
    and the coefficient's 8 words, a row's terms in the constraint system's
    order."""
    n8 = 32
    nw, npub, ncons = cs.num_wires, cs.num_public, cs.num_constraints
    (*mats, pal) = cs.matrices_indexed()
    pal_words = np.frombuffer(b"".join((int(c) % prime).to_bytes(n8, "little") for c in pal),
                              "<u4").reshape(-1, 8)
    counts = np.stack([np.bincount(np.asarray(rows, np.int64), minlength=ncons)[:ncons]
                       for rows, _, _ in mats], 1)  # (ncons, 3)
    starts = np.concatenate([[0], np.cumsum(1 + 9 * counts.ravel())])
    words = np.empty(int(starts[-1]), "<u4")
    words[starts[:-1]] = counts.ravel()
    for midx, (rows, cols, cidx) in enumerate(mats):
        order = np.argsort(rows, kind="stable")
        r = np.asarray(rows, np.int64)[order]
        rank = np.arange(len(r)) - np.searchsorted(r, r)
        pos = starts[:-1][r * 3 + midx] + 1 + 9 * rank
        words[pos] = np.asarray(cols)[order]
        coeff = pal_words[np.asarray(cidx, np.int64)[order]]
        for j in range(8):
            words[pos + 1 + j] = coeff[:, j]
    header = (struct.pack("<I", n8) + prime.to_bytes(n8, "little")
              + struct.pack("<IIIIQI", nw, npub, 0, nw - 1 - npub, nw, ncons))
    with open(path, "wb") as f:
        f.write(_R1CS_MAGIC)
        f.write(struct.pack("<II", 1, 3))  # version, n_sections
        _sec(f, 1, len(header))
        f.write(header)
        _sec(f, 2, words.nbytes)
        f.write(words.tobytes())
        _sec(f, 3, 8 * nw)
        f.write(np.arange(nw, dtype="<u8").tobytes())


def read_r1cs(path: str):
    """Read a circom/snarkjs .r1cs -> dict with prime, counts, and
    constraints as a list of (A, B, C) term dicts {wire: coeff}."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != _R1CS_MAGIC:
        raise ValueError("bad r1cs magic")
    _version, n_sections = struct.unpack_from("<II", data, 4)
    off, sections = 12, {}
    for _ in range(n_sections):
        sec_id, sec_len = struct.unpack_from("<iq", data, off)
        off += 12
        sections[sec_id] = data[off:off + sec_len]
        off += sec_len
    hdr = sections[1]
    n8 = struct.unpack_from("<I", hdr, 0)[0]
    prime = int.from_bytes(hdr[4:4 + n8], "little")
    nw, npubout, npubin, _nprvin, _nlabels, ncons = struct.unpack_from("<IIIIQI", hdr, 4 + n8)
    body, pos, constraints = sections[2], 0, []
    for _ in range(ncons):
        terms = []
        for _m in range(3):
            (cnt,) = struct.unpack_from("<I", body, pos)
            pos += 4
            d = {}
            for _t in range(cnt):
                (wire,) = struct.unpack_from("<I", body, pos)
                d[wire] = int.from_bytes(body[pos + 4:pos + 4 + n8], "little")
                pos += 4 + n8
            terms.append(d)
        constraints.append(tuple(terms))
    return {"prime": prime, "num_wires": nw, "num_public_out": npubout,
            "num_public_in": npubin, "num_constraints": ncons, "constraints": constraints}


def proof_to_snarkjs(proof) -> dict:
    """(A, B2, C) host affine points -> snarkjs proof.json dict."""
    a, b2, c = proof
    return {
        "pi_a": [str(a[0]), str(a[1]), "1"],
        "pi_b": [[str(b2[0][0]), str(b2[0][1])], [str(b2[1][0]), str(b2[1][1])], ["1", "0"]],
        "pi_c": [str(c[0]), str(c[1]), "1"],
        "protocol": "groth16",
        "curve": "bn128",
    }


def _enc1(p):
    return [str(p[0]), str(p[1]), "1"]


def _enc2(p):
    return [[str(p[0][0]), str(p[0][1])], [str(p[1][0]), str(p[1][1])], ["1", "0"]]


def vk_to_snarkjs(vk) -> dict:
    """VerifyingKey -> snarkjs verification_key.json dict (groth16/bn128):
    the group elements snarkjs' verifier consumes; the precomputed
    vk_alphabeta_12 is omitted."""
    return {
        "protocol": "groth16",
        "curve": "bn128",
        "nPublic": len(vk.ic) - 1,
        "vk_alpha_1": _enc1(vk.alpha1),
        "vk_beta_2": _enc2(vk.beta2),
        "vk_gamma_2": _enc2(vk.gamma2),
        "vk_delta_2": _enc2(vk.delta2),
        "IC": [_enc1(p) for p in vk.ic],
    }


def snarkjs_to_proof(d: dict):
    a = (int(d["pi_a"][0]), int(d["pi_a"][1]))
    b2 = ((int(d["pi_b"][0][0]), int(d["pi_b"][0][1])),
          (int(d["pi_b"][1][0]), int(d["pi_b"][1][1])))
    c = (int(d["pi_c"][0]), int(d["pi_c"][1]))
    return (a, b2, c)


def write_proof(path: str, proof, public_inputs):
    """proof.json at `path`, public.json beside it (`proof` -> `public`)."""
    with open(path, "w") as f:
        json.dump(proof_to_snarkjs(proof), f, indent=1)
    with open(path.replace("proof", "public"), "w") as f:
        json.dump([str(x) for x in public_inputs], f, indent=1)


def snarkjs_to_vk(d: dict):
    """snarkjs verification_key.json dict -> VerifyingKey."""

    def dec1(v):
        return (int(v[0]), int(v[1]))

    def dec2(v):
        return ((int(v[0][0]), int(v[0][1])), (int(v[1][0]), int(v[1][1])))

    return groth16.VerifyingKey(alpha1=dec1(d["vk_alpha_1"]), beta2=dec2(d["vk_beta_2"]),
                                gamma2=dec2(d["vk_gamma_2"]), delta2=dec2(d["vk_delta_2"]),
                                ic=[dec1(p) for p in d["IC"]])


# ---------------------------------------------------------------------------
# snarkjs .zkey (Groth16 proving key)
# ---------------------------------------------------------------------------
#
# Layout (zkey version 1, protocol groth16), integers LE, field elements as
# n8-byte LE Montgomery forms (R = 2^256):
#   section 1: prover type (u32 = 1)
#   section 2: n8q, q, n8r, r, nVars, nPublic, domainSize,
#              alpha1 beta1 (G1) beta2 gamma2 (G2) delta1 (G1) delta2 (G2)
#   section 3: IC            (nPublic+1 G1)
#   section 4: coefficients  u32 count, then {u32 m, u32 c, u32 s, Fr value}
#   section 5: A points      (nVars G1)
#   section 6: B1 points     (nVars G1)
#   section 7: B2 points     (nVars G2)
#   section 8: C points      (nVars - nPublic - 1 G1)
#   section 9: H points      (domainSize G1, coset-Lagrange basis)
#   section 10: contributions (empty)


class ZkeyFormatError(ValueError):
    """A .zkey file is structurally inconsistent (truncated, wrong field
    widths, section sizes contradicting header counts). Raised instead of
    misparsing: a key built from a misread layout would give unverifiable
    proofs far from the fault."""


def _mont_bytes_fq(v: int) -> bytes:
    return (v * _R_FQ % FQ_MOD).to_bytes(32, "little")


def _g1_bytes(pt) -> bytes:
    if pt is None:
        return b"\0" * 64
    return _mont_bytes_fq(pt[0]) + _mont_bytes_fq(pt[1])


def _g2_bytes(pt) -> bytes:
    if pt is None:
        return b"\0" * 128
    (x0, x1), (y0, y1) = pt
    return b"".join(_mont_bytes_fq(v) for v in (x0, x1, y0, y1))


def _coeff_records(cs) -> np.ndarray:
    """Section 4's records for A (with the binding rows) and B, in
    snarkjs_matrices' order; each palette entry converted to c R once."""
    recs = []
    for midx, (rows, cols, cidx, pal) in enumerate(groth16._indexed_matrices(cs)[:2]):
        pal_mont = np.frombuffer(b"".join((int(c) * _R_FR % FR_MOD).to_bytes(32, "little")
                                          for c in pal), "<u2").reshape(-1, 16)
        r = np.empty(len(rows), _COEFF)
        r["m"], r["c"], r["s"] = midx, rows, cols
        r["v"] = pal_mont[np.asarray(cidx, np.int64)]
        recs.append(r)
    return np.concatenate(recs)


ZKEY_QUERIES = ((5, "a_query", "g1"), (6, "b1_query", "g1"), (7, "b2_query", "g2"),
                (8, "l_query", "g1"), (9, "h_query", "g1"))


def _point_rows(pk, q: str, group: str, start: int, stop: int) -> np.ndarray:
    """Rows [start, stop) of a query's zkey point section as packed int32
    words (16 per G1 point, 32 per G2; their LE bytes are the section's):
    window 0 of the key's affine bases on the card, msm._packed_affine of
    its Jacobian points where it has no bases."""
    if pk.bases is not None:
        return pk.bases[q][start:stop].cpu().numpy()
    pts = tuple(c[start:stop] for c in getattr(pk, q))
    return msm._packed_affine(group, pts).cpu().numpy()


def write_zkey(path: str, pk, vk, cs):
    """Write a snarkjs-format Groth16 .zkey from a key made by
    groth16.setup (or load_zkey) for `cs`. Point sections go to the file
    ZKEY_CHUNK points at a time."""
    nvars, npub, n8 = cs.num_wires, cs.num_public, 32
    coeffs = _coeff_records(cs)
    header = (struct.pack("<I", n8) + FQ_MOD.to_bytes(n8, "little")
              + struct.pack("<I", n8) + FR_MOD.to_bytes(n8, "little")
              + struct.pack("<III", nvars, npub, 1 << pk.k)
              + _g1_bytes(pk.alpha1) + _g1_bytes(pk.beta1) + _g2_bytes(pk.beta2)
              + _g2_bytes(vk.gamma2) + _g1_bytes(pk.delta1) + _g2_bytes(pk.delta2))
    with open(path, "wb") as f:
        f.write(_ZKEY_MAGIC)
        f.write(struct.pack("<II", 1, 10))
        for sid, body in ((1, struct.pack("<I", 1)), (2, header),
                          (3, b"".join(_g1_bytes(p) for p in vk.ic))):
            _sec(f, sid, len(body))
            f.write(body)
        _sec(f, 4, 4 + coeffs.nbytes)
        f.write(struct.pack("<I", len(coeffs)))
        f.write(coeffs.tobytes())
        for sid, q, group in ZKEY_QUERIES:
            m = int(getattr(pk, q)[0].shape[0])
            _sec(f, sid, m * (64 if group == "g1" else 128))
            for o in range(0, m, ZKEY_CHUNK):
                f.write(_point_rows(pk, q, group, o, min(o + ZKEY_CHUNK, m)).tobytes())
        _sec(f, 10, 0)


def read_zkey(path: str) -> dict:
    """Parse a snarkjs Groth16 .zkey -> its materials: header ints, host
    points (python ints) for the small elements, and for the big sections
    numpy uint16 limb arrays as stored (Montgomery form): points (m, 2 | 4,
    16), coefficients {matrix: (rows, wires, values (nnz, 16) = c R)}. Every
    structural inconsistency raises ZkeyFormatError."""
    data = np.fromfile(path, np.uint8)
    if data[:4].tobytes() != _ZKEY_MAGIC:
        raise ZkeyFormatError("bad zkey magic")
    if len(data) < 12:
        raise ZkeyFormatError("truncated zkey: no section table")
    _version, n_sections = struct.unpack_from("<II", data, 4)
    off, sections = 12, {}
    for _ in range(n_sections):
        if off + 12 > len(data):
            raise ZkeyFormatError("truncated zkey: section header cut short")
        sid, slen = struct.unpack_from("<iq", data, off)
        off += 12
        if slen < 0 or off + slen > len(data):
            raise ZkeyFormatError(f"truncated zkey: section {sid} claims {slen} bytes, "
                                  f"{len(data) - off} remain")
        sections[sid] = data[off:off + slen]
        off += slen
    missing = [s for s in range(1, 10) if s not in sections]
    if missing:
        raise ZkeyFormatError(f"zkey missing sections {missing}")

    if len(sections[1]) < 4:
        raise ZkeyFormatError("zkey section 1 too short")
    if struct.unpack_from("<I", sections[1], 0)[0] != 1:
        raise ZkeyFormatError("not a groth16 zkey")
    hdr = sections[2].tobytes()
    if len(hdr) < 8:
        raise ZkeyFormatError("zkey header too short")
    (n8q,) = struct.unpack_from("<I", hdr, 0)
    if n8q != 32:
        raise ZkeyFormatError(f"unsupported n8q={n8q} (expected 32)")
    q = int.from_bytes(hdr[4:36], "little")
    if len(hdr) < 40:
        raise ZkeyFormatError("zkey header too short")
    (n8r,) = struct.unpack_from("<I", hdr, 36)
    if n8r != 32:
        raise ZkeyFormatError(f"unsupported n8r={n8r} (expected 32)")
    r = int.from_bytes(hdr[40:72], "little")
    pos = 72
    if len(hdr) < pos + 12 + 3 * 64 + 3 * 128:
        raise ZkeyFormatError("zkey header too short for group elements")
    nvars, npub, domain = struct.unpack_from("<III", hdr, pos)
    pos += 12
    if q != FQ_MOD:
        raise ZkeyFormatError("zkey base-field prime is not BN254 Fq")
    if r != FR_MOD:
        raise ZkeyFormatError("zkey scalar-field prime is not BN254 Fr")

    rinv_q = pow(_R_FQ, FQ_MOD - 2, FQ_MOD)

    def fq(b):
        return int.from_bytes(b, "little") * rinv_q % FQ_MOD

    def g1(buf, i):
        x, y = fq(buf[i * 64:i * 64 + 32]), fq(buf[i * 64 + 32:i * 64 + 64])
        return None if x == 0 and y == 0 else (x, y)

    def g2(buf, i):
        v = [fq(buf[i * 128 + 32 * j:i * 128 + 32 * (j + 1)]) for j in range(4)]
        return None if all(c == 0 for c in v) else ((v[0], v[1]), (v[2], v[3]))

    pts = {}
    for name, size in (("alpha1", 64), ("beta1", 64), ("beta2", 128), ("gamma2", 128),
                       ("delta1", 64), ("delta2", 128)):
        pts[name] = (g1 if size == 64 else g2)(hdr[pos:pos + size], 0)
        pos += size

    # point sections must hold exactly the header's counts: anything else is
    # truncation or a misread layout, and reshaping to what fits would give
    # points to the wrong wires
    expected = {3: (npub + 1) * 64, 5: nvars * 64, 6: nvars * 64, 7: nvars * 128,
                8: max(0, nvars - npub - 1) * 64, 9: domain * 64}
    for sid, want in expected.items():
        if len(sections[sid]) != want:
            raise ZkeyFormatError(f"zkey section {sid} is {len(sections[sid])} bytes, header "
                                  f"counts imply {want}")
    ic_buf = sections[3].tobytes()
    ic = [g1(ic_buf, i) for i in range(len(ic_buf) // 64)]

    cb = sections[4]
    if len(cb) < 4:
        raise ZkeyFormatError("zkey coefficient section too short")
    (ncoef,) = struct.unpack_from("<I", cb, 0)
    if len(cb) != 4 + ncoef * _COEFF.itemsize:
        raise ZkeyFormatError(f"zkey coefficient section is {len(cb)} bytes, count {ncoef} "
                              f"implies {4 + ncoef * _COEFF.itemsize}")
    recs = np.frombuffer(cb, _COEFF, count=ncoef, offset=4)
    bad_m = recs["m"] > 1
    bad = bad_m | (recs["c"] >= domain + npub + 1) | (recs["s"] >= nvars)
    if bad.any():
        i = int(np.argmax(bad))
        if bad_m[i]:
            raise ZkeyFormatError(f"zkey coefficient names matrix {recs['m'][i]}")
        raise ZkeyFormatError(f"zkey coefficient out of range: row {recs['c'][i]}, wire "
                              f"{recs['s'][i]}")
    coeffs = {}
    for m in (0, 1):
        sel = recs[recs["m"] == m]
        coeffs[m] = (sel["c"], sel["s"], np.ascontiguousarray(sel["v"]))

    def limbs(sid, per_point):
        return sections[sid].view("<u2").reshape(-1, per_point, 16)

    return {"n_vars": nvars, "n_public": npub, "domain_size": domain, **pts, "ic": ic,
            "coeffs": coeffs, "a_pts": limbs(5, 2), "b1_pts": limbs(6, 2),
            "b2_pts": limbs(7, 4), "c_pts": limbs(8, 2), "h_pts": limbs(9, 2)}
