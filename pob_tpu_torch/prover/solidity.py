"""Solidity on-chain verifier export, the port's copy of pob_tpu's
prover/solidity.py: the same source text and calldata out.

The reference deploys a Groth16 Solidity verifier on-chain through
circuitscan (its .github/workflows/circuitscan.yml:27-39, which wraps
`snarkjs zkey export solidityverifier`). Given a VerifyingKey, this module
emits a self-contained contract that checks proofs with the BN254
precompiles (EIP-196 ecAdd/ecMul at 0x06/0x07, EIP-197 pairing at 0x08),
plus the `generatecall`-style calldata encoder for driving it.

The contract checks the Groth16 verification equation

    e(-A, B) * e(alpha, beta) * e(vk_x, gamma) * e(C, delta) == 1,
    vk_x = IC[0] + sum_i input[i] * IC[i+1].

G2 coordinates are emitted in EIP-197 precompile order (imaginary limb
first: x_c1, x_c0, y_c1, y_c0); host affine G2 points are ((x_c0, x_c1),
(y_c0, y_c1)) tuples (field/ref.py). The generated source names pob_tpu's
module in its header comment, so both packages emit the same text.
"""

from __future__ import annotations

import re

from ..field.ref import FQ_MOD, FR_MOD

_HEADER = """\
// SPDX-License-Identifier: GPL-3.0
// Generated by pob_tpu.prover.solidity (Groth16 / BN254).
pragma solidity >=0.8.0 <0.9.0;

contract {name} {{
    // scalar field (Fr) and base field (Fq) moduli
    uint256 constant r = {r_mod};
    uint256 constant q = {q_mod};

    // verification key
{vk_constants}

    uint256 constant nPublic = {n_public};

    error InvalidProof();
    error PublicInputNotInField();

    /// @notice Verify a Groth16 proof.
    /// @param proof  [A.x, A.y, B.x_c1, B.x_c0, B.y_c1, B.y_c0, C.x, C.y]
    /// @param input  public signals, each < r
    function verifyProof(uint256[8] calldata proof,
                         uint256[{n_public}] calldata input)
        public view returns (bool)
    {{
        // vk_x = IC0 + sum input[i] * IC[i+1], via ecMul/ecAdd precompiles
        uint256[4] memory acc; // (accumulated point, scratch mul result)
        acc[0] = IC0x;
        acc[1] = IC0y;
        bool ok;
{ic_fold}
        // pairing input: 4 pairs of (G1, G2), G2 imaginary-first (EIP-197)
        uint256[24] memory pairs;
        // -A (negate y mod q; y == 0 encodes the point at infinity)
        pairs[0] = proof[0];
        pairs[1] = proof[1] == 0 ? 0 : q - (proof[1] % q);
        pairs[2] = proof[2];
        pairs[3] = proof[3];
        pairs[4] = proof[4];
        pairs[5] = proof[5];
        // alpha, beta
        pairs[6] = alphax;
        pairs[7] = alphay;
        pairs[8] = betax1;
        pairs[9] = betax0;
        pairs[10] = betay1;
        pairs[11] = betay0;
        // vk_x, gamma
        pairs[12] = acc[0];
        pairs[13] = acc[1];
        pairs[14] = gammax1;
        pairs[15] = gammax0;
        pairs[16] = gammay1;
        pairs[17] = gammay0;
        // C, delta
        pairs[18] = proof[6];
        pairs[19] = proof[7];
        pairs[20] = deltax1;
        pairs[21] = deltax0;
        pairs[22] = deltay1;
        pairs[23] = deltay0;
        uint256[1] memory out;
        assembly {{
            ok := staticcall(gas(), 8, pairs, 768, out, 32)
        }}
        if (!ok) revert InvalidProof();
        return out[0] == 1;
    }}
}}
"""

_IC_FOLD_STEP = """\
        if (input[{i}] >= r) revert PublicInputNotInField();
        {{
            uint256[3] memory mulIn;
            mulIn[0] = IC{j}x;
            mulIn[1] = IC{j}y;
            mulIn[2] = input[{i}];
            uint256[2] memory mulOut;
            assembly {{
                ok := staticcall(gas(), 7, mulIn, 96, mulOut, 64)
            }}
            if (!ok) revert InvalidProof();
            uint256[4] memory addIn;
            addIn[0] = acc[0];
            addIn[1] = acc[1];
            addIn[2] = mulOut[0];
            addIn[3] = mulOut[1];
            uint256[2] memory addOut;
            assembly {{
                ok := staticcall(gas(), 6, addIn, 128, addOut, 64)
            }}
            if (!ok) revert InvalidProof();
            acc[0] = addOut[0];
            acc[1] = addOut[1];
        }}
"""


def _aff1(p):
    """Host affine G1 (None = infinity) -> (x, y) uints; infinity = (0, 0)
    per EIP-196 encoding."""
    return (0, 0) if p is None else (int(p[0]) % FQ_MOD, int(p[1]) % FQ_MOD)


def _aff2(p):
    if p is None:
        return (0, 0, 0, 0)
    (x0, x1), (y0, y1) = p
    return tuple(int(v) % FQ_MOD for v in (x0, x1, y0, y1))


def vk_to_solidity(vk, contract_name: str = "Groth16Verifier") -> str:
    """VerifyingKey -> self-contained Solidity verifier source."""
    ax, ay = _aff1(vk.alpha1)
    bx0, bx1, by0, by1 = _aff2(vk.beta2)
    gx0, gx1, gy0, gy1 = _aff2(vk.gamma2)
    dx0, dx1, dy0, dy1 = _aff2(vk.delta2)
    lines = [
        f"    uint256 constant alphax = {ax};",
        f"    uint256 constant alphay = {ay};",
        f"    uint256 constant betax0 = {bx0};",
        f"    uint256 constant betax1 = {bx1};",
        f"    uint256 constant betay0 = {by0};",
        f"    uint256 constant betay1 = {by1};",
        f"    uint256 constant gammax0 = {gx0};",
        f"    uint256 constant gammax1 = {gx1};",
        f"    uint256 constant gammay0 = {gy0};",
        f"    uint256 constant gammay1 = {gy1};",
        f"    uint256 constant deltax0 = {dx0};",
        f"    uint256 constant deltax1 = {dx1};",
        f"    uint256 constant deltay0 = {dy0};",
        f"    uint256 constant deltay1 = {dy1};",
    ]
    for j, p in enumerate(vk.ic):
        x, y = _aff1(p)
        lines.append(f"    uint256 constant IC{j}x = {x};")
        lines.append(f"    uint256 constant IC{j}y = {y};")
    n_public = len(vk.ic) - 1
    fold = "".join(
        _IC_FOLD_STEP.format(i=i, j=i + 1) for i in range(n_public)
    )
    return _HEADER.format(
        name=contract_name,
        r_mod=FR_MOD,
        q_mod=FQ_MOD,
        vk_constants="\n".join(lines),
        n_public=n_public,
        ic_fold=fold.rstrip("\n"),
    )


def proof_to_calldata(proof, public_inputs) -> str:
    """(A, B2, C) affine proof + publics -> abi-style calldata string for
    verifyProof, snarkjs `generatecall` style: two bracketed hex lists
    ([proof 8 words], [input words])."""
    a, b2, c = proof
    ax, ay = _aff1(a)
    bx0, bx1, by0, by1 = _aff2(b2)
    cx, cy = _aff1(c)
    words = [ax, ay, bx1, bx0, by1, by0, cx, cy]
    hx = ['"0x%064x"' % w for w in words]
    pub = ['"0x%064x"' % (int(x) % FR_MOD) for x in public_inputs]
    return "[" + ",".join(hx) + "],[" + ",".join(pub) + "]"


_CONST_RE = re.compile(r"uint256 constant (\w+) = (\d+);")


def parse_solidity_vk(source: str):
    """Extract the embedded verification key back out of generated source
    (test/audit aid): returns a dict name -> int plus the reconstructed
    (alpha1, beta2, gamma2, delta2, ic) affine tuples."""
    consts = {m.group(1): int(m.group(2)) for m in _CONST_RE.finditer(source)}

    def g1(prefix):
        x, y = consts[prefix + "x"], consts[prefix + "y"]
        return None if (x, y) == (0, 0) else (x, y)

    def g2(prefix):
        vals = [consts[prefix + s] for s in ("x0", "x1", "y0", "y1")]
        if not any(vals):
            return None
        return ((vals[0], vals[1]), (vals[2], vals[3]))

    ic = []
    j = 0
    while f"IC{j}x" in consts:
        x, y = consts[f"IC{j}x"], consts[f"IC{j}y"]
        ic.append(None if (x, y) == (0, 0) else (x, y))
        j += 1
    return consts, (g1("alpha"), g2("beta"), g2("gamma"), g2("delta"), ic)
