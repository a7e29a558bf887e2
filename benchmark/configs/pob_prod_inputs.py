"""Seeded burns for ProofOfBurn: what a user who burned ETH at a fresh burn
address would hand the prover, in the reference's input format
(tests/main.py:160-180).

Each burn has a burn key ground to the proof of work, the account's path
through a synthetic state trie of mainnet depth and node sizes (branch nodes
of 17 RLP items whose other children are random 32-byte hashes, then the
account leaf), a block header of mainnet size whose stateRoot is the trie's
root, and balances within the configuration's limits. The choices that no
public source fixes are the configuration file's "assumed" entries."""

from __future__ import annotations

import random

from ..reference.keccak import keccak256
from ..reference.poseidon import POSEIDON_BURN_ADDRESS_PREFIX, poseidon
from ..inputs.pow import grind

R_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617
EMPTY_STORAGE_ROOT = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421")
EMPTY_CODE_HASH = bytes.fromhex(
    "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
EMPTY_UNCLES_HASH = bytes.fromhex(
    "1dcc4de8dec75d7aab85b567b6ccd41ad312451b948a7413f0a142fd40d49347")


def rlp(item) -> bytes:
    """RLP of an int, bytes or a nested list of them."""
    if isinstance(item, int):
        item = b"" if item == 0 else item.to_bytes((item.bit_length() + 7) // 8, "big")
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _head(0x80, len(item)) + item
    payload = b"".join(rlp(x) for x in item)
    return _head(0xC0, len(payload)) + payload


def _head(base: int, n: int) -> bytes:
    if n <= 55:
        return bytes([base + n])
    ln = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([base + 55 + len(ln)]) + ln


def hex_prefix_leaf(nibbles) -> bytes:
    """Hex-prefix encoding of a leaf's key nibbles."""
    if len(nibbles) % 2:
        out = [0x30 | nibbles[0]]
        rest = nibbles[1:]
    else:
        out = [0x20]
        rest = nibbles
    out += [(rest[i] << 4) | rest[i + 1] for i in range(0, len(rest), 2)]
    return bytes(out)


def burn_address(burn_key: int, reveal: int, extra: int) -> bytes:
    """First 20 bytes of Poseidon4(prefix, key, reveal, extra)
    (burn_address.circom:47-58)."""
    h = poseidon([POSEIDON_BURN_ADDRESS_PREFIX, burn_key, reveal, extra])
    return h.to_bytes(32, "big")[:20]


def account_path(rng: random.Random, addr_hash: bytes, balance: int, depth: int,
                 assumed: dict) -> list:
    """The trie nodes from the root to the account's leaf: depth - 1 branch
    nodes, then the leaf, which keeps the 65 - depth nibbles of the key that
    the branches did not consume."""
    nib = [n for b in addr_hash for n in (b >> 4, b & 0xF)]
    leaf = rlp([hex_prefix_leaf(nib[depth - 1:]),
                rlp([0, balance, EMPTY_STORAGE_ROOT, EMPTY_CODE_HASH])])
    nodes = [leaf]
    lo2, hi2 = assumed["second_last_branch_children"]
    lo1, hi1 = assumed["last_branch_children"]
    for level in range(depth - 2, -1, -1):
        if level == depth - 2:
            filled = rng.randint(lo1, hi1)
        elif level == depth - 3:
            filled = rng.randint(lo2, hi2)
        else:
            filled = 16
        others = rng.sample([i for i in range(16) if i != nib[level]], filled - 1)
        items = [b""] * 17
        for i in others:
            items[i] = rng.randbytes(32)
        items[nib[level]] = keccak256(nodes[0])
        nodes.insert(0, rlp(items))
    return nodes


def header(rng: random.Random, state_root: bytes, assumed: dict) -> bytes:
    """A post-Prague mainnet-shaped header: the 15 fields of tests/main.py:84-100
    and the six optional ones after them, with random hashes and mainnet-sized
    numbers."""
    lo, hi = assumed["header_extra_data_bytes"]
    return rlp([
        rng.randbytes(32), EMPTY_UNCLES_HASH, rng.randbytes(20), state_root,
        rng.randbytes(32), rng.randbytes(32), rng.randbytes(256), 0,
        rng.randint(20_000_000, 23_000_000), 36_000_000, rng.randint(10_000_000, 30_000_000),
        rng.randint(1_700_000_000, 1_800_000_000), rng.randbytes(rng.randint(lo, hi)),
        rng.randbytes(32), bytes(8), rng.randint(10**8, 10**11), rng.randbytes(32),
        rng.choice([0, 131072, 393072, 786432]), rng.randint(0, 10**8), rng.randbytes(32),
        rng.randbytes(32),
    ])


def burn(cfg: dict, rng: random.Random, depth: int) -> dict:
    """One burn at a trie of `depth` nodes, in the reference's input format."""
    a = cfg["assumed"]
    intended = rng.randint(*a["intended_balance_wei"])
    actual = min(intended + rng.randint(0, a["balance_left_over_wei"]), cfg["max_actual_balance"])
    reveal = rng.randint(0, intended)
    extra = rng.getrandbits(248)
    burn_key = grind(rng.randrange(R_MOD // 2), reveal, extra, cfg["pow_minimum_zero_bytes"])
    addr_hash = keccak256(burn_address(burn_key, reveal, extra))
    nodes = account_path(rng, addr_hash, actual, depth, a)
    hdr = header(rng, keccak256(nodes[0]), a)
    node_bytes = cfg["max_node_blocks"] * 136
    header_bytes = cfg["max_header_blocks"] * 136
    if max(map(len, nodes)) >= node_bytes or len(hdr) >= header_bytes:
        raise ValueError("a node or the header does not fit the configuration")
    layers = [list(n) + [0] * (node_bytes - len(n)) for n in nodes]
    lens = [len(n) for n in nodes]
    while len(layers) < cfg["max_num_layers"]:
        layers.append([0] * node_bytes)
        lens.append(256)  # the reference generator's dummy length (tests/main.py:148-150)
    return {
        "numLeafAddressNibbles": str(65 - depth),
        "burnKey": str(burn_key),
        "burnExtraCommitment": extra,
        "actualBalance": str(actual),
        "intendedBalance": str(intended),
        "revealAmount": str(reveal),
        "numLayers": depth,
        "layers": layers,
        "layerLens": lens,
        "blockHeader": list(hdr) + [0] * (header_bytes - len(hdr)),
        "blockHeaderLen": len(hdr),
        "byteSecurityRelax": 0,
        "_proofExtraCommitment": 0,
    }


def pool(cfg: dict, rng: random.Random, size: int) -> list:
    """`size` burns at the configuration's depths, in a seeded order."""
    depths = list(cfg["assumed"]["trie_depths"])
    depths = (depths * (-(-size // len(depths))))[:size]
    rng.shuffle(depths)
    return [burn(cfg, rng, d) for d in depths]


def fresh(item: dict, rng: random.Random) -> dict:
    """The burn with a proof_extra_commitment of its own, so that no two
    proofs share a witness."""
    return dict(item, _proofExtraCommitment=rng.randrange(R_MOD))
