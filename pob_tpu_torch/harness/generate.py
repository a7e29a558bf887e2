"""Circuit-input generation from Ethereum chain data (the role of the
reference's tests/main.py): burn-address derivation, block-header RLP
assembly, eth_getProof-shaped account proofs -> circuit input dicts.

Works offline from recorded block/proof dicts; `Eth` is a minimal JSON-RPC
client for use against a local devnet when one is available (the reference
hardcodes http://127.0.0.1:8545, tests/main.py:13)."""

from __future__ import annotations

import json
import urllib.request

from ..field.ref import FR_MOD
from ..hash.keccak_ref import keccak256
from ..hash.poseidon_params import POSEIDON_BURN_ADDRESS_PREFIX
from ..hash.poseidon_ref import poseidon4
from . import rlp_host as rlp
from .pow_grind import find_burn_key

# Mandatory header fields in RLP order (tests/main.py:84-100), then optional
# post-merge fields appended when present (tests/main.py:102-115).
HEADER_FIELDS = [
    "parentHash", "sha3Uncles", "miner", "stateRoot", "transactionsRoot",
    "receiptsRoot", "logsBloom", "difficulty", "number", "gasLimit",
    "gasUsed", "timestamp", "extraData", "mixHash", "nonce",
]
OPTIONAL_HEADER_FIELDS = [
    "baseFeePerGas", "withdrawalsRoot", "blobGasUsed", "excessBlobGas",
    "parentBeaconBlockRoot", "requestsHash",
]


def burn_address(burn_key: int, reveal: int, extra: int) -> bytes:
    """First 20 BE bytes of Poseidon4(prefix, key, reveal, extra)
    (burn_address.circom:47-58)."""
    h = poseidon4(POSEIDON_BURN_ADDRESS_PREFIX, burn_key, reveal, extra)
    return h.to_bytes(32, "big")[:20]


def _field_bytes(v) -> bytes:
    if isinstance(v, str):
        if v.startswith("0x"):
            h = v[2:]
            if h in ("", "0"):
                return b""
            if len(h) % 2:
                h = "0" + h
            return bytes.fromhex(h)
        return v.encode()
    if isinstance(v, int):
        return b"" if v == 0 else v.to_bytes((v.bit_length() + 7) // 8, "big")
    return bytes(v)


def assemble_header(block: dict) -> bytes:
    """RLP block header from an eth_getBlockByNumber-shaped dict; must satisfy
    keccak(header) == block hash."""
    fields = [_field_bytes(block[k]) for k in HEADER_FIELDS]
    for k in OPTIONAL_HEADER_FIELDS:
        if k in block and block[k] is not None:
            fields.append(_field_bytes(block[k]))
    return rlp.encode(fields)


def leaf_nibble_count(leaf: bytes) -> int:
    """numLeafAddressNibbles from the hex-prefix encoding of the MPT leaf key
    (tests/main.py:70-77)."""
    term, _ = rlp.decode(leaf)
    if term[0] & 0xF0 == 0x20:
        return 2 * len(term) - 2
    if term[0] & 0xF0 == 0x30:
        return 2 * len(term) - 1
    raise ValueError("not a leaf node (bad hex-prefix)")


def build_pob_input(
    cfg,
    burn_key: int,
    reveal: int,
    burn_extra: int,
    account_proof: list[bytes],
    balance: int,
    block: dict,
    byte_security_relax: int = 0,
    proof_extra: int = 0,
) -> dict:
    """Shape a circuit input dict (reference format, tests/main.py:160-180)."""
    header = assemble_header(block)
    if "hash" in block:
        assert keccak256(header) == _field_bytes(block["hash"]).rjust(32, b"\0"), (
            "assembled header does not hash to the block hash"
        )
    header_bytes = list(header) + [0] * (cfg.max_header_bytes - len(header))

    layers, layer_lens = [], []
    for node in account_proof:
        node = bytes(node)
        layers.append(list(node) + [0] * (cfg.max_node_bytes - len(node)))
        layer_lens.append(len(node))
    num_layers = len(layers)
    while len(layers) < cfg.max_num_layers:
        layers.append([0] * cfg.max_node_bytes)
        layer_lens.append(256)  # dummy (tests/main.py:148-150)

    return {
        "numLeafAddressNibbles": str(leaf_nibble_count(bytes(account_proof[-1]))),
        "burnKey": str(burn_key),
        "burnExtraCommitment": burn_extra,
        "actualBalance": str(balance),
        "intendedBalance": str(balance),
        "revealAmount": str(reveal),
        "numLayers": num_layers,
        "layers": layers,
        "layerLens": layer_lens,
        "blockHeader": header_bytes,
        "blockHeaderLen": len(header),
        "byteSecurityRelax": byte_security_relax,
        "_proofExtraCommitment": proof_extra,
    }


def build_spend_input(burn_key: int, balance: int, withdrawn: int, extra: int) -> dict:
    return {
        "burnKey": str(burn_key),
        "balance": str(balance),
        "withdrawnBalance": str(withdrawn),
        "extraCommitment": extra,
    }


class Eth:
    """Minimal JSON-RPC client (stdlib only) for live input generation."""

    def __init__(self, url: str = "http://127.0.0.1:8545"):
        self.url = url
        self._id = 0

    def call(self, method: str, params):
        self._id += 1
        req = urllib.request.Request(
            self.url,
            data=json.dumps(
                {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
            ).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req) as resp:
            out = json.loads(resp.read())
        if "error" in out:
            raise RuntimeError(out["error"])
        return out["result"]

    def get_block(self, number: int) -> dict:
        return self.call("eth_getBlockByNumber", [hex(number), False])

    def get_proof(self, address: str, number: int) -> dict:
        return self.call("eth_getProof", [address, [], hex(number)])


def generate_live(cfg, eth: Eth, reveal: int, burn_extra: int,
                  min_zero_bytes: int = 2):
    """Live end-to-end input generation against a devnet that already funded
    the burn address (grind key -> fetch proof + block -> shape inputs)."""
    burn_key = find_burn_key(reveal, burn_extra, min_zero_bytes)
    addr = "0x" + burn_address(burn_key, reveal, burn_extra).hex()
    number = int(eth.call("eth_blockNumber", []), 16)
    proof = eth.get_proof(addr, number)
    block = eth.get_block(number)
    nodes = [bytes.fromhex(p[2:]) for p in proof["accountProof"]]
    return build_pob_input(
        cfg, burn_key, reveal, burn_extra, nodes,
        int(proof["balance"], 16), block,
    )
