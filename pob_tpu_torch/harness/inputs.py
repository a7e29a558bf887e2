"""Input shaping and golden expectations.

Loads the reference-format Spend and ProofOfBurn input JSON (shape
documented at tests/main.py:160-192 of the reference) and computes the
expected public commitments on the host from the independent golden models
(the role of the reference's tests/testcases/public_commitment.py
expected_commitment)."""

from __future__ import annotations

import json

import numpy as np
import torch

from ..field import limb
from ..field.ref import FR_MOD
from ..hash.keccak_ref import keccak256
from ..hash.poseidon_ref import (
    POSEIDON_COIN_PREFIX,
    POSEIDON_NULLIFIER_PREFIX,
    poseidon2,
    poseidon3,
)
from ..utils.metrics import traced


def _load(path_or_dict) -> dict:
    if isinstance(path_or_dict, dict):
        return path_or_dict
    with open(path_or_dict) as f:
        return json.load(f)


def expected_commitment(values) -> int:
    """keccak(concat of 32-byte BE values) with the last byte dropped, as an
    Fr int (reference public_commitment.circom:18-42)."""
    msg = b"".join(int(v).to_bytes(32, "big") for v in values)
    return int.from_bytes(keccak256(msg)[:31], "big")


@traced("witness.load")
def load_spend_input(path_or_dict):
    d = _load(path_or_dict)
    return {
        "burn_key": int(d["burnKey"]),
        "balance": int(d["balance"]),
        "withdrawn": int(d["withdrawnBalance"]),
        "extra_commitment": int(d["extraCommitment"]),
    }


def spend_expected_commitment(inp: dict) -> int:
    coin = poseidon3(POSEIDON_COIN_PREFIX, inp["burn_key"], inp["balance"])
    remaining = poseidon3(
        POSEIDON_COIN_PREFIX, inp["burn_key"],
        (inp["balance"] - inp["withdrawn"]) % FR_MOD,
    )
    return expected_commitment([coin, inp["withdrawn"], remaining, inp["extra_commitment"]])


@traced("witness.load")
def load_pob_input(path_or_dict, cfg):
    """Reference-format ProofOfBurn input -> kwargs for pob_forward and
    pob_r1cs_witness as host arrays (one instance; batch_stack batches,
    to_device moves them to a device)."""
    d = _load(path_or_dict)
    layers = np.asarray(d["layers"], np.int64)
    header = np.asarray(d["blockHeader"], np.int64)
    if layers.shape != (cfg.max_num_layers, cfg.max_node_bytes):
        raise ValueError(f"layers are {layers.shape}, the config wants "
                         f"{(cfg.max_num_layers, cfg.max_node_bytes)}")
    if header.shape != (cfg.max_header_bytes,):
        raise ValueError(f"the header is {header.shape}, the config wants "
                         f"{(cfg.max_header_bytes,)}")

    def scalar(key):
        return limb.int_to_limbs(int(d[key]) % FR_MOD)

    return {
        "burn_key": scalar("burnKey"),
        "actual_balance": scalar("actualBalance"),
        "intended_balance": scalar("intendedBalance"),
        "reveal_amount": scalar("revealAmount"),
        "burn_extra_commitment": scalar("burnExtraCommitment"),
        "num_leaf_address_nibbles": np.int32(int(d["numLeafAddressNibbles"])),
        "layers": layers.astype(np.int32),
        "layer_lens": np.asarray(d["layerLens"], np.int32),
        "num_layers": np.int32(int(d["numLayers"])),
        "block_header": header.astype(np.int32),
        "block_header_len": np.int32(int(d["blockHeaderLen"])),
        "byte_security_relax": np.int32(int(d.get("byteSecurityRelax", 0))),
        "proof_extra_commitment": limb.int_to_limbs(
            int(d.get("_proofExtraCommitment", 0)) % FR_MOD),
    }


def pob_expected_commitment(path_or_dict, cfg) -> int:
    """Golden commitment recomputed on the host (mirrors
    tests/testcases/proof_of_burn.py:18-37 but derives the block root from the
    supplied header instead of hardcoding it)."""
    d = _load(path_or_dict)
    header = bytes(int(b) for b in d["blockHeader"][: int(d["blockHeaderLen"])])
    burn_key = int(d["burnKey"])
    remaining = poseidon3(POSEIDON_COIN_PREFIX, burn_key,
                          (int(d["intendedBalance"]) - int(d["revealAmount"])) % FR_MOD)
    return expected_commitment([
        int.from_bytes(keccak256(header), "big"),
        poseidon2(POSEIDON_NULLIFIER_PREFIX, burn_key),
        remaining,
        int(d["revealAmount"]),
        int(d["burnExtraCommitment"]),
        int(d.get("_proofExtraCommitment", 0)),
    ])


def widen_pob_input(d: dict, cfg) -> dict:
    """Widen a recorded input to a larger circuit config: pad unused MPT layer
    slots (dummy layerLens=256, mirroring the reference generator,
    tests/main.py:148-150) and zero-extend node/header buffers."""
    out = dict(d)
    node_bytes = cfg.max_node_bytes
    layers = [list(l) + [0] * (node_bytes - len(l)) for l in d["layers"]]
    lens = list(d["layerLens"])
    while len(layers) < cfg.max_num_layers:
        layers.append([0] * node_bytes)
        lens.append(256)
    out["layers"] = layers[: cfg.max_num_layers]
    out["layerLens"] = lens[: cfg.max_num_layers]
    header = list(d["blockHeader"])
    out["blockHeader"] = header + [0] * (cfg.max_header_bytes - len(header))
    return out


def batch_stack(instances):
    """Stack per-instance kwargs dicts into a batched kwargs dict."""
    return {k: np.stack([np.asarray(inst[k]) for inst in instances]) for k in instances[0]}


@traced("witness.load")
def to_device(kwargs: dict, device) -> dict:
    """Host kwargs (load_pob_input, batch_stack) -> int32 tensors on device."""
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(device)
            for k, v in kwargs.items()}
