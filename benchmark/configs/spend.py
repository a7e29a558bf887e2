"""Spend(31) through the program: its constraint system and the witness
step of the window (the program's input loader, spend_witness and
assemble_witness, on the card)."""

from __future__ import annotations

from pob_tpu_torch.field import limb
from pob_tpu_torch.harness.inputs import load_spend_input
from pob_tpu_torch.r1cs.spend_circuit import assemble_witness, build_spend_cs, spend_witness

ARGS = ("burn_key", "balance", "withdrawn", "extra_commitment")


class Circuit:
    def __init__(self, cfg: dict):
        if cfg["max_amount_bytes"] != 31:
            raise ValueError("the program's Spend circuit is Spend(31)")
        self.cs = build_spend_cs()

    def witness(self, items: list, device):
        """Reference-format inputs -> (B, num_wires, 16) witness on `device`."""
        inps = [load_spend_input(d) for d in items]
        args = [limb.to_device(limb.ints_to_limbs([inp[k] for inp in inps]), device)
                for k in ARGS]
        return assemble_witness(self.cs, spend_witness(*args))
