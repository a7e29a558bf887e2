"""ProofOfBurn at the configuration's parameters through the program: its
constraint system and the witness step of the window (the program's input
loader, pob_r1cs_witness and assemble_witness, on the card)."""

from __future__ import annotations

from pob_tpu_torch.circuits.proof_of_burn import PoBConfig
from pob_tpu_torch.harness.inputs import batch_stack, load_pob_input, to_device
from pob_tpu_torch.r1cs.pob_circuit import build_pob_cs, pob_r1cs_witness
from pob_tpu_torch.r1cs.spend_circuit import assemble_witness

PARAMS = ("max_num_layers", "max_node_blocks", "max_header_blocks", "min_leaf_address_nibbles",
          "amount_bytes", "pow_minimum_zero_bytes", "max_intended_balance",
          "max_actual_balance")


class Circuit:
    def __init__(self, cfg: dict):
        self.pcfg = PoBConfig(**{k: cfg[k] for k in PARAMS})
        self.cs = build_pob_cs(self.pcfg)

    def witness(self, items: list, device):
        """Reference-format inputs -> (B, num_wires, 16) witness on `device`."""
        kw = to_device(batch_stack([load_pob_input(d, self.pcfg) for d in items]), device)
        return assemble_witness(self.cs, pob_r1cs_witness(self.pcfg, **kw))
