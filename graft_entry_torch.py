"""Entry point of the PyTorch / CUDA port (pob_tpu_torch), beside
__graft_entry__.py for the JAX package.

- entry(): the flagship forward step on the card: a batch-2 ProofOfBurn
  forward (witness checks and public commitment) at TEST_CONFIG from the
  fixture tests/fixtures/pob_input.json. Returns (fn, args); fn(*args) gives
  (commitment limbs (2, 16), valid (2,)).

The multi-device dry run of __graft_entry__.py has no counterpart yet: the
port has no multi-device path yet."""

import json
import os


def entry(device=None):
    """(fn, example_args) for the batch-2 PoB forward on `device` (the card
    unless the caller asks for the CPU)."""
    from pob_tpu_torch import _build
    from pob_tpu_torch.circuits.proof_of_burn import TEST_CONFIG, pob_forward
    from pob_tpu_torch.harness.inputs import batch_stack, load_pob_input, to_device

    dev = _build.resolve_device(device)
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                       "pob_input.json")
    with open(fix) as f:
        inp = load_pob_input(json.load(f), TEST_CONFIG)
    kwargs = to_device(batch_stack([inp] * 2), dev)
    keys = sorted(kwargs)

    def fn(*arrs):
        out = pob_forward(TEST_CONFIG, **dict(zip(keys, arrs)))
        return out["commitment"], out["valid"]

    return fn, tuple(kwargs[k] for k in keys)
