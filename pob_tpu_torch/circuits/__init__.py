"""Circuit definitions: batched forwards for ProofOfBurn and Spend,
composing the gadget library. Each forward returns the public outputs plus a
`valid` flag, the conjunction of every in-circuit assertion, so invalid
inputs are rejected exactly like the reference's witness generator."""

from .spend import SpendConfig, spend_forward  # noqa: F401
from .proof_of_burn import PoBConfig, pob_forward  # noqa: F401
