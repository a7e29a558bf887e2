"""Circuit definitions: batched forwards for ProofOfBurn, composing the
gadget library. Each forward returns the public outputs plus a `valid` flag,
the conjunction of every in-circuit assertion, so invalid inputs are
rejected exactly like the reference's witness generator."""
