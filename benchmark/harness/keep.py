"""The steps a run keeps for its check: a seeded uniform sample (a
reservoir) of the window's steps, their inputs, blinding, witness and
proofs. The witnesses go to host buffers allocated at set-up (pinned with a
card), so the check takes no device memory from the window."""

from __future__ import annotations


class Keeper:
    def __init__(self, torch, W, n: int, rng, pin: bool):
        self.slots = [torch.empty(W.shape, dtype=W.dtype, pin_memory=pin) for _ in range(n)]
        self.rng = rng
        self.kept = []

    def offer(self, i: int, items, rs, W, proofs):
        """Step i of the window (0 first): kept with probability n / (i + 1)."""
        j = i if i < len(self.slots) else self.rng.randrange(i + 1)
        if j >= len(self.slots):
            return
        self.slots[j].copy_(W, non_blocking=True)
        entry = (items, rs, self.slots[j], proofs)
        if j < len(self.kept):
            self.kept[j] = entry
        else:
            self.kept.append(entry)
