"""Contiguous-substring check (reference circuits/utils/substring_check.circom).

The circom template packs bytes into field polynomials to make the check
cheap in R1CS (substring_check.circom:45-67); in straight-line tensor code
the direct windowed byte comparison is exact (one vectorized compare over
all offsets). Semantics are identical: the match offset must lie in
[0, mainLen - subLen], and the gadget *requires* subLen <= mainLen and
byte-string inputs (substring_check.circom:32-38)."""

from __future__ import annotations

import torch

from .bytesops import is_byte_string


def substring_check(main, main_len, sub):
    """main: (..., maxMainLen) bytes, main_len: (...,), sub: (..., subLen).

    Returns (found, ok): found=1 iff sub occurs in main[0:main_len];
    ok = the gadget's own assertions (byte strings, subLen <= mainLen <= max).
    """
    max_main, sub_len = main.shape[-1], sub.shape[-1]
    assert sub_len <= 31
    ok = is_byte_string(sub) & is_byte_string(main) & (main_len <= max_main) & (sub_len <= main_len)
    windows = main.unfold(-1, sub_len, 1)  # (..., n_off, sub_len): main[i:i+sub_len]
    matches = (windows == sub[..., None, :]).all(-1)
    allowed = torch.arange(windows.shape[-2], device=main.device) <= (main_len - sub_len)[..., None]
    return (matches & allowed).any(-1).to(torch.int32), ok
