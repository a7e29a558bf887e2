"""Batched Poseidon permutation on tensors (limbed Montgomery Fr).

State layout: (..., t, 16) int32 limbs in Montgomery form. Rounds run as a
Python loop (leading full rounds, partial rounds, trailing full rounds);
every field operation goes through field/limb.py, so on a CUDA tensor each
is a K1 launch. Bit-exact against hash/poseidon_ref.py."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import limb
from ..field.limb import FR
from ..field.ref import FR_MOD
from .poseidon_params import ROUNDS_F, ROUNDS_P, mds_matrix, round_constants

_R = (1 << 256) % FR_MOD


@functools.lru_cache(maxsize=None)
def _mont_consts(t: int):
    """Round constants (n_rounds, t, 16) and MDS (t, t, 16), Montgomery form."""
    n_rounds = ROUNDS_F + ROUNDS_P[t - 2]
    c = round_constants(t)
    c_mont = limb.ints_to_limbs([x * _R % FR_MOD for x in c]).reshape(n_rounds, t, limb.L)
    m = mds_matrix(t)
    m_mont = limb.ints_to_limbs(
        [m[i][j] * _R % FR_MOD for i in range(t) for j in range(t)]
    ).reshape(t, t, limb.L)
    return c_mont, m_mont


@functools.lru_cache(maxsize=None)
def _round_consts(t: int) -> tuple:
    """Per-round constant arrays (kept alive for limb.const's cache)."""
    c_mont, _ = _mont_consts(t)
    return tuple(np.ascontiguousarray(c_mont[r]) for r in range(c_mont.shape[0]))


def sigma(x):
    """(x^2, x^4, x^5) in Montgomery form."""
    x2 = limb.mont_sqr(FR, x)
    x4 = limb.mont_sqr(FR, x2)
    return x2, x4, limb.mont_mul(FR, x4, x)


def mix(state, t: int):
    """MDS mix: out[i] = sum_j M[i][j] * s[j]. state: (..., t, 16)."""
    prod = limb.mont_mul(FR, limb.const(_mont_consts(t)[1], state), state[..., None, :, :])
    acc = prod[..., 0, :]
    for j in range(1, t):
        acc = limb.add(FR, acc, prod[..., j, :])
    return acc


def round_schedule(t: int):
    """(round index, is_full) for every round of the width-t permutation."""
    half, rp = ROUNDS_F // 2, ROUNDS_P[t - 2]
    return [(r, r < half or r >= half + rp) for r in range(ROUNDS_F + rp)]


def poseidon_perm_mont(state):
    """Full Poseidon permutation. state: (..., t, 16) Montgomery limbs."""
    t = state.shape[-2]
    consts = _round_consts(t)
    for r, full in round_schedule(t):
        state = limb.add(FR, state, limb.const(consts[r], state))
        if full:
            state = sigma(state)[2]
        else:
            state = state.clone()
            state[..., 0:1, :] = sigma(state[..., 0:1, :])[2]
        state = mix(state, t)
    return state


def poseidon_limbs(inputs):
    """Poseidon of canonical limb inputs (..., n, 16) -> canonical (..., 16):
    width t = n + 1 with lane 0 set to 0 (reference tests/poseidon.py:1197)."""
    state = limb.to_mont(FR, inputs)
    state = torch.cat([torch.zeros_like(state[..., :1, :]), state], -2)
    return limb.from_mont(FR, poseidon_perm_mont(state)[..., 0, :])
