"""Pipeline-parallel Groth16 proving across device groups (the counterpart
of pob_tpu/dist/pipeline.py). The per-proof stages

    S0: witness generation      (circuit forward pass; hash-heavy)
    S1: QAP division            (sparse mat-vecs + 6 NTTs -> coset evals of h)
    S2: the five MSMs           (a/b1/b2/l/h queries . witness/h)

are pinned to disjoint device groups, and a stream of proof requests flows
through them with up to 3 proofs in flight. One host thread enqueues
S2(h[i]), S1(w[i+1]) and S0(req[i+2]) in that order each tick, and waits
only in the drain. Each stage group runs on a CUDA stream of its own (one
per device of the group), so on a virtual mesh of one card the three
stages' kernels may run side by side on that card. A handoff to
the next group is a copy on the receiving stage's stream after an event
recorded on the sending stage's stream; the host tail (finish_proof, whose
``.cpu()`` waits on an event recorded after S2) drains the oldest proof.

Each stage's constant operands (the COO matrices, the MSM point queries and
their K3 bases) are put on the stage's group once, at construction.

The MSM group can hold several devices: S2 then point-shards its MSMs over
the group's mesh (msm_sharded); with one device it runs K3 per query, the
key's plain path, as pob_tpu's single-device stage does.

The pipeline is single-controller, as pob_tpu's is: one process drives
every stage group, so it does not run on a mesh across processes."""

from __future__ import annotations

import contextlib
import secrets

import numpy as np
import torch

from .. import _build
from ..field import limb
from ..field.ref import FR_MOD
from ..prover import groth16, msm
from .mesh import Mesh, _concrete, data_mesh, in_process_group, on, send
from .msm_sharded import _pad_shard_points, msm_sharded

class Groth16Pipeline:
    """3-stage pipelined prover over a list of devices.

    devices: >= 3 devices (default: every visible card), or a Mesh that one
    process drives, partitioned [S0 | S1 | S2...]: one device each for
    witness generation and QAP division, the rest shard the MSMs. A device
    may repeat (a virtual mesh). A mesh across processes, or the default
    once a process group is up, raises ValueError.

    witness_fn: callable mapping one proof request (any argument tuple) to a
    (num_wires, 16) canonical limb array or tensor; it runs with S0's device
    and stream current (see spend_witness_stage).
    """

    def __init__(self, pk: groth16.ProvingKey, witness_fn, devices=None):
        if (isinstance(devices, Mesh) and devices.rank is not None
                or devices is None and in_process_group()):
            raise ValueError("Groth16Pipeline is single-controller: one process drives every "
                             "stage, so it does not run on a mesh across processes; give it "
                             "devices of this process")
        if isinstance(devices, Mesh):
            devices = devices.devices
        devices = [_concrete(d) for d in (data_mesh().devices if devices is None else devices)]
        if len(devices) < 3:
            raise ValueError(f"the pipeline needs at least 3 devices, got {len(devices)}")
        if len({d.type for d in devices}) > 1:
            raise ValueError("the pipeline's devices must be all cards or all the CPU")
        self.pk = pk
        self._d0, self._d1 = devices[0], devices[1]
        self._msm_devs = devices[2:]
        self._wit_fn = witness_fn
        # per stage: {device: its stream} (no stream on the CPU)
        self._streams = [
            {d: torch.cuda.Stream(d) for d in dict.fromkeys(group) if d.type == "cuda"}
            for group in ([self._d0], [self._d1], self._msm_devs)]

        # stage 1 constants: the COO matrices on d1
        self._mats1 = tuple(tuple(x.to(self._d1) for x in m) for m in pk.mats)

        # stage 2 constants: the MSM queries (and their K3 bases) on the MSM group
        ndev = len(self._msm_devs)
        self._msm_mesh = Mesh(tuple(self._msm_devs), "msm") if ndev > 1 else None
        self._q = {}
        ws = None  # the K3 bases' windows by groth16's rule, where the key's own are elsewhere
        for name, group in groth16.MSM_QUERIES:
            pts = getattr(pk, name)
            m = int(pts[0].shape[0])
            if ndev > 1:
                self._q[name] = (_pad_shard_points(pts, self._msm_mesh), m)
                continue
            d2 = self._msm_devs[0]
            pts = tuple(c.to(d2) for c in pts)
            bases = None
            if d2.type == "cuda":
                same = pk.bases is not None and pk.bases[name].device == d2
                if not same and ws is None:
                    ws = groth16.key_windows(pk, d2)
                with on(d2):
                    bases = pk.bases[name] if same else msm.affine_bases(group, pts, ws[name])
            self._q[name] = ((pts, bases), m)

    @contextlib.contextmanager
    def _stage(self, i: int):
        """Stage i's streams current, and its first device's card current."""
        with contextlib.ExitStack() as st:
            for s in self._streams[i].values():
                st.enter_context(torch.cuda.stream(s))
            st.enter_context(on(([self._d0], [self._d1], self._msm_devs)[i][0]))
            yield

    def _record(self, i: int) -> list:
        """Events recorded now on stage i's streams."""
        return [s.record_event() for s in self._streams[i].values()]

    def _handoff(self, x: torch.Tensor, src: int, dst: int, device) -> torch.Tensor:
        """A copy of x (made by stage src) on `device` for stage dst: made on
        dst's stream after an event on src's, with x kept alive for dst's
        stream."""
        if x.is_cuda:
            dst_stream = self._streams[dst][device]
            dst_stream.wait_event(self._streams[src][x.device].record_event())
            x.record_stream(dst_stream)
        with self._stage(dst):
            return send(x, device)

    def _msm_stage(self, w, h):
        """The five MSM sums of one proof (Jacobian points on the MSM
        group's first device; None for an empty query)."""
        npub = self.pk.num_public
        scalars = {"a_query": w, "b1_query": w, "b2_query": w, "l_query": w[npub + 1:],
                   "h_query": h}
        out = []
        for name, group in groth16.MSM_QUERIES:
            q, m = self._q[name]
            if not m:
                out.append(None)
            elif self._msm_mesh is not None:
                out.append(msm_sharded(self._msm_mesh, q, scalars[name]))
            else:
                pts, bases = q
                s = msm.msm_batched(group, pts, scalars[name][None], bases)
                out.append(tuple(c[0] for c in s))
        return tuple(out)

    def prove_stream(self, inputs, rs=None):
        """inputs: sequence of witness_fn argument tuples. Returns the list of
        (A, B2, C) host affine proofs in order; at steady state the three
        stage groups work on three consecutive proofs at once."""
        inputs = list(inputs)
        n = len(inputs)
        if rs is None:
            rs = [(secrets.randbelow(FR_MOD), secrets.randbelow(FR_MOD)) for _ in range(n)]
        for streams in self._streams:  # after the caller's work (the key, the inputs)
            for dev, s in streams.items():
                s.wait_stream(torch.cuda.current_stream(dev))
        d2 = self._msm_devs[0]
        wq, hq, sq, out = [], [], [], []
        for t in range(n + 3):
            if t >= 3:  # drain: oldest MSM sums -> final proof (host tail)
                sums, done, (r, s) = sq.pop(0)
                if d2.type == "cuda":
                    for ev in done:
                        torch.cuda.current_stream(d2).wait_event(ev)
                out.append(groth16.finish_proof(self.pk, sums, r, s))
            if hq:  # S2: enqueue the five MSMs
                w_m, h_m, meta = hq.pop(0)
                with self._stage(2):
                    sums = self._msm_stage(w_m, h_m)
                sq.append((sums, self._record(2), meta))
            if wq:  # S1: enqueue QAP division on d1, hand w and h to the MSM group
                w, meta = wq.pop(0)
                w_d1 = self._handoff(w, 0, 1, self._d1)
                with self._stage(1):
                    h = groth16.compute_h(self.pk.k, self._mats1, w_d1[None])[0]
                hq.append((self._handoff(w_d1, 1, 2, d2), self._handoff(h, 1, 2, d2), meta))
            if t < n:  # S0: witness generation on d0
                with self._stage(0):
                    w = self._wit_fn(*inputs[t])
                    w = torch.as_tensor(np.asarray(w, np.int32)) if not torch.is_tensor(w) else w
                    w = w.to(self._d0)
                wq.append((w, rs[t]))
        return out


def spend_witness_stage(device=None):
    """Witness stage function for the Spend circuit: maps (burn_key, balance,
    withdrawn, extra) python ints (field elements) to the (num_wires, 16)
    canonical witness on `device` (the card unless the caller asks for the
    CPU): spend_full_witness at batch 1."""
    from ..r1cs.spend_circuit import spend_full_witness

    dev = _build.resolve_device(device)

    def fn(burn_key, balance, withdrawn, extra):
        args = [limb.to_device(limb.ints_to_limbs([v]), dev)
                for v in (burn_key, balance, withdrawn, extra)]
        return spend_full_witness(*args)[0]

    return fn
