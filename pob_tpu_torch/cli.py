"""Command line of the port, with the subcommands, arguments and files of
pob_tpu's cli.py (the reference's `make` pipeline plus the snarkjs stages it
delegates):

    python -m pob_tpu_torch witness --circuit spend --input in.json --wtns out.wtns
    python -m pob_tpu_torch setup   --circuit spend --zkey spend.zkey --r1cs spend.r1cs
    python -m pob_tpu_torch prove   --circuit spend --input in.json --zkey spend.zkey
    python -m pob_tpu_torch verify  --vk vk.json --proof proof.json --public public.json
    python -m pob_tpu_torch export-verifier --zkey spend.zkey --out verifier.sol
    python -m pob_tpu_torch grind   --reveal 234 --extra 43287974328 --zero-bytes 2
    python -m pob_tpu_torch gen-input --rpc http://127.0.0.1:8545 --out input.json

witness, setup and prove run on the CUDA card and fail at once without one
(there is no CPU fallback); verify, export-verifier, grind and gen-input run
on the host."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import _build


def _pob_config(name: str):
    from .circuits.proof_of_burn import PROD_CONFIG, TEST_CONFIG

    return {"test": TEST_CONFIG, "prod": PROD_CONFIG}[name]


def _build_cs(circuit: str, config: str):
    if circuit == "spend":
        from .r1cs.spend_circuit import build_spend_cs

        return build_spend_cs()
    from .r1cs.pob_circuit import build_pob_cs

    return build_pob_cs(_pob_config(config))


def _witness_limbs(circuit: str, config: str, input_path: str, cs, device):
    """One instance's witness on `device`: (num_wires, 16) canonical limbs."""
    from .field import limb
    from .r1cs.spend_circuit import assemble_witness

    if circuit == "spend":
        from .harness.inputs import load_spend_input
        from .r1cs.spend_circuit import spend_full_witness

        inp = load_spend_input(input_path)
        args = [limb.to_device(limb.ints_to_limbs([inp[k]]), device)
                for k in ("burn_key", "balance", "withdrawn", "extra_commitment")]
        return spend_full_witness(*args)[0]

    from .harness.inputs import batch_stack, load_pob_input, to_device
    from .r1cs.pob_circuit import pob_r1cs_witness

    cfg = _pob_config(config)
    kw = to_device(batch_stack([load_pob_input(input_path, cfg)]), device)
    return assemble_witness(cs, pob_r1cs_witness(cfg, **kw))[0]


def cmd_witness(args):
    from .field import limb
    from .prover import serialize

    t0 = time.time()
    dev = _build.resolve_device(None)
    cs = _build_cs(args.circuit, args.config)
    w = _witness_limbs(args.circuit, args.config, args.input, cs, dev).cpu().numpy()
    ints = limb.limb_rows_to_ints(w)
    if ints[0] != 1 or not cs.check_witness(ints):
        print("witness does NOT satisfy the constraint system", file=sys.stderr)
        return 1
    serialize.write_wtns(args.wtns, w)
    print(f"wrote {args.wtns}: {cs.num_wires} wires, "
          f"{cs.num_constraints} constraints ({time.time()-t0:.1f}s)")
    return 0


def _write_vk(path, vk):
    from .prover import serialize

    with open(path, "w") as f:
        json.dump(serialize.vk_to_snarkjs(vk), f, indent=1)


def cmd_setup(args):
    from .prover import groth16, serialize

    t0 = time.time()
    dev = _build.resolve_device(None)
    cs = _build_cs(args.circuit, args.config)
    pk, vk = groth16.setup(cs, device=dev)
    serialize.write_zkey(args.zkey, pk, vk, cs)
    if args.r1cs:
        serialize.write_r1cs(args.r1cs, cs)
    if args.vk:
        _write_vk(args.vk, vk)
    print(f"setup done: domain 2^{pk.k}, {cs.num_wires} wires "
          f"-> {args.zkey} ({time.time()-t0:.1f}s)")
    return 0


def cmd_prove(args):
    from .field import limb
    from .prover import groth16, serialize

    t0 = time.time()
    dev = _build.resolve_device(None)
    cs = _build_cs(args.circuit, args.config)
    if args.zkey and os.path.exists(args.zkey):
        pk, vk = groth16.load_zkey(args.zkey, dev)
    else:
        pk, vk = groth16.setup(cs, device=dev)
        if args.zkey:
            serialize.write_zkey(args.zkey, pk, vk, cs)
    w = _witness_limbs(args.circuit, args.config, args.input, cs, dev)
    proof = groth16.prove(pk, w)
    publics = limb.limb_rows_to_ints(w[1:cs.num_public + 1].cpu().numpy())
    if not groth16.verify(vk, proof, publics):
        print("self-verification FAILED", file=sys.stderr)
        return 1
    serialize.write_proof(args.proof, proof, publics)
    if args.vk:
        _write_vk(args.vk, vk)
    print(f"proof verified; wrote {args.proof} ({time.time()-t0:.1f}s)")
    return 0


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def cmd_verify(args):
    from .prover import groth16, serialize

    vk = serialize.snarkjs_to_vk(_load_json(args.vk))
    proof = serialize.snarkjs_to_proof(_load_json(args.proof))
    publics = [int(x) for x in _load_json(args.public)]
    ok = groth16.verify(vk, proof, publics)
    print("OK" if ok else "INVALID")
    return 0 if ok else 1


def cmd_export_verifier(args):
    """Solidity verifier and calldata (`snarkjs zkey export
    solidityverifier` semantics). The vk is read from the zkey on the host."""
    from .prover import groth16, serialize
    from .prover.solidity import proof_to_calldata, vk_to_solidity

    if args.zkey:
        vk = groth16.zkey_vk(serialize.read_zkey(args.zkey))
    else:
        vk = serialize.snarkjs_to_vk(_load_json(args.vk))
    with open(args.out, "w") as f:
        f.write(vk_to_solidity(vk, args.name))
    print(f"wrote {args.out} ({len(vk.ic) - 1} public inputs)")
    if args.proof and args.public:
        proof = serialize.snarkjs_to_proof(_load_json(args.proof))
        publics = [int(x) for x in _load_json(args.public)]
        print(proof_to_calldata(proof, publics))
    return 0


def cmd_grind(args):
    from .harness.pow_grind import find_burn_key, pow_digest

    key = find_burn_key(args.reveal, args.extra, args.zero_bytes, start_key=args.start)
    digest = pow_digest(key, args.reveal, args.extra)
    print(json.dumps({"burnKey": str(key), "powDigest": digest.hex()}))
    return 0


def cmd_gen_input(args):
    from .harness import generate

    cfg = _pob_config(args.config)
    pob_inp = generate.generate_live(cfg, generate.Eth(args.rpc), args.reveal, args.extra,
                                     args.zero_bytes)
    with open(args.out, "w") as f:
        json.dump(pob_inp, f)
    if args.spend_out:
        # the Spend statement over the coin this burn mints: balance is the
        # coin's remaining balance (intendedBalance - revealAmount), nothing
        # withdrawn yet
        spend_inp = generate.build_spend_input(
            int(pob_inp["burnKey"]),
            int(pob_inp["intendedBalance"]) - int(pob_inp["revealAmount"]),
            0,
            int(pob_inp["burnExtraCommitment"]),
        )
        with open(args.spend_out, "w") as f:
            json.dump(spend_inp, f)
    print(f"wrote {args.out}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="pob_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def circuit_args(sp):
        sp.add_argument("--circuit", choices=["spend", "pob"], required=True)
        sp.add_argument("--config", choices=["test", "prod"], default="test",
                        help="PoB instantiation (main_proof_of_burn.circom:26 "
                             "prod vs testcases/proof_of_burn.py:54 test)")

    sp = sub.add_parser("witness", help="generate + check a witness, write .wtns")
    circuit_args(sp)
    sp.add_argument("--input", required=True)
    sp.add_argument("--wtns", required=True)
    sp.set_defaults(fn=cmd_witness)

    sp = sub.add_parser("setup", help="Groth16 trusted setup, write .zkey")
    circuit_args(sp)
    sp.add_argument("--zkey", required=True)
    sp.add_argument("--r1cs")
    sp.add_argument("--vk")
    sp.set_defaults(fn=cmd_setup)

    sp = sub.add_parser("prove", help="witness + Groth16 prove + self-verify")
    circuit_args(sp)
    sp.add_argument("--input", required=True)
    sp.add_argument("--zkey", help="load (or create) the proving key here")
    sp.add_argument("--proof", default="proof.json")
    sp.add_argument("--vk")
    sp.set_defaults(fn=cmd_prove)

    sp = sub.add_parser("verify", help="verify a snarkjs proof.json")
    sp.add_argument("--vk", required=True)
    sp.add_argument("--proof", required=True)
    sp.add_argument("--public", required=True)
    sp.set_defaults(fn=cmd_verify)

    sp = sub.add_parser("export-verifier", help="emit a Solidity on-chain verifier (+ calldata)")
    sp.add_argument("--zkey", help="read the vk from a .zkey")
    sp.add_argument("--vk", help="or from a snarkjs verification_key.json")
    sp.add_argument("--out", default="verifier.sol")
    sp.add_argument("--name", default="Groth16Verifier")
    sp.add_argument("--proof", help="also print calldata for this proof.json")
    sp.add_argument("--public", help="public.json for --proof")
    sp.set_defaults(fn=cmd_export_verifier)

    sp = sub.add_parser("grind", help="grind a PoW-valid burn key (native C++)")
    sp.add_argument("--reveal", type=int, default=0)
    sp.add_argument("--extra", type=int, default=0)
    sp.add_argument("--zero-bytes", type=int, default=2)
    sp.add_argument("--start", type=int, default=1)
    sp.set_defaults(fn=cmd_grind)

    sp = sub.add_parser("gen-input", help="build circuit inputs from a live node")
    sp.add_argument("--rpc", default="http://127.0.0.1:8545")
    sp.add_argument("--config", choices=["test", "prod"], default="test")
    sp.add_argument("--reveal", type=int, default=234)
    sp.add_argument("--extra", type=int, default=43287974328)
    sp.add_argument("--zero-bytes", type=int, default=2)
    sp.add_argument("--out", default="input.json")
    sp.add_argument("--spend-out")
    sp.set_defaults(fn=cmd_gen_input)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
