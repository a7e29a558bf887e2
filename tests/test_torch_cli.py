"""The port's command line (pob_tpu_torch/cli.py) against pob_tpu's on the
CPU: verify, export-verifier, grind and gen-input (against the mocked node
of tests/test_gen_input.py) give the same return codes, output and files.
witness, setup and prove run only on the card: without one they raise
resolve_device's error before building a constraint system."""

import json
import random
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_gen_input import MockEth  # noqa: E402
from test_torch_serialize import simulated_proof  # noqa: E402

import pob_tpu.harness.pow_grind as jpg  # noqa: E402
from pob_tpu import cli as jcli  # noqa: E402
from pob_tpu.harness import generate as jgen  # noqa: E402
from pob_tpu.prover import groth16 as jg  # noqa: E402
from pob_tpu.prover import serialize as js  # noqa: E402
from pob_tpu_torch import cli as tcli  # noqa: E402
from pob_tpu_torch.field.ref import FR_MOD  # noqa: E402
from pob_tpu_torch.harness import generate as tgen  # noqa: E402
from pob_tpu_torch.prover import groth16 as tg  # noqa: E402
from pob_tpu_torch.prover import serialize as ts  # noqa: E402
from pob_tpu_torch.r1cs.builder import ConstraintSystem  # noqa: E402

torch.set_num_threads(1)
TOXIC = [random.Random(5).randrange(1, FR_MOD) for _ in range(5)]
CLIS = {"jax": jcli, "torch": tcli}


def _cs():
    cs = ConstraintSystem()  # x * y = pub0, x + y = pub1
    pub = cs.alloc_block("pub", (2,))
    cs.mark_public(2)
    x, y = (int(w) for w in cs.alloc_block("priv", (2,)))
    cs.add([(x, 1)], [(y, 1)], [(int(pub[0]), 1)])
    cs.add([(x, 1), (y, 1)], [(0, 1)], [(int(pub[1]), 1)])
    return cs


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """vk.json, a zkey, and a valid proof.json / public.json for x = 6, y = 7."""
    d = tmp_path_factory.mktemp("cli")
    cs = _cs()
    pk, vk = jg.setup_host(cs, rng=iter(TOXIC).__next__)
    jg.save_pk(str(d / "pk.npz"), pk, vk)
    tpk, tvk = tg.load_pk(str(d / "pk.npz"), device="cpu")
    ts.write_zkey(str(d / "key.zkey"), tpk, tvk, cs)
    with open(d / "vk.json", "w") as f:
        json.dump(ts.vk_to_snarkjs(tvk), f, indent=1)
    pub = [42, 13]
    ts.write_proof(str(d / "proof.json"), simulated_proof(cs, TOXIC, pub), pub)
    (d / "bad_public.json").write_text(json.dumps(["43", "13"]))
    return d


@pytest.fixture
def jax_python_grinder(monkeypatch):
    monkeypatch.setattr(jpg, "_LIB", None)
    monkeypatch.setattr(jpg, "_LIB_TRIED", True)


@pytest.mark.parametrize("public,rc", [("public.json", 0), ("bad_public.json", 1)],
                         ids=["good", "tampered"])
def test_verify_equal_jax(files, capsys, public, rc):
    argv = ["verify", "--vk", str(files / "vk.json"), "--proof", str(files / "proof.json"),
            "--public", str(files / public)]
    outs = []
    for name, cli in CLIS.items():
        assert cli.main(argv) == rc, name
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == ("OK\n" if rc == 0 else "INVALID\n")


@pytest.mark.parametrize("source", ["vk", "zkey"])
def test_export_verifier_equal_jax(files, tmp_path, capsys, source):
    outs = []
    for name, cli in CLIS.items():
        argv = ["export-verifier", f"--{source}", str(files / ("vk.json" if source == "vk"
                                                                else "key.zkey")),
                "--out", str(tmp_path / f"{name}.sol"), "--name", "PobVerifier",
                "--proof", str(files / "proof.json"), "--public", str(files / "public.json")]
        assert cli.main(argv) == 0
        outs.append(capsys.readouterr().out.replace(str(tmp_path / f"{name}.sol"), "OUT"))
    assert (tmp_path / "torch.sol").read_text() == (tmp_path / "jax.sol").read_text()
    assert outs[0] == outs[1]
    from pob_tpu_torch.prover.solidity import parse_solidity_vk

    vk = ts.snarkjs_to_vk(json.loads((files / "vk.json").read_text()))
    assert parse_solidity_vk((tmp_path / "torch.sol").read_text())[1] == (
        vk.alpha1, vk.beta2, vk.gamma2, vk.delta2, vk.ic)


def test_grind_equal_jax(jax_python_grinder, capsys):
    argv = ["grind", "--reveal", "234", "--extra", "43287974328", "--zero-bytes", "1",
            "--start", "1000"]
    outs = []
    for cli in CLIS.values():
        assert cli.main(argv) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert json.loads(outs[0])["powDigest"].startswith("00")


def test_gen_input_equal_jax(jax_python_grinder, monkeypatch, tmp_path, capsys):
    import secrets

    monkeypatch.setattr(secrets, "randbelow", lambda n: 31337)
    monkeypatch.setattr(jgen, "Eth", lambda url: MockEth())
    monkeypatch.setattr(tgen, "Eth", lambda url: MockEth())
    for name, cli in CLIS.items():
        assert cli.main(["gen-input", "--rpc", "http://mock", "--config", "test",
                         "--zero-bytes", "1", "--out", str(tmp_path / f"{name}_pob.json"),
                         "--spend-out", str(tmp_path / f"{name}_spend.json")]) == 0
    for f in ("pob", "spend"):
        assert (tmp_path / f"torch_{f}.json").read_text() == (
            tmp_path / f"jax_{f}.json").read_text()
    capsys.readouterr()


@pytest.mark.parametrize("argv", [
    ["setup", "--circuit", "spend", "--zkey", "x.zkey"],
    ["witness", "--circuit", "spend", "--input", "in.json", "--wtns", "x.wtns"],
    ["prove", "--circuit", "pob", "--input", "in.json"],
], ids=["setup", "witness", "prove"])
def test_card_commands_need_a_card(monkeypatch, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    def no_cs(*a):
        raise AssertionError("built a constraint system before checking for a card")

    monkeypatch.setattr(tcli, "_build_cs", no_cs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)


def test_help_lists_the_subcommands(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for cmd in ("witness", "setup", "prove", "verify", "export-verifier", "grind", "gen-input"):
        assert cmd in out
