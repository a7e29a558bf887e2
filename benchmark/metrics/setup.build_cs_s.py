"""setup.build_cs_s: the benchmark's span around the circuit's constraint
system build (build_pob_cs / build_spend_cs)."""


def read(rec):
    return rec.get("setup", {}).get("build_cs_s")
