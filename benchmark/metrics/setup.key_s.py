"""setup.key_s: groth16.setup's own synchronized parts: scalars_s + k4_s +
bases_s + plan_s."""


def read(rec):
    st = rec.get("setup", {})
    parts = [st.get(k) for k in ("scalars_s", "k4_s", "bases_s", "plan_s")]
    return None if None in parts else sum(parts)
