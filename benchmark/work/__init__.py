"""The least work of each stage, counted from the stage's inputs alone (no
window width, plan or chunk of the program's kernels), so that a share of
the roofline stays below 100% whatever a later kernel does. Every module
here with a work(ctx) is one count, found by its file's name and stored
under it; ctx is {"domain_log2", "r1cs" (harness/r1cs.py's arrays),
"witnesses" (the kept steps' (B, num_wires, 16) host tensors)}."""
