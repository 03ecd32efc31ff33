"""Benchmark of the PyTorch/CUDA port (`kimera_multi_tpu_torch`) on one
H100: loop-closure verification backlogs driven through `make_verifier`'s
`verify_many`. `python -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` runs one cell once and prints one JSON line.

Only `program.py` imports the port. The traffic generator, the world, the
roofline formulas and the plain reference are copies kept here, so that a
change to the port cannot move the yardstick.
"""
