"""servebench: the serving benchmark of the PyTorch/CUDA port (``repro_torch``).

Run one cell with ``python3 servebench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; see README.md.
"""
