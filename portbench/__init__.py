"""The port's benchmark: one command runs one cell once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See README.md beside this file.
"""
