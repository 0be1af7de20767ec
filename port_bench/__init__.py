"""The benchmark of the PyTorch and CUDA port, ``triceratops_tpu_torch``.

Run one cell once from the repository root:

    python3 port_bench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>
"""
