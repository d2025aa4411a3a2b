"""cellbench: the benchmark of ``light_unet_tpu_torch`` on NVIDIA GPUs.

``python3 cellbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once; see ``cellbench/README.md``.
"""
