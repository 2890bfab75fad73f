"""Benchmark of the PyTorch/CUDA tracker (``m3t_tpu_torch``) on NVIDIA GPUs.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``; see ``benchmark/README.md``.
"""
