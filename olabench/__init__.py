"""The benchmark of the PyTorch and CUDA port of PF-OLA (``repro_torch``).

``python3 -m olabench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once; ``olabench.calibrate`` reads the
numbers the correctness limits are set from.  Nothing here imports JAX or
the JAX package.
"""
