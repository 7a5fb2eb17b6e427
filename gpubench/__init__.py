"""The benchmark of the PyTorch and CUDA port (``tpu_k8s_device_plugin_torch``).

One run of one cell::

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repo root names the cells; each cell's model
configuration, traffic mix, correctness limits and per-layer metric
readers are files of their own under this folder, found by name
(``spec.py``).  Nothing here imports JAX or the JAX package, and the
plain reference under ``reference/`` imports nothing of the port.
"""
