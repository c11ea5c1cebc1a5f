"""The benchmark of ``dmnerf_tpu_torch``, the PyTorch / CUDA port: ``python3 -m benchmark.run``
runs one cell of ``BENCHMARK.json`` (see ``run.py``); ``registry.py`` says where a cell's
parts live. It measures the port only and imports neither JAX nor the JAX package."""
