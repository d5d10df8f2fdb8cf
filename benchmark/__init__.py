"""The benchmark of the PyTorch and CUDA port (``llama_x_tpu_torch``): ``python3 -m benchmark.run``."""
