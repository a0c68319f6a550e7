"""The benchmark of the PyTorch and CUDA port (``repro_torch``): split
serving through ``SplitServingEngine.infer`` on one card. See README.md."""
