"""The benchmark harness of the PyTorch and CUDA port: manifest, traffic,
the system under test, spans, the window's arithmetic and the check."""
