"""PSI format and model-level quantization."""
