"""PyTorch/CUDA port of the PSI-quantized serving stack.

The JAX package ``repro`` is the reference; this package holds its own
copies of everything it needs and imports neither JAX nor ``repro``.
Every Pallas kernel on the serving path has a hand-written CUDA twin under
``repro_torch/csrc`` (built at first use by ``repro_torch.kernels._build``);
a tensor on the CPU takes the kernel's plain PyTorch version instead.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  With no card and no explicit request this raises — an entry
    point never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
