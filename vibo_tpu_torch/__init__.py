"""vibo_tpu_torch: VIBO amortized variational IRT in PyTorch for NVIDIA Hopper.

The PyTorch/CUDA counterpart of `vibo_tpu` (the JAX/TPU package, kept as the
reference it is tested against). Module layout mirrors `vibo_tpu`: `ops/`
(links, distributions, likelihood, objectives and the kernels), `models/`,
`train/`, `data/`, `parallel/` (the device mesh on torch.distributed),
`evaluation.py` and `serve.py`. Each TPU Pallas kernel on
the ported path is a hand-written CUDA kernel under `csrc/`, built with nvcc
at first use (`ops/_build.py`); on CPU tensors the wrappers run the kernels'
plain PyTorch versions.

Importing this package builds nothing and touches no device.
"""

from vibo_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
