"""PyTorch and CUDA port of the workload layer, for NVIDIA Hopper (sm_90a).

The JAX package ``tpu_k8s_device_plugin`` is the reference this package
is held against; nothing here imports it, or JAX.  Plain tensor work is
PyTorch; every kernel the reference wrote in Pallas for the TPU is a
kernel written by hand for Hopper under ``csrc/``, built by
:mod:`.build` at first use.
"""

__version__ = "0.1.0"
