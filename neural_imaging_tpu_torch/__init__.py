"""
PyTorch/CUDA port of ``neural_imaging_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout module for module, so each port
of a function sits at the same path as its reference. It imports ``torch``,
``numpy`` and ``scipy`` only: no JAX, no PIL, no imageio and nothing of the
JAX package, because the GPU machine has none of them.

Conventions:

- Tensors are NCHW inside the port. Entry points whose JAX counterpart takes
  NHWC (``jpeg_forward``, the models' ``process``, the workflow's
  ``run_workflow*``) take NHWC and return NHWC views.
- Every entry point that creates tensors takes ``device=`` and defaults to
  ``"cuda"``; without a card it raises unless the caller asks for the CPU
  (:func:`neural_imaging_tpu_torch.utils.device.resolve_device`).
- Hand-written Hopper kernels live in ``csrc/`` and are bound in
  ``ops/hopper/``. A CUDA tensor launches the kernel or raises; only a CPU
  tensor takes the kernel's plain PyTorch version.
- Data parallelism (``parallel/``): one process a rank, each with one
  device. Under a process group every rank restores a model (``load_model``,
  ``restore``, a trainer's ``resume``) and only the primary, rank 0,
  writes files (``save_model``, the trainers' logs and snapshots).
"""
