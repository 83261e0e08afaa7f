"""PyTorch/CUDA port of the conditioned-diffusion anomaly-detection system.

This package runs the cDDPM single-shot volume reconstruction and the cDDPM
train step (augmentation, loss, backward, Adam) on an NVIDIA Hopper card. It mirrors the module paths and names of the JAX package
``conditioned_diffusion_models_uad_tpu`` so each counterpart is easy to find,
but imports nothing from it (nor ``jax``/``flax``).

Layouts:

* Public functions keep the JAX package's layouts, so the two packages can be
  compared like with like: slice stacks are ``[D, H, W, 1]`` in [0, 1],
  attention qkv is ``[B, S, 3, H, D]`` and noise fields are ``[N, H, W]``.
* Inside the models, activations are NCHW tensors in ``channels_last``
  memory format. A NHWC tensor permuted to NCHW is already channels_last, so
  entering and leaving the UNet costs no copy, and cuDNN runs its NHWC
  convolutions.

Devices: entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see ``utils.device``). The three hand-written kernels
(``csrc/simplex_noise.cu``, ``csrc/attention.cu``, ``csrc/fused_norm.cu``)
launch for CUDA tensors; their plain PyTorch versions serve CPU tensors only.
"""
