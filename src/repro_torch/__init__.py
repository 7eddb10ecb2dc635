"""repro_torch — the PyTorch + CUDA port of ``repro`` (ALPT, AAAI 2023).

The JAX package ``repro`` is the reference; this package grows beside it
slice by slice and never imports it (nor ``jax``).  The first slice is
int8-resident CTR serving: table init through the hand-written ``sr_round``
kernel, row reads through ``dequant_gather`` / ``dequant_gather_packed``,
and the DCN forward in plain PyTorch.

Entry points (``training.ctr_trainer.init_state``, ``serving.ctr.CTREngine``,
``launch.serve``) run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` without a GPU raises (see :mod:`repro_torch.device`).
"""
