"""dlrover_tpu_torch: the PyTorch/CUDA port of ``dlrover_tpu``.

Mirrors the JAX package's subpackage and module names, so each port module
sits at the same relative path as its reference
(``dlrover_tpu_torch/models/attention.py`` <-> ``dlrover_tpu/models/attention.py``).
The port imports ``torch`` and ``numpy`` only; every TPU (Pallas) kernel on a
ported path is a hand-written CUDA kernel for Hopper under ``ops/csrc/``,
with a plain PyTorch version beside it that CPU tensors take.

Slices ported so far:

* serving: ``serving.ServingEngine`` (continuous batching over a slotted KV
  pool) on ``models.TransformerLM``, with bucketed prefill through the
  flash-attention forward kernel (``ops/flash_attention.py``);
* training (``trainer.train_lib``), dense and MoE, with the opt-in
  kernels of the dense step and the low-bit Adam optimizers;
* the embedding plane (``embedding``) and its CTR example;
* the fault, retry and telemetry planes (``common``) and Flash Checkpoint
  (``checkpoint``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise rather than move to the CPU.
"""

__version__ = "0.1.0"
