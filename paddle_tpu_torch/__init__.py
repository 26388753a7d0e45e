"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

It mirrors the JAX package's module paths (``models.gpt_lm``,
``serving_llm.engine``, ``kernels`` ...) and imports neither JAX nor
anything of ``paddle_tpu``. Every kernel the JAX package wrote in Pallas
for the TPU is, once ported, a hand-written CUDA kernel for Hopper
(``csrc/``), built with ``nvcc`` at first use. Entry points run on the
GPU unless the caller passes ``device="cpu"``; on a CPU tensor each
kernel's plain PyTorch version runs instead.

Ported so far: the GPT serving path (``models.GPTLanguageModel`` and
``serving_llm.LLMEngine``) with the layer-norm and paged-attention
kernels.
"""

from .flags import get_flags, set_flags

__all__ = ["get_flags", "set_flags"]
