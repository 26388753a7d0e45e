"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

It mirrors the JAX package's module paths (``models.gpt_lm``,
``serving_llm.engine``, ``kernels`` ...) and imports neither JAX nor
anything of ``paddle_tpu``. Every kernel the JAX package wrote in Pallas
for the TPU is, once ported, a hand-written CUDA kernel for Hopper
(``csrc/``), built with ``nvcc`` at first use. Entry points run on the
GPU unless the caller passes ``device="cpu"``; on a CPU tensor each
kernel's plain PyTorch version runs instead.

Ported so far: GPT serving (``serving_llm.LLMEngine``, in process and
over the wire), BERT pretraining (``static.TrainStep``, ``io``,
``data``), the export and ``inference.Predictor``, observability, the
lint (``analysis``), and the user entry point ``hapi.Model`` with
``metric``, the losses and ``verify``; ``ROADMAP.md`` lists the rest.
"""

from .flags import get_flags, set_flags

__all__ = ["get_flags", "set_flags"]
