"""xtts_tpu_torch — the PyTorch + CUDA (Hopper) port of xtts_tpu.

The JAX package ``xtts_tpu`` is the reference; this package mirrors its
layout module for module (``dsp/``, ``nn/``, ``models/``, ``ops/``,
``diffusion/``, ``infer/``, ``utils/``) and shares its framework-free parts
as they are: the configs (re-exported as ``xtts_tpu_torch.core.config``) and
the text frontend (``xtts_tpu.text``). It imports ``torch`` and never
``jax``.

Slice A, the zero-shot main path at B=1:

    tokens -> GPT prefix + int8 AR decode   (infer/qdecode.py, kernel K1)
           -> teacher-forced GPT latent      (models/gpt.py)
           -> AA-diffusion, 50 CFG steps     (models/aa_diffusion.py,
                                              diffusion/gaussian.py, kernel K2)
           -> Vocos + iSTFT -> 24 kHz wav    (models/vocos.py, dsp/)

Kernels are hand-written CUDA C++ for sm_90a (``csrc/``), built with nvcc at
first use into ``build/xtts_tpu_torch/`` and bound with ctypes
(``ops/build.py``). Each wrapper launches its kernel for CUDA tensors and
takes its plain PyTorch twin only for CPU tensors.
"""

__version__ = "0.1.0"
