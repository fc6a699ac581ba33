"""audio_sheet_retrieval_tpu_torch — the PyTorch/CUDA port of
audio_sheet_retrieval_tpu for NVIDIA Hopper GPUs.

The JAX package beside it is the reference; module names mirror it
(``audio_sheet_retrieval_tpu/X/y.py`` <-> ``audio_sheet_retrieval_tpu_torch/
X/y.py``). This package imports ``torch`` and never ``jax``, and nothing of
the JAX package: it keeps its own copies of the framework-free modules it
needs (``models.configs``, ``ops.filterbank``, ``data.pools``,
``data.iterators``, ``data.synthetic``, ``data.msmd``, ``config``,
``assets``), and reads the vendored weight files by path.

The serving path (piece identification, audio -> sheet) is ported: checkpoint
import, the twin encoders + CCA head, strip / spectrogram embedders, the
device gallery and the server. The gallery top-k and the feature-window
gather of the fullconv DB build run as hand-written CUDA kernels
(``csrc/``, built with nvcc for sm_90a on first use, see ``ops/_native.py``);
given CPU tensors their wrappers run plain PyTorch versions instead.
"""

__version__ = "0.1.0"
