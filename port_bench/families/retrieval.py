"""The retrieval models (twin VGG encoders and a CCA head,
``models/configs.py``): the corpus of synthetic pieces (``corpus.py``) and
the weights of ``weights.py``, as they were before families were named."""

from port_bench import corpus as _corpus
from port_bench import weights

corpus = _corpus.make_corpus
program_config = weights.program_config
raw_weights = weights.raw_weights
program_params = weights.program_params
