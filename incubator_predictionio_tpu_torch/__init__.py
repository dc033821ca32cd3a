"""PyTorch/CUDA port of incubator_predictionio_tpu.

The JAX package beside this one is the reference; every module here keeps
the path and public names of its counterpart there and names it in its
docstring. This package imports ``torch``, ``numpy`` and ``aiohttp`` and
never ``jax`` or any module of the JAX package: what it needs of the
reference's numpy-only modules it keeps as its own copy.

Ported so far: the recommendation engine's deploy → query path
(``templates/recommendation.py`` served by ``server/query_server.py``), with
the two retrieval kernels of ``ops/retrieval.py`` written by hand in CUDA
(``csrc/retrieval.cu``). ROADMAP.md lists what is still to come.
"""

__version__ = "0.1.0"
