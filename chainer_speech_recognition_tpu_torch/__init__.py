"""PyTorch + CUDA port of ``chainer_speech_recognition_tpu``.

The JAX package beside this one is the reference; module names mirror it
so each counterpart is easy to find. This package imports ``torch`` and
never ``jax``, ``flax`` or anything of the JAX package: it keeps its own
copies of the reference's JAX-free host modules (``constants``, ``config``,
``vocab``, ``utils/wav``, ``frontend/golden_np``, ``data/*``,
``decode/metrics``, ``train/metrics``), held to the originals by
``tests/test_torch_copies.py``.

Ported so far, for the ``bigru`` preset on one card: the greedy serving
path behind ``cli/decode.py`` and the training path behind ``cli/train.py``
(stream data mode), on the hand-written Hopper kernels in ``csrc/`` (see
``_kernels``).
"""
