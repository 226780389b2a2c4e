"""PyTorch + CUDA port of ``chainer_speech_recognition_tpu``.

The JAX package beside this one is the reference; module names mirror it
so each counterpart is easy to find. This package imports ``torch`` and
never ``jax`` or ``flax``: the JAX-free host modules of the reference
(``constants``, ``config``, ``vocab``, ``utils/wav``, ``frontend/golden_np``,
``data/synthetic``) are imported from it, not copied.

Ported so far: the greedy serving path (wav → front-end → conv subsampler
→ BiGRU stack → logits → greedy decode) behind ``cli/decode.py``, with the
three hand-written Hopper kernels it runs in ``csrc/`` (see ``_kernels``).
"""
