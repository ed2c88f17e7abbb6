"""PyTorch / CUDA port of the realtime codec agent, for one NVIDIA H100.

The JAX package ``realtime_codec_agent_tpu`` is the reference; this package
keeps its module paths and public names (``agent.agent.RealtimeAgent``,
``lm.engine.DuplexLMEngine``, ``models.codec``, ``ops.*``) with PyTorch inside.
Each Pallas kernel on the realtime call's path is a hand-written CUDA kernel
under ``csrc/``, built at first use by ``ops/_cuda.py``, with a plain PyTorch
version beside it that CPU tensors take. This package never imports JAX; of
the JAX package it reuses only ``units``, ``tokenization`` and
``utils.audio_utils`` / ``utils.audio_io``, which are free of JAX.
"""

__version__ = "0.1.0"
