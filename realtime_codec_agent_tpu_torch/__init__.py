"""PyTorch / CUDA port of the realtime codec agent, for one NVIDIA H100.

The JAX package ``realtime_codec_agent_tpu`` is the reference; this package
keeps its module paths and public names (``agent.agent.RealtimeAgent``,
``lm.engine.DuplexLMEngine``, ``models.codec``, ``ops.*``) with PyTorch inside.
Each Pallas kernel on the realtime call's path is a hand-written CUDA kernel
under ``csrc/``, built at first use by ``ops/_cuda.py``, with a plain PyTorch
version beside it that CPU tensors take. This package imports neither JAX
nor any module of the JAX package: the host-only modules it needs from there
(``units``, ``tokenization``, ``utils.audio_utils`` and the
``utils.native_audio`` it calls) are copied here line for line.
"""

__version__ = "0.1.0"
