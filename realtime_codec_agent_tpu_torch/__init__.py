"""PyTorch / CUDA port of the realtime codec agent, for one NVIDIA H100.

The JAX package ``realtime_codec_agent_tpu`` is the reference; this package
keeps its module paths and public names (``agent.agent.RealtimeAgent``,
``lm.engine.DuplexLMEngine``, ``models.codec``, ``ops.*``) with PyTorch inside.
Each Pallas kernel on the realtime call's path is a hand-written CUDA kernel
under ``csrc/``, built at first use by ``ops/_cuda.py``, with a plain PyTorch
version beside it that CPU tensors take. This package imports neither JAX
nor any module of the JAX package: the host-only modules it needs from there
(``units``, ``tokenization``, ``utils.audio_utils`` and the
``utils.native_audio`` it calls, ``utils.cli_utils``) are copied here line for
line.

The public surface is the JAX package's (``RealtimeAgent``,
``RealtimeAgentResources``, ``RealtimeAgentConfig``,
``RealtimeAgentMultiprocessing``, ``add_common_inference_args``), resolved
lazily so that importing the package imports no torch. The clients and
demos run as ``python -m realtime_codec_agent_tpu_torch.<name>``
(``cli_benchmark``, ``inference_client_*``, ``run_demo*``,
``run_enrollment_selector``, ``run_stream_codes``).
"""

__version__ = "0.1.0"

__all__ = [
    "RealtimeAgentResources",
    "RealtimeAgentConfig",
    "RealtimeAgent",
    "RealtimeAgentMultiprocessing",
    "add_common_inference_args",
]

_LAZY = {
    "RealtimeAgentResources": ("realtime_codec_agent_tpu_torch.agent.resources", "RealtimeAgentResources"),
    "RealtimeAgentConfig": ("realtime_codec_agent_tpu_torch.agent.config", "RealtimeAgentConfig"),
    "RealtimeAgent": ("realtime_codec_agent_tpu_torch.agent.agent", "RealtimeAgent"),
    "RealtimeAgentMultiprocessing": ("realtime_codec_agent_tpu_torch.agent.agent", "RealtimeAgentMultiprocessing"),
    "add_common_inference_args": ("realtime_codec_agent_tpu_torch.utils.cli_utils", "add_common_inference_args"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
