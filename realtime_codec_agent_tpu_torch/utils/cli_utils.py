"""Shared CLI arguments for inference clients (reference utils/cli_utils.py:3-7)."""
import argparse


def add_common_inference_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--llm_model_path",
        default=None,
        help="Path to a trained LM checkpoint directory (orbax params + "
        "codec_tokenizer.json). Omit to random-initialize the configured "
        "architecture (benchmarks only).",
    )
    parser.add_argument(
        "--tiny",
        action="store_true",
        help="Use tiny codec/LM configs (CPU-friendly debugging).",
    )
