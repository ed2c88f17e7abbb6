"""The plain reference: Qwen2's layer equations, the duplex LM's loss and
AdamW, in plain PyTorch on f32 with TF32 off. Imports
nothing of the program and nothing of JAX; every weight, scale and table it
uses it derives itself from the run's seed (``benchmark/weights.py``)."""
