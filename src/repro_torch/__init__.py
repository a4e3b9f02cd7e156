"""PyTorch + CUDA port of the ALTO reproduction (the JAX package ``repro``
is the reference; this package imports nothing of it, nor JAX).

Slice 1 covers multi-adapter serving of the dense family: configs, the
model's prefill/decode with a per-lane cache, the adapter pool, the
serving replica and frontend, and the two rank-local grouped-LoRA forward
kernels written in CUDA C++ for Hopper (``kernels/grouped_lora``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
