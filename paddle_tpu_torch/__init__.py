"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` is the reference each part of the port is
held against; this package imports neither it nor JAX.  Entry points
run on the card (``device=None`` means CUDA device 0, and raises without
one); the CPU is used only when the caller passes ``device='cpu'``.

Ported so far: the transformer LM's serving path,
``inference.decode.DecodeServer`` over ``DecodeEngine``, with prefill
attention on the hand-written flash-attention kernel
(``ops/kernels/flash_attention.py``, ``csrc/flash_attention_fwd.cu``).
"""
