"""PyTorch port of the ``repro`` package, for NVIDIA Hopper (H100).

Module names mirror the JAX package, so each module's counterpart is
found under the same path in ``src/repro/``. The JAX package stays the
reference the port is tested against; this package imports ``torch``,
numpy and the standard library only.

Slice 1 covers paged continuous-batching serving of the dense GQA
decoders (``serve.ServeEngine(backend="paged")``), with the paged decode
attention as a CUDA kernel written for ``sm_90a``
(``csrc/paged_decode_attention.cu``, wrapped in
``kernels/paged_attention.py``). Slice 2 covers the paper's Soft-MoE ViT
forward (``models.vit_apply`` / ``vit_features``), with the Soft-MoE
routing and combine as CUDA kernels (``csrc/soft_moe_routing.cu``,
``csrc/soft_moe_combine.cu``, wrapped in ``kernels/soft_moe_kernels.py``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""
