"""mmlspark_tpu_torch: the PyTorch / CUDA port of ``mmlspark_tpu``.

A package of its own beside the JAX one: the same Frame / Transformer /
Pipeline surface and stage names, with PyTorch as the compute engine and
the JAX package's Pallas TPU kernels rewritten by hand for NVIDIA Hopper
(``kernels/``). It imports nothing of JAX or of ``mmlspark_tpu``.

Entry points run on ``runtime.device`` (``utils/config.py``), ``"cuda"``
by default; without CUDA they raise unless it is set to ``"cpu"``.
"""
