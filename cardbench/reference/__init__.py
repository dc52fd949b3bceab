"""The plain reference: float32 PyTorch, TF32 off, no kernel of the port.

It imports nothing of ``mmlspark_tpu_torch``. Each family module,
``reference/<family>.py`` (a configuration's ``family``), gives
``param_specs(cfg)`` and a functional ``forward(params, images, cfg,
mode)`` over NHWC float images, which returns ``(logits, pool)``, or
``(logits, pool, aux)`` for a model with an auxiliary loss (the batch's,
fp32: what a configuration's ``aux_loss_weight`` weighs). A spec is
``(name, shape, kind)`` in the port's state-dict layout, ``kind`` saying
how the leaf is drawn (:mod:`cardbench.weights`), or ``(name, shape,
"fan_in", fan_in)`` for a banked weight whose fan-in is not the product of
every axis but the first. ``mode`` is ``"fp32"`` or ``"fp8"``: the latter
rounds every matmul and conv operand to float8 e4m3 (:mod:`.precision`),
the control that a sound comparison must reject.
"""
from cardbench.harness import family_module


def module_for(cfg):
    """The reference module of ``cfg``'s architecture family."""
    return family_module("reference", cfg)
