"""The plain reference: float32 PyTorch, TF32 off, no kernel of the port.

It imports nothing of ``mmlspark_tpu_torch``. Each architecture module
gives ``param_specs(cfg)`` (the parameter names and shapes, in the port's
state-dict layout, and how each leaf is drawn) and a functional
``forward(params, images, cfg, mode)`` over NHWC float images.
``mode`` is ``"fp32"`` or ``"fp8"``: the latter rounds every matmul and
conv operand to float8 e4m3 (:mod:`.precision`), the control that a
sound comparison must reject.
"""
import importlib


def module_for(cfg):
    """The reference module of ``cfg``'s architecture family."""
    family = {"resnet50": "resnet", "vit_b16": "vit"}[cfg["architecture"]]
    return importlib.import_module(f"cardbench.reference.{family}")
