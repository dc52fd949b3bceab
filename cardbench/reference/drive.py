"""Drives the reference over the benchmark's own inputs: a pool of images
through the forward, or the first training steps. Runs in blocks of rows,
with TF32 off, after the program's state is freed."""
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cardbench.compare import leaf_norms
from cardbench.reference import module_for
from cardbench.reference.precision import exact_fp32
from cardbench.reference.preprocess import crop_resize_normalize, normalize


@torch.no_grad()
def pool_outputs(cfg, params: Dict[str, np.ndarray], pool: np.ndarray,
                 indices: Sequence[int], layer: str, device: torch.device,
                 mode: str = "fp32", block: int = 64,
                 resize=None, mean=(0.0,), std=(1.0,)) -> Dict[int, np.ndarray]:
    """``{pool index: output row}`` of ``layer`` ("pool" or "logits") for
    the uint8 images ``pool[indices]``, resized to the model's input."""
    ref = module_for(cfg)
    p = {k: torch.from_numpy(v).to(device) for k, v in params.items()}
    size = resize or (cfg["image_size"], cfg["image_size"])
    out = {}
    indices = np.asarray(sorted(set(int(i) for i in indices)))
    with exact_fp32():
        for s in range(0, len(indices), block):
            idx = indices[s:s + block]
            u8 = torch.from_numpy(pool[idx]).to(device)
            x = crop_resize_normalize(u8, size, mean=mean, std=std)
            logits, pooled = ref.forward(p, x, cfg, mode)
            rows = (pooled if layer == "pool" else logits).float().cpu().numpy()
            out.update(zip(idx.tolist(), rows))
    return out


def train_steps(cfg, params: Dict[str, np.ndarray],
                batches: List[Tuple[np.ndarray, np.ndarray]], lr: float,
                momentum: float, mean, std, device: torch.device,
                mode: str = "fp32", chunk: int = 0) -> Dict[str, List[float]]:
    """SGD with momentum (no dampening, no Nesterov) on cross-entropy over
    ``batches`` of (uint8 images (B, H, W, C), int labels). Returns each
    step's loss, each leaf's gradient norm at the first step, and each
    leaf's change over all the steps, leaves in ``param_specs`` order.
    ``chunk`` > 0 sums the gradient over row chunks of that size."""
    ref = module_for(cfg)
    names = [n for n, _, _ in ref.param_specs(cfg)]
    p = {k: torch.from_numpy(params[k]).to(device, copy=True)
         .requires_grad_(True) for k in names}
    start = {k: v.detach().clone() for k, v in p.items()}
    bufs = None
    losses, grad_norms = [], None
    with exact_fp32():
        for u8, lab in batches:
            x_all = torch.from_numpy(u8).to(device)
            y_all = torch.from_numpy(np.asarray(lab)).to(device).long()
            n = x_all.shape[0]
            step = chunk or n
            grads = [torch.zeros_like(p[k]) for k in names]
            total = 0.0
            for s in range(0, n, step):
                x = normalize(x_all[s:s + step], mean, std)
                logits, _ = ref.forward(p, x, cfg, mode)
                loss = F.cross_entropy(logits.float(), y_all[s:s + step],
                                       reduction="sum") / n
                g = torch.autograd.grad(loss, [p[k] for k in names])
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                total += float(loss.detach())
            losses.append(total)
            if grad_norms is None:
                grad_norms = leaf_norms(grads)
            with torch.no_grad():
                if bufs is None:
                    bufs = [g.clone() for g in grads]
                else:
                    for b, g in zip(bufs, grads):
                        b.mul_(momentum).add_(g)
                for k, b in zip(names, bufs):
                    p[k].sub_(lr * b)
    change = leaf_norms([p[k].detach() - start[k] for k in names])
    return {"names": names, "losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
