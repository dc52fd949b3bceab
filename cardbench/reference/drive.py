"""Drives the reference over the benchmark's own inputs: a pool of images
through the forward, or the first training steps. Runs in blocks of rows,
with TF32 off, after the program's state is freed."""
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cardbench.compare import leaf_norms
from cardbench.harness import CellError
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
            logits, pooled = ref.forward(p, x, cfg, mode)[:2]
            rows = (pooled if layer == "pool" else logits).float().cpu().numpy()
            out.update(zip(idx.tolist(), rows))
    return out


def train_steps(cfg, params: Dict[str, np.ndarray],
                batches: List[Tuple[np.ndarray, np.ndarray]], lr: float,
                momentum: float, mean, std, device: torch.device,
                mode: str = "fp32", chunk: int = 0) -> Dict[str, List[float]]:
    """SGD with momentum (no dampening, no Nesterov) on cross-entropy over
    ``batches`` of (uint8 images (B, H, W, C), int labels), plus
    ``cfg["aux_loss_weight"]`` times the auxiliary loss that the family's
    ``forward`` returns third, where the configuration sets that weight.
    Returns each step's loss, each leaf's gradient norm at the first step,
    and each leaf's change over all the steps, leaves in ``param_specs``
    order. ``chunk`` > 0 sums the loss and the gradient over row chunks of
    that size, each chunk's cross-entropy summed over its rows and divided
    by the batch's. The auxiliary loss is a statistic of the whole batch
    (a router's load over all its tokens, and their capacity) that no sum
    over chunks gives, so a chunk smaller than a batch is refused where
    the weight is set: the reference then takes each batch whole."""
    ref = module_for(cfg)
    names = [spec[0] for spec in ref.param_specs(cfg)]
    aux_weight = cfg.get("aux_loss_weight")
    if aux_weight is not None and chunk and any(
            chunk < len(lab) for _, lab in batches):
        raise CellError(
            f"{cfg['name']}: aux_loss_weight is set, and its auxiliary loss "
            f"is a statistic of the whole batch that row chunks of "
            f"{chunk} cannot sum; the reference takes a batch whole")
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
                out = ref.forward(p, x, cfg, mode)
                loss = F.cross_entropy(out[0].float(), y_all[s:s + step],
                                       reduction="sum") / n
                if aux_weight is not None:
                    if len(out) < 3:
                        raise CellError(
                            f"{cfg['name']}: aux_loss_weight is set, and the "
                            f"reference's forward returns no auxiliary loss")
                    loss = loss + aux_weight * out[2]
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
