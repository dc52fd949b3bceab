"""The index dispatch of a routed MLP: plan, row moves and expert GEMMs.

A routed MLP (``models/zoo/moe.py::MoeMlp``) sends each token's K chosen
(token, choice) pairs to their experts. The one-hot route builds (S, E, C)
dispatch and combine tensors; at S = 25,216 tokens, E = 32 experts and
C = 1,655 slots each holds 1.34 G elements, more than a card holds for six
layers. This module moves rows by index instead:

- :func:`index_plan`: a stable sort of the flattened (choice, token) pairs
  by expert gives each pair its slot, its rank among the pairs of its
  expert in (choice, token) order, which is ``MoeMlp._positions``' slot; a
  pair at a slot past the capacity C is dropped. Expert e's kept pairs take
  rows ``e * C .. e * C + kept[e]`` of an (E * C, D) buffer. The counts stay
  on the device: nothing here reads them on the host.
- :func:`permute` gathers each kept pair's input row into its slot, zeros
  in the slots no pair holds; :func:`experts` computes up, bias, GELU and
  down over every expert's whole capacity buffer, as the paper's
  implementation does, so that a step's device work does not depend on
  where the router sends its tokens; :func:`unpermute` sums each token's
  gate-weighted expert rows.

Each has a plain-torch version (``*_plain``: ``index_select``, batched
per-expert matmuls, the weighted sum), which a CPU tensor takes and
autograd differentiates, and CUDA kernels for a CUDA tensor with bf16
operands (``kernels/csrc/moe_rows.cu``, ``kernels/csrc/moe_grouped_gemm.cu``;
their notes give what bounds each), behind ``torch.autograd.Function``s
whose backward is kernels too. Each launch is counted on its kernel
(``kernels.MOE_*``). No TPU kernel is replaced: the JAX package routes by
one-hot einsums.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from mmlspark_tpu_torch import kernels


class IndexPlan(NamedTuple):
    """Where each (token, choice) pair goes. ``pair_slot`` (K * S,) int32,
    pair ``k * S + t``: its row in the (E * C, D) buffer, or -1 when it is
    dropped; ``position`` (S, K) int32, its rank within its expert (the
    slot before the capacity cut); ``kept`` (E,) int32, rows of each expert
    that hold a pair (they are its first ones); ``capacity`` C."""
    pair_slot: torch.Tensor
    position: torch.Tensor
    kept: torch.Tensor
    capacity: int


def index_plan(gate_idx: torch.Tensor, num_experts: int,
               capacity: int) -> IndexPlan:
    """The slots of ``gate_idx`` (S, K): a stable sort of the pairs in
    (choice, token) order by expert; a pair's slot is its sorted place less
    its expert's first. Device ops only (sort, searchsorted, scatter)."""
    S, K = gate_idx.shape
    dev = gate_idx.device
    flat = gate_idx.t().reshape(-1).long()                  # pair k * S + t
    sorted_e, order = torch.sort(flat, stable=True)
    experts = torch.arange(num_experts, device=dev)
    first = torch.searchsorted(sorted_e, experts)
    count = torch.searchsorted(sorted_e, experts, right=True) - first
    rank = torch.arange(K * S, device=dev) - first[sorted_e]
    slot = torch.where(rank < capacity, sorted_e * capacity + rank, -1)
    pair_slot = torch.empty_like(flat).scatter_(0, order, slot)
    position = torch.empty_like(flat).scatter_(0, order, rank)
    return IndexPlan(pair_slot.to(torch.int32),
                     position.view(K, S).t().to(torch.int32),
                     count.clamp(max=capacity).to(torch.int32), capacity)


# -- the plain versions ------------------------------------------------------

def permute_plain(x: torch.Tensor, pair_slot: torch.Tensor, rows: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """x (S, D) -> (rows, D) in ``dtype``: each kept pair's token row in
    its slot, zeros in the slots no pair holds."""
    S, D = x.shape
    token = torch.arange(pair_slot.numel(), device=x.device) % S
    target = torch.where(pair_slot < 0, rows, pair_slot).long()
    # the dropped pairs all write the one spare entry, cut off after
    src = torch.full((rows + 1,), S, dtype=torch.long, device=x.device)
    src = src.scatter_(0, target, token)[:rows]
    padded = torch.cat([x, x.new_zeros(1, D)])
    return padded.index_select(0, src).to(dtype)


def experts_plain(xe: torch.Tensor, w_up: torch.Tensor,
                  b_up: Optional[torch.Tensor], w_down: torch.Tensor,
                  b_down: Optional[torch.Tensor], act_dtype: torch.dtype,
                  w_dtype: torch.dtype) -> torch.Tensor:
    """xe (E, C, D) -> (E, C, D): ``gelu(xe @ w_up + b_up) @ w_down +
    b_down`` per expert, the weights rounded to ``w_dtype``, products
    summed in fp32, the pre-activation, the activation and the output
    stored in ``act_dtype``, as the kernels round them."""
    f32 = torch.float32

    def w(t):
        return t.to(w_dtype).to(f32)
    a = torch.bmm(xe.to(f32), w(w_up))
    if b_up is not None:
        a = a + w(b_up)[:, None, :]
    h = F.gelu(a.to(act_dtype).to(f32), approximate="tanh").to(act_dtype)
    y = torch.bmm(h.to(f32), w(w_down))
    if b_down is not None:
        y = y + w(b_down)[:, None, :]
    return y.to(act_dtype)


def unpermute_plain(ye: torch.Tensor, gates: torch.Tensor,
                    pair_slot: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """ye (rows, D), gates (S, K) -> (S, D) in ``out_dtype``: each token's
    kept pairs' rows times their gates, summed in fp32."""
    S, K = gates.shape
    rows, D = ye.shape
    padded = torch.cat([ye.float(), ye.new_zeros(1, D, dtype=torch.float32)])
    idx = torch.where(pair_slot < 0, rows, pair_slot).long().view(K, S)
    y = sum(gates[:, k, None] * padded.index_select(0, idx[k])
            for k in range(K))
    return y.to(out_dtype)


# -- the routes ---------------------------------------------------------------

def _kernel_route(t: torch.Tensor, *dtypes: torch.dtype) -> bool:
    """True for a CUDA tensor (bf16 operands, or raises), False on the CPU."""
    if t.device.type != "cuda":
        return False
    if any(d != torch.bfloat16 for d in dtypes):
        raise TypeError(f"the MoE kernels take bf16 operands, got {dtypes}")
    return True


def permute(x: torch.Tensor, plan: IndexPlan, num_experts: int,
            dtype: torch.dtype) -> torch.Tensor:
    """x (S, D) -> (E * C, D) in ``dtype``: :func:`permute_plain`, or the
    ``moe_permute`` kernel into a zeroed buffer."""
    rows = num_experts * plan.capacity
    if not _kernel_route(x, dtype):
        return permute_plain(x, plan.pair_slot, rows, dtype)
    if x.dtype != torch.float32:
        raise TypeError(f"moe_permute reads fp32 rows, got {x.dtype}")
    return _Permute.apply(x, plan.pair_slot, rows)


def experts(xe: torch.Tensor, w_up, b_up, w_down, b_down,
            act_dtype: torch.dtype, w_dtype: torch.dtype) -> torch.Tensor:
    """xe (E, C, D) -> (E, C, D): :func:`experts_plain`, or the
    ``moe_grouped_gemm`` kernels over each expert's C rows (the empty ones
    are zeros, and so is their gradient)."""
    if not _kernel_route(xe, act_dtype, w_dtype):
        return experts_plain(xe, w_up, b_up, w_down, b_down, act_dtype,
                             w_dtype)
    if b_up is None or b_down is None:
        raise ValueError("the grouped GEMM kernels take expert biases")
    D, H = w_up.shape[1:]
    if D % 256 or H % 256:
        raise ValueError(f"the grouped GEMM tiles widths by 256: got D={D}, "
                         f"H={H}")
    return _Experts.apply(xe, w_up, b_up, w_down, b_down)


def unpermute(ye: torch.Tensor, gates: torch.Tensor, plan: IndexPlan,
              out_dtype: torch.dtype) -> torch.Tensor:
    """ye (E * C, D), gates (S, K) -> (S, D): :func:`unpermute_plain`, or
    the ``moe_unpermute`` kernel (and ``moe_unpermute_bwd``, which gives
    the gates' gradient)."""
    if not _kernel_route(ye, ye.dtype, out_dtype):
        return unpermute_plain(ye, gates, plan.pair_slot, out_dtype)
    return _Unpermute.apply(ye, gates.float().contiguous(), plan.pair_slot,
                            out_dtype)


# -- the kernels' wrappers ----------------------------------------------------

def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _f32(t: torch.Tensor) -> int:
    return int(t.dtype == torch.float32)


def _gemm(variant: str, a, b, c, a_mn: bool, b_mn: bool, epi: int,
          c2=None, bias=None, aux=None) -> None:
    """c[e] = epilogue(a[e] . b[e]) for every expert e (the entry point's
    note in ``moe_grouped_gemm.cu``): a (E, M, K), or (E, K, M) with
    ``a_mn``; b (E, N, K), or (E, K, N) with ``b_mn``; all contiguous."""
    E = a.shape[0]
    M, K = (a.shape[2], a.shape[1]) if a_mn else (a.shape[1], a.shape[2])
    N = b.shape[2] if b_mn else b.shape[1]
    kernels.MOE_GROUPED_GEMM(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), _ptr(c2), _ptr(bias),
        _ptr(aux), E, M, N, K, int(a_mn), int(b_mn), a.stride(1),
        a.stride(0), b.stride(1), b.stride(0), c.stride(1), c.stride(0),
        epi, _stream(a), variant=variant)


def _weight_grads(a, g):
    """(a[e]^T . g[e], the column sums of g[e]), fp32: a weight's and its
    bias's gradient from its input a (E, C, M) and its output's gradient
    g (E, C, N)."""
    E, C, M = a.shape
    N = g.shape[2]
    dw = torch.empty(E, M, N, dtype=torch.float32, device=a.device)
    _gemm("d_w", a, g, dw, True, True, 4)
    db = torch.empty(E, N, dtype=torch.float32, device=a.device)
    kernels.MOE_BIAS_GRAD(g.data_ptr(), db.data_ptr(), E, C, N, _stream(g))
    return dw, db


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pair_slot, rows):
        x = x.contiguous()
        S, D = x.shape
        K = pair_slot.numel() // S
        out = torch.zeros(rows, D, dtype=torch.bfloat16, device=x.device)
        kernels.MOE_PERMUTE(x.data_ptr(), pair_slot.data_ptr(),
                            out.data_ptr(), S, D, K, _stream(x))
        ctx.save_for_backward(pair_slot)
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        return out

    @staticmethod
    def backward(ctx, d_out):
        # each token's gradient is the sum of its kept slots' rows: the
        # combine's kernel without gates
        (pair_slot,) = ctx.saved_tensors
        d_out = d_out.contiguous()
        S, D = ctx.x_shape
        dx = torch.empty(S, D, dtype=ctx.x_dtype, device=d_out.device)
        kernels.MOE_UNPERMUTE(d_out.data_ptr(), pair_slot.data_ptr(), None,
                              dx.data_ptr(), S, D, pair_slot.numel() // S,
                              _f32(dx), _stream(d_out), variant="gather_bwd")
        return dx, None, None


class _Unpermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ye, gates, pair_slot, out_dtype):
        ye = ye.contiguous()
        S, K = gates.shape
        D = ye.shape[1]
        y = torch.empty(S, D, dtype=out_dtype, device=ye.device)
        kernels.MOE_UNPERMUTE(ye.data_ptr(), pair_slot.data_ptr(),
                              gates.data_ptr(), y.data_ptr(), S, D, K,
                              _f32(y), _stream(ye))
        ctx.save_for_backward(ye, gates, pair_slot)
        return y

    @staticmethod
    def backward(ctx, dy):
        ye, gates, pair_slot = ctx.saved_tensors
        dy = dy.contiguous()
        S, K = gates.shape
        D = ye.shape[1]
        # the slots no pair holds get a zero gradient: the GEMMs sum over them
        d_ye = torch.zeros_like(ye)
        d_g = torch.empty(S, K, dtype=torch.float32, device=ye.device)
        kernels.MOE_UNPERMUTE_BWD(dy.data_ptr(), ye.data_ptr(),
                                  pair_slot.data_ptr(), gates.data_ptr(),
                                  d_ye.data_ptr(), d_g.data_ptr(), S, D, K,
                                  _stream(dy))
        return d_ye, d_g, None, None


class _Experts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xe, w_up, b_up, w_down, b_down):
        bf16 = torch.bfloat16
        xe = xe.contiguous()
        E, C, D = xe.shape
        H = w_up.shape[2]
        wu, wd = w_up.to(bf16).contiguous(), w_down.to(bf16).contiguous()
        pre = torch.empty(E, C, H, dtype=bf16, device=xe.device)
        h = torch.empty_like(pre)
        _gemm("up", xe, wu, pre, False, True, 1, c2=h,
              bias=b_up.to(bf16).contiguous())
        ye = torch.empty(E, C, D, dtype=bf16, device=xe.device)
        _gemm("down", h, wd, ye, False, True, 0,
              bias=b_down.to(bf16).contiguous())
        ctx.save_for_backward(xe, wu, wd, pre, h)
        return ye

    @staticmethod
    def backward(ctx, d_ye):
        xe, wu, wd, pre, h = ctx.saved_tensors
        d_ye = d_ye.contiguous()
        # d_pre = (d_ye . w_down^T) * gelu'(pre): w_down (E, H, D) is b
        # K-major
        d_pre = torch.empty_like(pre)
        _gemm("d_pre", d_ye, wd, d_pre, False, False, 2, aux=pre)
        d_wd, d_bd = _weight_grads(h, d_ye)
        del h
        d_xe = torch.empty_like(xe)
        _gemm("d_x", d_pre, wu, d_xe, False, False, 3)
        d_wu, d_bu = _weight_grads(xe, d_pre)
        return d_xe, d_wu, d_bu, d_wd, d_bd
