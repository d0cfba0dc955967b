"""Mamba-2 (SSD) blocks (the reference's ``models/ssm.py`` in PyTorch).

The SSD sequence computation is the strip-mined MultiFold of the paper
(``kernels/ssd_scan.py`` is the hand-written CUDA realization); this
module provides the full-sequence chunked form used for prefill and the
recurrent single-step form used for decode, plus the block plumbing
(in-proj, causal conv, gating, out-proj) from arXiv:2405.21060.  Both
forms run as plain PyTorch, as the reference's run in eager JAX.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import layers as L
from .config import ModelConfig
from .sharding import hint, on_local, project

Params = Dict[str, Any]

# the parameters kept in float32 whatever the model's type
FLOAT32_PARAMS = ("A_log", "D", "dt_bias")


def block_param_shapes(cfg: ModelConfig, nl: int, prefix: str = ""
                       ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    d, di, ns, h = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads)
    k = cfg.ssm_conv
    p = prefix
    return {
        f"{p}ln": ((nl, d), "zeros"),
        f"{p}in_proj": ((nl, d, 2 * di + 2 * ns + h), "dense"),
        f"{p}conv_w": ((nl, k, di + 2 * ns), "dense"),
        f"{p}A_log": ((nl, h), "zeros"),       # A = -exp(A_log)
        f"{p}D": ((nl, h), "zeros"),
        f"{p}dt_bias": ((nl, h), "zeros"),
        f"{p}gate_ln": ((nl, di), "zeros"),
        f"{p}out_proj": ((nl, di, d), "dense"),
    }


def _split_proj(z: torch.Tensor, cfg: ModelConfig):
    di, ns = cfg.d_inner, cfg.ssm_state
    xz, rest = z[..., :2 * di], z[..., 2 * di:]
    x_in, gate = xz[..., :di], xz[..., di:]
    B = rest[..., :ns]
    C = rest[..., ns:2 * ns]
    dt = rest[..., 2 * ns:]
    return x_in, gate, B, C, dt


SSD_CHUNK = 64  # the reference's chunk (its cost-model sweep's pick)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor,
                chunk: Optional[int] = None):
    """Full-sequence SSD, chunked (matmul) form: the reference's
    ``ssd_chunked``, the same algorithm as ``kernels/ssd_scan.py``.

    x: (b, s, h, dh); dt: (b, s, h); A: (h,); B, C: (b, s, n).  Returns
    y (b, s, h, dh) in x's type and the final state (b, h, n, dh) in
    float32.  Decays and scores are float32; as in the reference, the
    intra-chunk product takes its operands rounded to bfloat16 (with
    float32 accumulation) whatever the model's type."""
    if chunk is None:
        chunk = SSD_CHUNK
    s = x.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"ssd_chunked: chunk {chunk} must divide the "
                         f"sequence length {s}")
    x = hint(x, "data", None, "model", None)
    dt = hint(dt, "data", None, "model")
    # each (batch row, head) scans alone: on a mesh each rank runs the
    # chunks of its own rows and heads (``on_local``; B and C are shared
    # by the heads)
    return on_local(functools.partial(_ssd_chunks, chunk=chunk),
                    [(0, 2), (0, 2), (None, 0), (0, None), (0, None)],
                    x, dt, A, B, C, out_dims=[(0, 2), (0, 1)])


def _ssd_chunks(x, dt, A, B, C, chunk: int):
    """``ssd_chunked``'s chunk loop, on whole or local tensors."""
    b, s, h, dh = x.shape
    n = B.shape[-1]
    nc = s // chunk
    xf = x.float().reshape(b, nc, chunk, h, dh)
    dtf = dt.float().reshape(b, nc, chunk, h)
    Bf = B.float().reshape(b, nc, chunk, n)
    Cf = C.float().reshape(b, nc, chunk, n)
    Af = A.float()
    idx = torch.arange(chunk, device=x.device)
    lmask = (idx[:, None] >= idx[None, :])[None, :, :, None]

    hprev = torch.zeros((b, h, n, dh), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        # one strided iteration of the tiled MultiFold
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        cum = torch.cumsum(Af[None, None, :] * dtc, dim=1)       # (b,L,h)
        total = cum[:, -1, :]                                    # (b,h)
        Mdec = torch.where(lmask, torch.exp(cum[:, :, None, :]
                                            - cum[:, None, :, :]), 0.0)
        scores = torch.einsum("bln,bmn->blm", Cc, Bc)
        SM = (scores[..., None] * Mdec).to(torch.bfloat16).float()
        xdt = (dtc[..., None] * xc).to(torch.bfloat16).float()
        y_intra = torch.einsum("blmh,bmhd->blhd", SM, xdt)
        y_state = torch.einsum("bln,blh,bhnd->blhd", Cc, torch.exp(cum),
                               hprev)
        w = torch.exp(total[:, None, :] - cum) * dtc             # (b,L,h)
        hprev = (hprev * torch.exp(total)[:, :, None, None]
                 + torch.einsum("bln,blh,blhd->bhnd", Bc, w, xc))
        ys.append(y_intra + y_state)
    y = torch.stack(ys, 1).reshape(b, s, h, dh)
    return y.to(x.dtype), hprev


def block_forward(slc: Params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[Dict] = None, prefix: str = ""):
    """One Mamba-2 block.  state (decode): {"conv": (B, K-1, C), "ssm":
    (B, H, N, dh)}; None for the full sequence.  Returns the residual
    stream and, in decode, the new state."""
    p = {k[len(prefix):]: v for k, v in slc.items()
         if k.startswith(prefix)} if prefix else slc
    h = L.rms_norm(x, p["ln"])
    z = project(h, p["in_proj"])
    x_in, gate, B, C, dt = _split_proj(z, cfg)
    conv_in = torch.cat([x_in, B, C], dim=-1)
    conv_out, new_conv = L.causal_conv1d(
        conv_in, p["conv_w"], None if state is None else state["conv"])
    conv_out = L.silu(conv_out)
    di, ns = cfg.d_inner, cfg.ssm_state
    x_c = conv_out[..., :di]
    B_c = conv_out[..., di:di + ns]
    C_c = conv_out[..., di + ns:]

    nh, dh = cfg.ssm_heads, cfg.ssm_head_dim
    xh = x_c.reshape(x.shape[0], x.shape[1], nh, dh)
    dt_s = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if state is None:
        y, hfin = ssd_chunked(xh, dt_s, A, B_c, C_c)
    else:
        # recurrent single step: s == 1
        hprev = state["ssm"]
        xt = xh[:, 0].float()                                  # (b,h,dh)
        dtt = dt_s[:, 0]                                       # (b,h)
        Bt = B_c[:, 0].float()                                 # (b,n)
        Ct = C_c[:, 0].float()
        decay = torch.exp(A[None] * dtt)[..., None, None]
        hfin = (hprev * decay
                + dtt[..., None, None] * Bt[:, None, :, None]
                * xt[:, :, None, :])
        y = torch.einsum("bn,bhnd->bhd", Ct, hfin)[:, None]   # (b,1,h,dh)
        y = y.to(x.dtype)

    y = y + xh * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(x.shape[0], x.shape[1], di)
    y = L.rms_norm(y, p["gate_ln"]) * L.silu(gate)
    out = project(y.to(x.dtype), p["out_proj"])
    new_state = None
    if state is not None:
        new_state = {"conv": new_conv, "ssm": hfin}
    return hint(x + out, "data", "model", None), new_state  # sequence par.


def state_shapes(cfg: ModelConfig, batch: int) -> Dict[str, Tuple]:
    return {
        "conv": (cfg.n_layers, batch, cfg.ssm_conv - 1,
                 cfg.d_inner + 2 * cfg.ssm_state),
        "ssm": (cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_state,
                cfg.ssm_head_dim),
    }


def init_state(cfg: ModelConfig, batch: int, device=None) -> Dict:
    """Zero decode state: the conv state in the config's type, the SSM
    state in float32."""
    from .transformer import dtype_of
    shp = state_shapes(cfg, batch)
    return {"conv": torch.zeros(shp["conv"], dtype=dtype_of(cfg),
                                device=device),
            "ssm": torch.zeros(shp["ssm"], dtype=torch.float32,
                               device=device)}


def state_specs(cfg: ModelConfig, batch: int) -> Dict:
    """The decode state's shapes and types on the ``meta`` device."""
    from .transformer import dtype_of
    shp = state_shapes(cfg, batch)
    return {"conv": torch.empty(shp["conv"], dtype=dtype_of(cfg),
                                device="meta"),
            "ssm": torch.empty(shp["ssm"], dtype=torch.float32,
                               device="meta")}
