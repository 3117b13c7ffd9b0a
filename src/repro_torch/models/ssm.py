"""Mamba2 (SSD, state-space duality) block, the port of the JAX package's
``models/ssm.py``.  [arXiv:2405.21060]

Chunked SSD form: the intra-chunk step (``kernels/ssd_chunk.py``: the
CUDA kernel under ``ssm_impl="pallas"``, its plain twin under ``"jnp"``)
plus the inter-chunk state recurrence in plain torch.  Decode keeps a
constant-size recurrent state.

Layout: n_groups = 1 (B/C shared across SSD heads).  x (B,S,d_model);
inner (B,S,H,P) with H = d_inner/headdim, P = headdim, N = ssm_state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import inter_chunk, ssd_chunk, ssd_chunk_ref
from repro_torch.models.common import dense_init, rms_norm
from repro_torch.models.config import ModelConfig


def ssm_init(gen: torch.Generator, cfg: ModelConfig):
    d, di, N, H, dt = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.tdtype
    dev = gen.device
    conv_ch = di + 2 * N
    return {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * N + H), dt),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_ch), dt, scale=cfg.ssm_conv ** -0.5),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=dev),
        # deterministic, fp32 in every model dtype (as the reference keeps them)
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((H,), -3.0, dtype=torch.float32, device=dev),
        "gate_norm": torch.ones((di,), dtype=dt, device=dev),
        "out_proj": dense_init(gen, (di, d), dt),
    }


def _causal_conv(xbc, w, b):
    """Depthwise causal conv of width W via shifted adds, then SiLU.
    xbc: (B,S,C)."""
    W, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(W))
    return F.silu(out + b)


def _split_zxbcdt(p, cfg: ModelConfig, x):
    di, N = cfg.d_inner, cfg.ssm_state
    zxbcdt = x @ p["in_proj"]
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N], zxbcdt[..., 2 * di + 2 * N:]


def ssm_apply(p, cfg: ModelConfig, x):
    """Full-sequence chunked SSD. x: (B,S,D) -> (B,S,D)."""
    B, S, _ = x.shape
    di, N, H, P, Lc = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_chunk
    if S % Lc:
        raise ValueError(f"seq {S} not divisible by chunk {Lc}")
    nc = S // Lc

    z, xbc, dtr = _split_zxbcdt(p, cfg, x)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :di].reshape(B, S, H, P)
    Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]          # (B,S,N) each
    dt = F.softplus(dtr.float() + p["dt_bias"])              # (B,S,H)
    dA = dt * -torch.exp(p["A_log"])

    c = lambda t, *tail: t.reshape(B, nc, Lc, *tail)
    B_c, C_c = c(Bm.float(), N), c(Cm.float(), N)
    dt_c = c(dt, H)
    cum = torch.cumsum(c(dA, H), dim=2)                       # (B,nc,Lc,H)
    xdt = c(xs.float(), H, P) * dt_c[..., None]               # (B,nc,Lc,H,P)

    chunk = ssd_chunk if cfg.ssm_impl == "pallas" else ssd_chunk_ref
    g = lambda t: t.reshape(B * nc, *t.shape[2:])
    y_intra, states, dec = chunk(g(xdt), g(B_c), g(C_c), g(cum))
    y = inter_chunk(y_intra.view(B, nc, Lc, H, P), states.view(B, nc, H, N, P),
                    dec.view(B, nc, H), C_c, cum)

    y = y.reshape(B, S, H, P) + p["D"][None, None, :, None] * xs.float()
    y = y.reshape(B, S, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def ssm_cache_init(cfg: ModelConfig, batch: int, layers=None, device=None):
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    shp_c = (batch, cfg.ssm_conv - 1, di + 2 * N)
    shp_s = (batch, H, N, P)
    if layers is not None:
        shp_c, shp_s = (layers, *shp_c), (layers, *shp_s)
    return {"conv": torch.zeros(shp_c, dtype=cfg.tdtype, device=device),
            "state": torch.zeros(shp_s, dtype=torch.float32, device=device)}


def ssm_decode_step(p, cfg: ModelConfig, x, cache):
    """x: (B,1,D); cache {'conv': (B,W-1,C), 'state': (B,H,N,P)} ->
    (y, new cache).  The cache passed in is left as it is."""
    B = x.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    z, xbc, dtr = _split_zxbcdt(p, cfg, x)                    # (B,1,*)
    hist = torch.cat([cache["conv"], xbc], dim=1)             # (B,W,C)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", hist, p["conv_w"]) + p["conv_b"])[:, None, :]

    xs = conv_out[..., :di].reshape(B, H, P)
    Bm, Cm = conv_out[:, 0, di:di + N], conv_out[:, 0, di + N:]
    dt = F.softplus(dtr[:, 0].float() + p["dt_bias"])         # (B,H)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))

    h = cache["state"] * dA[..., None, None] + torch.einsum(
        "bn,bhp->bhnp", Bm.float(), xs.float() * dt[..., None])
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), h) + p["D"][None, :, None] * xs.float()
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"], {"conv": hist[:, 1:, :], "state": h}
