"""Plain PyTorch versions of the Mamba-2 SSD scan (``repro/kernels/ssd_scan/ref.py``).

``ssd_sequential`` is the step-by-step state-space recurrence (the ground
truth); ``ssd_chunked`` is the state-space-duality chunked algorithm
[arXiv:2405.21060 §6]: quadratic *within* a chunk, linear across chunks.
``ssd_chunked`` is the CPU path of ``ops.ssd(impl="pallas")`` and the
oracle the kernel is held against on the card; never the path of a CUDA
tensor given to the kernel's route.

Shapes:
  x  (B, L, H, P)   per-head inputs
  dt (B, L, H)      positive step sizes (softplus already applied)
  A  (H,)           negative per-head decay rates
  B  (B, L, G, N)   input projections  (H % G == 0; group = h // (H//G))
  C  (B, L, G, N)   output projections
returns y (B, L, H, P) in x's dtype and the final state (B, H, P, N) in f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

MASK_VALUE = -1e30


def _initial_state(init_state: Optional[torch.Tensor], shape, device) -> torch.Tensor:
    if init_state is None:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return init_state.float()


def ssd_sequential(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    bsz, l, h, p = x.shape
    rep = h // b_mat.shape[2]
    bh = b_mat.float().repeat_interleave(rep, dim=2)     # (B,L,H,N)
    ch = c_mat.float().repeat_interleave(rep, dim=2)
    xf, dtf, af = x.float(), dt.float(), a.float()
    state = _initial_state(init_state, (bsz, h, p, b_mat.shape[-1]), x.device)
    ys = []
    for t in range(l):
        decay = torch.exp(af[None, :] * dtf[:, t])                        # (B,H)
        state = state * decay[..., None, None] + (
            (dtf[:, t, :, None] * xf[:, t])[..., :, None] * bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bsz, 0, h, p))
    return y.to(x.dtype), state


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    chunk: int = 64,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: O(L·Q) intra-chunk products + O(L/Q) state scan."""
    bsz, l_orig, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    q = min(chunk, l_orig)
    pad = (-l_orig) % q
    if pad:
        # dt=0 on padded steps: decay exp(a·0)=1 and zero input keep the
        # state invariant, so the final state is exact; padded y is dropped.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    l = l_orig + pad
    nc = l // q
    rep = h // g

    xf = x.float().reshape(bsz, nc, q, h, p)
    dtf = dt.float().reshape(bsz, nc, q, h)
    bf = b_mat.float().reshape(bsz, nc, q, g, n)
    cf = c_mat.float().reshape(bsz, nc, q, g, n)

    adt = a.float()[None, None, None, :] * dtf            # (B,NC,Q,H) log-decay increments
    cs = torch.cumsum(adt, dim=2)                         # inclusive cumsum within chunk
    total = cs[:, :, -1, :]                               # (B,NC,H)

    # --- intra-chunk (quadratic within chunk) ---
    # seg[t,s] = exp(cs_t - cs_s) for s <= t.  Mask the ARGUMENT before exp:
    # for s > t the difference is positive and exp overflows.
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]     # (B,NC,Q,Q,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    seg = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                torch.full((), MASK_VALUE, device=x.device)))
    scores = torch.einsum("bcqgn,bcsgn->bcqsg", cf, bf)   # (B,NC,Q,Q,G)
    scores = scores.repeat_interleave(rep, dim=-1) * seg  # (B,NC,Q,Q,H)
    xdt = xf * dtf[..., None]                             # (B,NC,Q,H,P)
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", scores, xdt)

    # --- per-chunk local end states ---
    w = torch.exp(total[:, :, None, :] - cs)              # (B,NC,Q,H)
    bh = bf.repeat_interleave(rep, dim=3)                 # (B,NC,Q,H,N)
    local_state = torch.einsum("bcqhp,bcqhn->bchpn", xdt * w[..., None], bh)

    # --- inter-chunk state scan (a loop over chunks, not over steps) ---
    state = _initial_state(init_state, (bsz, h, p, n), x.device)
    prevs = []
    for c in range(nc):
        prevs.append(state)                               # state entering chunk c
        state = state * torch.exp(total[:, c])[..., None, None] + local_state[:, c]
    prev = torch.stack(prevs, dim=1)                      # (B,NC,H,P,N)

    ch = cf.repeat_interleave(rep, dim=3)                 # (B,NC,Q,H,N)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", ch * torch.exp(cs)[..., None], prev)

    y = (y_intra + y_inter).reshape(bsz, l, h, p)[:, :l_orig]
    return y.to(x.dtype), state
