"""Plain PyTorch versions of the Mamba-2 SSD scan (``repro/kernels/ssd_scan/ref.py``).

``ssd_sequential`` is the step-by-step state-space recurrence (the ground
truth); ``ssd_chunked`` is the state-space-duality chunked algorithm
[arXiv:2405.21060 §6]: quadratic *within* a chunk, linear across chunks.
``ssd_chunked`` is the CPU path of ``ops.ssd(impl="pallas")`` and the
oracle the kernel is held against on the card; never the path of a CUDA
tensor given to the kernel's route.

The backward: ``ssd_bwd_ref`` is torch autograd through ``ssd_chunked`` in
f32 (the reference's custom VJP, ``repro/kernels/ssd_scan/ops.py:44-49``,
takes the vjp of the same function), the oracle of the backward kernels on
the card; ``ssd_bwd_chunked`` is the same gradient written out with no
autograd, in the loop structure of ``csrc/ssd_scan_bwd.cu``.

Shapes:
  x  (B, L, H, P)   per-head inputs
  dt (B, L, H)      positive step sizes (softplus already applied)
  A  (H,)           negative per-head decay rates
  B  (B, L, G, N)   input projections  (H % G == 0; group = h // (H//G))
  C  (B, L, G, N)   output projections
returns y (B, L, H, P) in x's dtype and the final state (B, H, P, N) in f32
(in f64 for f64 x: ``ssd_chunked`` then computes in f64, so that
``ssd_bwd_ref`` can give an f64 oracle for the f32 kernels).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

MASK_VALUE = -1e30


def _initial_state(init_state: Optional[torch.Tensor], shape, device,
                   dtype=torch.float32) -> torch.Tensor:
    if init_state is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return init_state.to(dtype)


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    """f32, or f64 for f64 inputs."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


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

    work = _work_dtype(x)
    xf = x.to(work).reshape(bsz, nc, q, h, p)
    dtf = dt.to(work).reshape(bsz, nc, q, h)
    bf = b_mat.to(work).reshape(bsz, nc, q, g, n)
    cf = c_mat.to(work).reshape(bsz, nc, q, g, n)

    adt = a.to(work)[None, None, None, :] * dtf           # (B,NC,Q,H) log-decay increments
    cs = torch.cumsum(adt, dim=2)                         # inclusive cumsum within chunk
    total = cs[:, :, -1, :]                               # (B,NC,H)

    # --- intra-chunk (quadratic within chunk) ---
    # seg[t,s] = exp(cs_t - cs_s) for s <= t.  Mask the ARGUMENT before exp:
    # for s > t the difference is positive and exp overflows.
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]     # (B,NC,Q,Q,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    seg = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                torch.full((), MASK_VALUE, dtype=work, device=x.device)))
    scores = torch.einsum("bcqgn,bcsgn->bcqsg", cf, bf)   # (B,NC,Q,Q,G)
    scores = scores.repeat_interleave(rep, dim=-1) * seg  # (B,NC,Q,Q,H)
    xdt = xf * dtf[..., None]                             # (B,NC,Q,H,P)
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", scores, xdt)

    # --- per-chunk local end states ---
    w = torch.exp(total[:, :, None, :] - cs)              # (B,NC,Q,H)
    bh = bf.repeat_interleave(rep, dim=3)                 # (B,NC,Q,H,N)
    local_state = torch.einsum("bcqhp,bcqhn->bchpn", xdt * w[..., None], bh)

    # --- inter-chunk state scan (a loop over chunks, not over steps) ---
    state = _initial_state(init_state, (bsz, h, p, n), x.device, work)
    prevs = []
    for c in range(nc):
        prevs.append(state)                               # state entering chunk c
        state = state * torch.exp(total[:, c])[..., None, None] + local_state[:, c]
    prev = torch.stack(prevs, dim=1)                      # (B,NC,H,P,N)

    ch = cf.repeat_interleave(rep, dim=3)                 # (B,NC,Q,H,N)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", ch * torch.exp(cs)[..., None], prev)

    y = (y_intra + y_inter).reshape(bsz, l, h, p)[:, :l_orig]
    return y.to(x.dtype), state


def _grad_dtypes(grads, inputs):
    return tuple(g.to(t.dtype) for g, t in zip(grads, inputs))


def ssd_bwd_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    dy: torch.Tensor,
    dstate: Optional[torch.Tensor] = None,
    chunk: int = 64,
) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, da, dB, dC) of ``ssd_chunked`` at ``chunk`` for the
    cotangents ``dy`` of y and ``dstate`` of the final state (None: zero):
    torch autograd in f32 (f64 for f64 x), each gradient cast to its
    input's dtype."""
    inputs = (x, dt, a, b_mat, c_mat)
    work = _work_dtype(x)
    with torch.enable_grad():
        leaves = [t.detach().to(work).requires_grad_() for t in inputs]
        y, state = ssd_chunked(*leaves, chunk=chunk)
        outs, cots = [y], [dy.to(work)]
        if dstate is not None:
            outs.append(state)
            cots.append(dstate.to(work))
        grads = torch.autograd.grad(outs, leaves, cots, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
    return _grad_dtypes(grads, inputs)


def ssd_bwd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    dy: torch.Tensor,
    dstate: Optional[torch.Tensor] = None,
    chunk: int = 32,
) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, da, dB, dC) as ``ssd_bwd_ref`` gives them, written out.

    A forward walk stores the f32 state S_in entering each chunk; a reverse
    walk carries dS, the adjoint of the state leaving the chunk.  Within a
    chunk of Q rows, with cs the inclusive cumsum of a dt, seg[t, s] =
    exp(cs_t - cs_s) for s <= t (the argument masked before the exponent),
    G = C B^T, D = dY x^T and w_s = exp(cs_Q - cs_s):

      dx_s   = dt_s (sum_t seg G [t, s] dY_t + w_s dS B_s)
      dB_s   = dt_s (sum_t seg D [t, s] C_t + w_s dS^T x_s)
      dC_t   = exp(cs_t) S_in^T dY_t + sum_s seg D [t, s] dt_s B_s
      dS_in  = exp(cs_Q) dS + sum_t exp(cs_t) dY_t C_t^T

    and the adjoint of a dt at row r sums what the decay of that row
    multiplies, each term a sum of products with no cancellation:

      d(a dt)_r = exp(cs_Q) <dS, S_in> + sum_{s<r} dt_s x_s . (w_s dS B_s)
                + sum_{t>=r} exp(cs_t) dY_t . (S_in C_t)
                + sum_{t>=r, s<r} seg G [t, s] dt_s D[t, s]

    so ddt_r = x_r . (dx_r / dt_r) + a d(a dt)_r and da = sum_r dt_r d(a dt)_r.
    A ragged tail is padded as ``ssd_chunked`` pads it (dt = 0 and zeros)
    and contributes nothing."""
    inputs = (x, dt, a, b_mat, c_mat)
    bsz, l_orig, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    q = max(1, min(chunk, l_orig))
    pad = (-l_orig) % q
    xf, dtf, af = x.float(), dt.float(), a.float()
    bh = b_mat.float().repeat_interleave(rep, dim=2)     # (B,L,H,N)
    ch = c_mat.float().repeat_interleave(rep, dim=2)
    dyf = dy.float()
    if pad:
        xf, dyf = F.pad(xf, (0, 0, 0, 0, 0, pad)), F.pad(dyf, (0, 0, 0, 0, 0, pad))
        bh, ch = F.pad(bh, (0, 0, 0, 0, 0, pad)), F.pad(ch, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
    nc = (l_orig + pad) // q
    dev = x.device
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))     # [t, s]: s <= t
    # [r, t, s]: t >= r and s < r, the pairs whose segment holds row r's decay
    cross = (torch.arange(q, device=dev)[None, :, None] >= torch.arange(q, device=dev)[:, None, None]) \
        & (torch.arange(q, device=dev)[None, None, :] < torch.arange(q, device=dev)[:, None, None])

    def rows(t, c):
        return t[:, c * q:(c + 1) * q]

    def log_decay(c):
        cs = torch.cumsum(af * rows(dtf, c), dim=1)      # (B,Q,H)
        return cs, cs[:, -1]

    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=dev)
    s_in = []
    for c in range(nc):
        s_in.append(state)
        cs, total = log_decay(c)
        w = torch.exp(total[:, None] - cs) * rows(dtf, c)
        state = state * torch.exp(total)[..., None, None] + torch.einsum(
            "bqhp,bqhn->bhpn", rows(xf, c) * w[..., None], rows(bh, c))

    ds = torch.zeros_like(state) if dstate is None else dstate.float()
    dx, ddt, db, dc = (torch.zeros_like(t) for t in (xf, dtf, bh, ch))
    da = torch.zeros_like(af)
    for c in reversed(range(nc)):
        xc, dtc, bc, cc, dyc = (rows(t, c) for t in (xf, dtf, bh, ch, dyf))
        cs, total = log_decay(c)
        seg = cs[:, :, None, :] - cs[:, None, :, :]      # (B,t,s,H)
        seg = torch.exp(torch.where(tri[None, :, :, None], seg,
                                    torch.full((), MASK_VALUE, device=dev)))
        gs = seg * torch.einsum("bthn,bshn->btsh", cc, bc)
        dxy = torch.einsum("bthp,bshp->btsh", dyc, xc)
        hs = seg * dxy
        w = torch.exp(total[:, None] - cs)               # (B,Q,H): exp(cs_Q - cs_s)
        dxs = w[..., None] * torch.einsum("bhpn,bshn->bshp", ds, bc)
        dxr = torch.einsum("btsh,bthp->bshp", gs, dyc) + dxs
        dx[:, c * q:(c + 1) * q] = dtc[..., None] * dxr
        db[:, c * q:(c + 1) * q] = dtc[..., None] * (
            torch.einsum("btsh,bthn->bshn", hs, cc)
            + w[..., None] * torch.einsum("bhpn,bshp->bshn", ds, xc))
        dc_inter = torch.exp(cs)[..., None] * torch.einsum("bhpn,bthp->bthn", s_in[c], dyc)
        dc[:, c * q:(c + 1) * q] = dc_inter + torch.einsum("btsh,bshn->bthn", hs,
                                                           dtc[..., None] * bc)
        state_term = dtc * (xc * dxs).sum(-1)            # (B,Q,H)
        prefix = F.pad(torch.cumsum(state_term, dim=1)[:, :-1], (0, 0, 1, 0))   # s < r
        inter = (cc * dc_inter).sum(-1)
        suffix = torch.flip(torch.cumsum(torch.flip(inter, (1,)), dim=1), (1,))  # t >= r
        crossed = torch.einsum("rts,btsh->brh", cross.float(), gs * dtc[:, None] * dxy)
        e0 = torch.exp(total) * (ds * s_in[c]).sum((-1, -2))                    # (B,H)
        dadt = e0[:, None] + prefix + suffix + crossed
        ddt[:, c * q:(c + 1) * q] = (xc * dxr).sum(-1) + af * dadt
        da = da + (dtc * dadt).sum((0, 1))
        ds = torch.exp(total)[..., None, None] * ds + torch.einsum(
            "bthp,bthn->bhpn", dyc, cc * torch.exp(cs)[..., None])
    db = db.reshape(bsz, -1, g, rep, n).sum(3)
    dc = dc.reshape(bsz, -1, g, rep, n).sum(3)
    grads = (dx[:, :l_orig], ddt[:, :l_orig], da, db[:, :l_orig], dc[:, :l_orig])
    return _grad_dtypes(grads, inputs)
