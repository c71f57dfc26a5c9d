"""How far the SSD scan's f32 backwards land from an f64 one, on the CPU.

At mamba2-1.3b's head and state sizes (P = 64, N = 128) and three lengths
(256 rows under a strong decay, a = -exp(normal + 2); 300; 1,000), for a
cotangent of y and of the final state, it prints each gradient's largest
elementwise excess over the reference's 1e-4 allclose (|error| / (1e-4 +
1e-4 |want|): above 1 the allclose fails) of two f32 backwards against the
plain backward run in f64 (``ref.ssd_bwd_ref`` on f64 inputs):

* ``ref.ssd_bwd_ref`` in f32 at the model's ``ssm_chunk`` (256), the
  plain version the reference's custom VJP differentiates;
* ``ref.ssd_bwd_chunked`` at 32 rows, the loop of the backward kernels
  (``csrc/ssd_scan_bwd.cu``) written out.

Then mamba2-1.3b at full width cut to 2 layers in f32, one batch of 8 x 128
tokens: the global relative L2 between the loss's gradients with the scan's
backward on ``ssd_bwd_chunked`` and on torch's autograd through
``ssd_chunked`` (the CPU route of ``ssm_impl="pallas"``); the card's kernels
are held to the same pair in ``chip_smoke.py`` phase 31 (d).

Run from the root of the repo (CPU only; ~1 min):

    PYTHONPATH=src python tools/torch_ssd_bwd_precision.py

The last line of its output is one JSON object with every reading.
"""
from __future__ import annotations

import json
import math

import torch

from repro_torch.configs.base import LayerGroup
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import TokenDataset
from repro_torch.data.synthetic import make_lm_tokens
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.models.registry import model_fns, value_and_grad
from repro_torch.tree import tree_leaves

GRADS = ("dx", "ddt", "da", "dB", "dC")
CASES = [(1, 256, 4, 64, 1, 128, True), (1, 300, 4, 64, 1, 128, False),
         (2, 1000, 2, 64, 1, 128, False)]   # (B, L, H, P, G, N, strong decay)


def over_tol(got, want, tol=1e-4):
    return float(((got.double() - want).abs() / (tol + tol * want.abs())).max())


def scan_inputs(case, seed=1):
    b, l, h, p, g, n, strong = case
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)

    return (rnd(b, l, h, p), torch.nn.functional.softplus(rnd(b, l, h)),
            -torch.exp(rnd(h) + (2.0 if strong else 0.0)), rnd(b, l, g, n), rnd(b, l, g, n),
            rnd(b, l, h, p), rnd(b, h, p, n))


class ChunkedBackward(torch.autograd.Function):
    """``ssd_chunked``'s forward with ``ssd_bwd_chunked`` as its backward."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat):
        ctx.save_for_backward(x, dt, a, b_mat, c_mat)
        return ref.ssd_chunked(x, dt, a, b_mat, c_mat, chunk=32)

    @staticmethod
    def backward(ctx, dy, dstate):
        return ref.ssd_bwd_chunked(*ctx.saved_tensors, dy, dstate)


def model_gap():
    cfg = get_config("mamba2-1.3b")
    cfg = cfg.replace(n_layers=2, groups=(LayerGroup(cfg.groups[0].pattern, 2),),
                      compute_dtype="float32")
    fns = model_fns(cfg)
    params, _ = fns.init(torch.Generator().manual_seed(0), "cpu")
    data = TokenDataset(make_lm_tokens(200_000, cfg.vocab_size, seed=0), 128, 8, seed=0)
    batch = {"tokens": torch.from_numpy(data.next_batch()["tokens"])}
    _, plain = value_and_grad(fns.loss, params, batch)
    real = ops.ssd
    ops.ssd = lambda x, dt, a, b_mat, c_mat, **kw: ChunkedBackward.apply(
        x, dt.float(), a.float(), b_mat, c_mat)
    try:
        _, chunked = value_and_grad(fns.loss, params, batch)
    finally:
        ops.ssd = real
    num = sum(float((u - v).square().sum()) for u, v in zip(tree_leaves(chunked), tree_leaves(plain)))
    return math.sqrt(num / sum(float(v.square().sum()) for v in tree_leaves(plain)))


def main():
    rows = []
    for case in CASES:
        *scan, dy, ds = scan_inputs(case)
        truth = ref.ssd_bwd_ref(*scan, dy, ds, chunk=256)
        f32 = [t.float() for t in (*scan, dy, ds)]
        row = {"case": list(case),
               "autograd_f32_chunk256": [over_tol(g, w) for g, w in zip(
                   ref.ssd_bwd_ref(*f32[:6], f32[6], chunk=256), truth)],
               "chunked_f32_32rows": [over_tol(g, w) for g, w in zip(
                   ref.ssd_bwd_chunked(*f32[:6], f32[6]), truth)]}
        rows.append(row)
        for key in ("autograd_f32_chunk256", "chunked_f32_32rows"):
            print(f"{str(case):<36} {key:<22} " + " ".join(
                f"{name} {e:.3f}" for name, e in zip(GRADS, row[key])), flush=True)
    gap = model_gap()
    print(f"mamba2-1.3b, 2 layers, f32: gradients' global relative L2, the chunked backward "
          f"against autograd through ssd_chunked: {gap:.3e}")
    print(json.dumps({"scan": rows, "mamba2_2_layers_grad_rel_l2": gap}))


if __name__ == "__main__":
    main()
