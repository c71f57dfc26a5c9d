"""A max-pool decision at a near tie, in both packages: the mechanism of
the local tower's drift for client 58 (ROADMAP queue 3, now under its
deliberate divergences).

``tools/torch_client_twin.py --decisions 58`` read it on the card: at
local step 2, float32 rounding (on the card and on the CPU alike) takes 2
of the step's 3,936,256 ReLU and max-pool decisions otherwise than
float64; the local tower's conv gradients then differ by 2.5e-3-5.6e-3,
and forcing the card's decisions on the float64 run brings it within
2.3e-6 of the card after 10 steps.  Here the CNN's first convolution
passes channel 0 of the image through unchanged, and one 2 x 2 pooling
window holds two values one ulp apart: moving the larger one down by two
ulps (a relative change of 1.6e-7 of the input) moves the pooled argmax
to its neighbour, and the first convolution's weight gradient moves by
2.3e-2, relative, five orders of magnitude more.  The port and the reference take the same
decision on either side, and their gradients agree there.
"""
import jax
import numpy as np
import torch

from repro.ckpt.checkpoint import _flatten as ref_flatten
from repro.models import small as ref_small
from repro_torch.bridge import flatten, params_from_numpy
from repro_torch.models import small
from repro_torch.tree import tree_map

from _torch_worlds import kind_cfgs, max_tree_diff

#: the first convolution's weight gradient, relative, between the two sides
#: of the near tie (the input moved by two ulps at one pixel): 2.3e-2 here
MIN_GRADIENT_GAP = 1e-2


def _near_tie(upper: bool):
    """(params, x, y): conv 0 copies image channel 0 to its channel 0;
    pixels (0, 0) and (0, 1) of image 0 are ``a`` and ``a`` one ulp above
    (``upper``) or below it, the other two of their window lower."""
    ref_cfg, cfg = kind_cfgs("cnn")
    params = jax.device_get(ref_small.init_small(jax.random.PRNGKey(1), ref_cfg))
    params = jax.tree.map(np.array, params)
    conv = params["main"]["convs"][0]
    w = np.zeros_like(conv["w"])
    w[1, 1, 0, 0] = 1.0                                  # the centre tap, HWIO
    conv["w"], conv["b"] = w, np.zeros_like(conv["b"])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, cfg.image_size, cfg.image_size, cfg.channels)).astype(np.float32)
    a = np.float32(1.5)
    x[0, 0, 0, 0] = a
    x[0, 0, 1, 0] = np.nextafter(a, np.float32(np.inf if upper else -np.inf))
    x[0, 1, 0, 0] = x[0, 1, 1, 0] = np.float32(0.25)
    y = rng.integers(0, cfg.n_classes, size=2).astype(np.int32)
    return ref_cfg, cfg, params, x, y


def _port_grads(cfg, params, x, y):
    port = tree_map(lambda t: t.requires_grad_(), params_from_numpy(params, "cpu"))
    loss, _ = small.small_loss(port, cfg, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    loss.backward()
    return flatten(tree_map(lambda t: t.grad, port))


def _ref_grads(ref_cfg, params, x, y):
    g = jax.grad(lambda p: ref_small.small_loss(p, ref_cfg, {"x": x, "y": y})[0])(params)
    return ref_flatten(jax.device_get(g))


def test_a_one_ulp_near_tie_flips_the_max_pool_and_its_gradient():
    grads, pooled = {}, {}
    for upper in (True, False):
        ref_cfg, cfg, params, x, y = _near_tie(upper)
        h = torch.relu(small._conv_nchw(params_from_numpy(params["main"]["convs"][0], "cpu"),
                                        torch.from_numpy(x).permute(0, 3, 1, 2)))
        _, idx = torch.nn.functional.max_pool2d(h, 2, 2, return_indices=True)
        pooled[upper] = int(idx[0, 0, 0, 0])             # flat index in the 2-D plane
        got, want = _port_grads(cfg, params, x, y), _ref_grads(ref_cfg, params, x, y)
        assert max_tree_diff(got, want) < 1e-4           # the packages agree on each side
        grads[upper] = got
    assert pooled == {True: 1, False: 0}                 # the decision flips with the ulp
    key = "main/convs/[0]/w"
    a, b = grads[True][key], grads[False][key]
    gap = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    assert gap > MIN_GRADIENT_GAP, gap
    # everything above the first pooling sees values one ulp apart
    for k in ("main/fc/w", "main/head/w"):
        assert float(np.linalg.norm(grads[True][k] - grads[False][k])
                     / np.linalg.norm(grads[False][k])) < 1e-4, k
