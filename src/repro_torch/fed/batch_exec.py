"""Batched client execution: one program per COLLECT wave.

The port of ``repro.fed.batch_exec.BatchedExecutor``.  A *wave* of clients'
local training runs as one program over a stacked parameter tree whose
leaves carry a leading client axis:

* **dense** — every client in the wave has the same batch shape.  For the
  MLP (without the local tower) the wave's rows form one block of ``C``
  equal segments and every dense layer is one batched matmul
  (``torch.bmm``) over the client axis.  Every other model (``cnn``,
  ``resnet``, ``lstm``, the MLP with its local tower) maps the per-client
  step of ``repro_torch.fed.client.build_step_fn`` over the client axis
  with ``torch.func.vmap``, on per-client inputs that keep their shape
  (``(C, B, H, W, Ch)`` images, ``(C, B, S)`` tokens), as the reference
  vmaps its step.  With a ``mesh`` both dense programs run under
  ``repro_torch.dist.shard_map`` with the client axis split over the
  axes the ``"clients"`` rule names (``DEFAULT_CLIENT_RULES``: the batch
  axes), the wave padded to divisibility with copies of its last client:
  every rank pulls every client's batches, trains its slice of clients,
  and the deltas and metrics are all-gathered, so every rank returns the
  whole wave, as the reference's global view does.
* **ragged** — clients have *different* per-step batch sizes (MLP kind
  without the local tower, as in the reference): each step's examples are
  concatenated into one row block sorted by client, and every dense layer
  is a grouped matmul with clients as the groups
  (``repro_torch.kernels.grouped_matmul``: the Hopper kernels on a CUDA
  device).  Group sizes and row→client segment ids stay on the device, so
  one program serves every wave with the same (clients, steps, rows,
  width) envelope regardless of how the rows split.  Zero-row clients are
  legal (their loss, metrics and delta are exactly zero).
* **seq** — single-client waves (identical to ``FLClient.train_local`` by
  construction) and waves whose batch geometry varies run the cached
  ``make_small_step`` per client.

The ragged and seq modes ignore the mesh, as the reference's do: they run
whole on every rank.

In the two MLP programs the loss is the sum of the per-client losses, so
the gradient of the stacked tree is every client's own gradient; per-client
CE and accuracy come from segment sums (``index_add``).  In every batched
program the clip and the optimizer run client by client through
``torch.func.vmap`` (``opt.init``, ``opt.update``), as in the reference:
an update rule may reduce over a whole leaf (``adafactor``'s RMS clip), so
a rule applied to the stacked tree would mix clients.

Batches are pulled from each client's ``ClientDataset`` *in client order
before execution*, which advances the per-client shuffling RNG exactly as
the sequential loop does — so batched and sequential runs see identical
data.  Summation order differs between the modes, so they agree to float
tolerance, not bit for bit.

Eager PyTorch compiles nothing, so the wave function is built afresh for
every wave; :class:`WaveStats` still counts wave *envelopes* as the JAX
package counts its compiled programs: ``compiles`` is the number of
distinct envelopes and ``cache_hits`` the waves that reuse one.  Waves,
clients, envelopes and fallbacks are mirrored onto an observability plane
(``obs=``) as the ``client.batch_*`` counters, scoped by ``tenant``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.aggregation import tree_sub
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.mesh_utils import axis_sizes
from repro_torch.dist.shard_map import all_gather, shard_map
from repro_torch.dist.sharding import P
from repro_torch.fed.client import (
    CLIP_NORM, batch_to, build_step_fn, host_to, make_small_step)
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.models.small import SmallModelConfig, cross_entropy_rows
from repro_torch.obs.metrics import Counter
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any

#: default logical→physical rule for the wave's client axis: clients are
#: data parallelism, so the wave spreads over the batch axes.
DEFAULT_CLIENT_RULES: Dict[str, Tuple[str, ...]] = {"clients": ("pod", "data")}


@dataclass
class WaveStats:
    """Cumulative executor accounting."""

    waves: int = 0            # run_wave calls
    clients: int = 0          # clients that entered any wave
    dense_clients: int = 0    # trained through a dense (bmm or vmap) program
    ragged_clients: int = 0   # trained through the grouped_matmul path
    seq_clients: int = 0      # fell back to the sequential path
    compiles: int = 0         # distinct wave envelopes seen
    cache_hits: int = 0       # waves whose envelope was seen before

    def as_dict(self) -> Dict[str, int]:
        return {k: getattr(self, k) for k in (
            "waves", "clients", "dense_clients", "ragged_clients",
            "seq_clients", "compiles", "cache_hits")}


def _dense_matmul(h: torch.Tensor, w: torch.Tensor, _gs) -> torch.Tensor:
    """Equal client segments: (C·B, K) x (C, K, N) -> (C·B, N)."""
    dtype = torch.promote_types(h.dtype, w.dtype)
    c, k, n = w.shape
    return torch.bmm(h.to(dtype).reshape(c, -1, k), w.to(dtype)).reshape(-1, n)


def _clip(grads: PyTree) -> PyTree:
    return clip_by_global_norm(grads, CLIP_NORM)[0]


class BatchedExecutor:
    """Runs waves of clients' local training as single programs on
    ``device`` (the CUDA card unless ``device="cpu"``).

    Parameters mirror what the sequential path derives from ``FedConfig``:
    the model config, the (cacheable) optimizer and the FedProx ``prox_mu``.
    ``mesh``/``rules`` (a ``DeviceMesh`` of ``device``'s type, and rules
    overriding ``DEFAULT_CLIENT_RULES``) shard the dense wave's client axis.
    """

    def __init__(
        self,
        mcfg: SmallModelConfig,
        opt: Optimizer,
        prox_mu: float = 0.0,
        *,
        device: DeviceLike = None,
        mesh=None,
        rules: Optional[dict] = None,
        obs=None,
        tenant: str = "batch",
    ):
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for an executor on {self.device}")
        self.mesh = mesh
        self.rules = rules
        self.mcfg = mcfg
        self.opt = opt
        self.prox_mu = float(prox_mu)
        self.stats = WaveStats()
        self._envelopes: Set[tuple] = set()
        self.last_wave: Dict[str, Any] = {}
        reg = obs.registry if obs is not None else None
        self._c_waves = reg.counter("client.batch_waves", tenant) if reg else Counter()
        self._c_clients = reg.counter("client.batch_clients", tenant) if reg else Counter()
        self._c_compiles = reg.counter("client.batch_compiles", tenant) if reg else Counter()
        self._c_fallbacks = reg.counter("client.batch_fallbacks", tenant) if reg else Counter()
        # the MLP without its local tower has the bmm/gmm formulation
        self._stacked_mlp = mcfg.kind == "mlp" and not mcfg.extra_local_model

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def run_wave(
        self,
        global_params: PyTree,
        clients: Sequence[Any],
        n_steps: int,
        round_idx: int = 0,
    ) -> List[Tuple[PyTree, float, Dict[str, float]]]:
        """Train every client in ``clients`` for ``n_steps`` local steps
        from ``global_params``; returns ``(delta, n_seen, metrics)`` per
        client, in client order — the contract of ``FLClient.train_local``
        looped sequentially.  ``round_idx`` is the reference's per-client
        RNG root; no ported step draws random numbers."""
        if not clients:
            return []
        self.stats.waves += 1
        self._c_waves.inc()
        self.stats.clients += len(clients)
        self._c_clients.inc(len(clients))
        # pull every client's batches up front, in client order — consumes
        # each ClientDataset's shuffle RNG exactly as the sequential loop
        pulled = [list(c.data.batches(n_steps)) for c in clients]
        mode = ("seq" if len(clients) == 1 or n_steps <= 0
                else self._pick_mode(pulled))
        self.last_wave = {"mode": mode, "clients": len(clients),
                          "cache_hit": None}
        if mode == "dense":
            self.stats.dense_clients += len(clients)
            if self._stacked_mlp:
                return self._run_stacked(mode, global_params, pulled)
            return self._run_vmapped(global_params, pulled)
        if mode == "ragged":
            self.stats.ragged_clients += len(clients)
            return self._run_stacked(mode, global_params, pulled)
        self.stats.seq_clients += len(clients)
        self._c_fallbacks.inc(len(clients))
        return [self._run_sequential(global_params, c, bl)
                for c, bl in zip(clients, pulled)]

    # ------------------------------------------------------------------
    # mode selection
    # ------------------------------------------------------------------

    def _pick_mode(self, pulled) -> str:
        shapes = set()
        for bl in pulled:
            x0 = np.asarray(bl[0]["x"])
            sig = (x0.shape, x0.dtype, bl[0]["y"].shape)
            for b in bl[1:]:
                if (b["x"].shape, np.asarray(b["x"]).dtype, b["y"].shape) != sig:
                    return "seq"  # batch geometry varies across a client's steps
            shapes.add(sig)
        if len(shapes) == 1 and pulled[0][0]["x"].shape[0] > 0:
            return "dense"
        # ragged: MLP rows flatten to one feature width; clients become
        # grouped_matmul groups
        if self._stacked_mlp:
            widths = {int(np.prod(bl[0]["x"].shape[1:])) for bl in pulled}
            dtypes = {str(np.asarray(bl[0]["x"]).dtype) for bl in pulled}
            if len(widths) == 1 and len(dtypes) == 1:
                return "ragged"
        return "seq"

    # ------------------------------------------------------------------
    # sequential fallback (identical to FLClient.train_local)
    # ------------------------------------------------------------------

    def _run_sequential(self, global_params, client, batches):
        step = make_small_step(self.mcfg, self.opt, self.prox_mu)
        params = global_params
        opt_state = self.opt.init(params)
        metrics: Dict[str, Any] = {}
        for b in batches:
            params, opt_state, metrics = step(
                params, opt_state, batch_to(b, self.device), global_params)
        delta = tree_sub(params, global_params)
        n_seen = len(batches) * client.data.batch_size
        return delta, float(n_seen), {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------------
    # envelope accounting
    # ------------------------------------------------------------------

    def _note_envelope(self, key: tuple) -> None:
        hit = key in self._envelopes
        self._envelopes.add(key)
        self.stats.cache_hits += hit
        self.stats.compiles += not hit
        if not hit:
            self._c_compiles.inc()
        self.last_wave["cache_hit"] = hit

    # ------------------------------------------------------------------
    # the dense wave's client axis under the mesh
    # ------------------------------------------------------------------

    def _wave_partition(self) -> Tuple[Any, int]:
        """(PartitionSpec entry, shard count) for the wave's client axis
        under the mesh + logical rules."""
        rules = dict(DEFAULT_CLIENT_RULES)
        if self.rules:
            rules.update(self.rules)
        rule = rules.get("clients")
        if isinstance(rule, str):
            rule = (rule,)
        sizes = axis_sizes(self.mesh)
        axes = tuple(a for a in (rule or ()) if a in sizes)
        n = 1
        for a in axes:
            n *= sizes[a]
        if not axes or n == 1:
            return None, 1
        return (axes[0] if len(axes) == 1 else axes), n

    def _partition(self) -> Tuple[Any, int]:
        return self._wave_partition() if self.mesh is not None else (None, 1)

    def _on_mesh(self, program: Callable, entry, anchor, sharded, replicated=()):
        """``program(anchor, *sharded, *replicated)`` with each ``sharded``
        (tensor, client dim) split over ``entry`` of the mesh, every rank on
        its slice of the clients; its outputs (client axis first) are
        all-gathered in the body, so every rank returns the whole wave's."""
        from torch.distributed.tensor import DTensor, Replicate

        mesh = self.mesh
        whole = tuple(Replicate() for _ in axis_sizes(mesh))

        def everywhere(t):   # every rank holds the same tensor
            return DTensor.from_local(t, mesh, whole, run_check=False)

        def wave(*args):
            return tree_map(lambda t: all_gather(t, entry, dim=0), program(*args))

        specs = (P(), *(P(*(None,) * dim, entry) for _, dim in sharded),
                 *(P() for _ in replicated))
        out = shard_map(wave, mesh, in_specs=specs, out_specs=P())(
            tree_map(everywhere, anchor), *(everywhere(t) for t, _ in sharded),
            *(everywhere(t) for t in replicated))
        return tree_map(lambda d: d.to_local(), out)

    # ------------------------------------------------------------------
    # the stacked wave program (dense and ragged share it)
    # ------------------------------------------------------------------

    def _build_stacked(self, C: int, matmul: Callable) -> Callable:
        """A wave program over ``C`` clients: ``matmul(h, w, gs)`` is one
        dense layer of every client at once over the wave's row block."""
        opt, mu = self.opt, self.prox_mu

        def loss_fn(sp, anchor, x, y, gs, seg, denom):
            h = x
            for lyr in sp["main"]["layers"]:
                h = torch.relu(matmul(h, lyr["w"], gs) + lyr["b"][seg])
            head = sp["main"]["head"]
            logits = matmul(h, head["w"], gs) + head["b"][seg]
            zeros = logits.new_zeros(C, dtype=torch.float32)
            ce_c = zeros.index_add(0, seg, cross_entropy_rows(logits, y).float()) / denom
            hit = (torch.argmax(logits, -1) == y).float()
            acc_c = zeros.index_add(0, seg, hit) / denom
            loss_c = ce_c
            if mu > 0.0:
                sq_c = sum(
                    torch.sum(torch.square(p.float() - a[None].float()),
                              dim=tuple(range(1, p.dim())))
                    for p, a in zip(tree_leaves(sp), tree_leaves(anchor))
                )
                loss_c = loss_c + 0.5 * mu * sq_c
            # total = Σ_c loss_c: grads w.r.t. the stacked params are the
            # per-client grads (client c's slice only sees client c's rows)
            return torch.sum(loss_c), {"ce": ce_c, "acc": acc_c, "loss": loss_c}

        init, clip, update = (torch.func.vmap(f) for f in (opt.init, _clip, opt.update))

        def wave(anchor, xs, ys, gs, seg):
            denom = torch.clamp(gs, min=1).float()
            sp = tree_map(lambda g: g.expand(C, *g.shape).clone(), anchor)
            ost = init(sp)
            metrics: Dict[str, torch.Tensor] = {}
            for x, y in zip(xs, ys):
                sp = tree_map(torch.Tensor.requires_grad_, sp)
                with torch.enable_grad():
                    total, metrics = loss_fn(sp, anchor, x, y, gs, seg, denom)
                    grads = torch.autograd.grad(total, tree_leaves(sp))
                with torch.no_grad():
                    grads = clip(tree_unflatten(sp, grads))
                    sp, ost = update(grads, ost, tree_map(torch.Tensor.detach, sp))
            delta = tree_map(lambda p, g: p - g[None].to(p.dtype), sp, anchor)
            return delta, {k: v.detach() for k, v in metrics.items()}

        return wave

    def _run_stacked(self, mode, global_params, pulled):
        """Assemble the wave's rows and run its program: ``mode`` "dense"
        (equal segments, ``torch.bmm``; the client axis over the mesh) or
        "ragged" (grouped matmul)."""
        C, S = len(pulled), len(pulled[0])
        entry, nshard = self._partition() if mode == "dense" else (None, 1)
        # mesh divisibility: repeat the last client as filler
        pulled_pad = pulled + [pulled[-1]] * ((-C) % nshard)
        Cp = len(pulled_pad)
        sizes = np.array([bl[0]["x"].shape[0] for bl in pulled_pad], np.int64)
        width = int(np.prod(pulled[0][0]["x"].shape[1:]))  # same for all (checked)
        xs = np.stack([
            np.concatenate([np.asarray(pulled_pad[c][s]["x"]).reshape(sizes[c], width)
                            for c in range(Cp)])
            for s in range(S)
        ])                                                      # (S, M, D)
        ys = np.stack([
            np.concatenate([np.asarray(pulled_pad[c][s]["y"]) for c in range(Cp)])
            for s in range(S)
        ])                                                      # (S, M)
        # one envelope per (C, S, M, D), whatever the row split: sizes are
        # device data
        self._note_envelope((mode, Cp, xs.shape[1:], str(xs.dtype), str(ys.dtype), entry))
        matmul = grouped_matmul if mode == "ragged" else _dense_matmul
        dev = self.device
        gs = torch.from_numpy(sizes.astype(np.int32)).to(dev)
        xs, ys = host_to(xs, dev), host_to(ys, dev).long()
        if entry is None:
            seg = torch.from_numpy(np.repeat(np.arange(Cp), sizes)).to(dev)
            deltas, metrics = self._build_stacked(Cp, matmul)(global_params, xs, ys, gs, seg)
        else:   # equal segments: a rank's clients are a block of rows
            local = Cp // nshard
            seg = torch.from_numpy(np.repeat(np.arange(local), sizes[:local])).to(dev)
            deltas, metrics = self._on_mesh(self._build_stacked(local, matmul), entry,
                                            global_params, ((xs, 1), (ys, 1), (gs, 0)), (seg,))
        return self._split(deltas, metrics, pulled)

    # ------------------------------------------------------------------
    # the vmapped dense program (every model but the stacked MLP)
    # ------------------------------------------------------------------

    def _run_vmapped(self, global_params, pulled):
        """Every client's step of ``build_step_fn`` at once through
        ``torch.func.vmap``: params, optimizer state and batches carry the
        client axis (over the mesh, if any); the anchor (the globals) is
        shared."""
        C = len(pulled)
        entry, nshard = self._partition()
        pulled_pad = pulled + [pulled[-1]] * ((-C) % nshard)   # filler: the last client
        xs = np.stack([np.stack([np.asarray(b["x"]) for b in bl])
                       for bl in pulled_pad])                   # (C, S, B, ...)
        ys = np.stack([np.stack([np.asarray(b["y"]) for b in bl])
                       for bl in pulled_pad])                   # (C, S, B)
        self._note_envelope(("dense", len(pulled_pad), xs.shape[1:], str(xs.dtype),
                             ys.shape[2:], str(ys.dtype), entry))
        step = torch.func.vmap(build_step_fn(self.mcfg, self.opt, self.prox_mu),
                               in_dims=(0, 0, 0, None))
        init = torch.func.vmap(self.opt.init)

        def wave(anchor, xs, ys):
            c = xs.shape[0]
            sp = tree_map(lambda g: g.expand(c, *g.shape), anchor)
            ost = init(sp)
            metrics: Dict[str, torch.Tensor] = {}
            for s in range(xs.shape[1]):
                sp, ost, metrics = step(sp, ost, {"x": xs[:, s], "y": ys[:, s]}, anchor)
            return tree_map(lambda p, g: p - g[None].to(p.dtype), sp, anchor), metrics

        dev = self.device
        xs, ys = host_to(xs, dev), host_to(ys, dev)
        if entry is None:
            deltas, metrics = wave(global_params, xs, ys)
        else:
            deltas, metrics = self._on_mesh(wave, entry, global_params, ((xs, 0), (ys, 0)))
        return self._split(deltas, metrics, pulled)

    # ------------------------------------------------------------------

    def _split(self, deltas, metrics, pulled):
        """Per-client results: each delta leaf is a view of the client's
        slice of the stacked tree (it stays on the device); the metrics
        come to the host in one transfer per metric."""
        metrics = {k: v.cpu().tolist() for k, v in metrics.items()}
        out = []
        for i, bl in enumerate(pulled):
            delta = tree_map(lambda a, _i=i: a[_i], deltas)
            m = {k: float(v[i]) for k, v in metrics.items()}
            n_seen = len(bl) * (bl[0]["x"].shape[0] if bl else 0)
            out.append((delta, float(n_seen), m))
        return out
