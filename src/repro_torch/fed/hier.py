"""Hierarchical aggregation tree: multi-tier fan-in over the FedHC wire.

The port of ``repro.fed.hier``: numpy and pure Python, copied, with the
reference's integer arithmetic unchanged, so bins, payloads and digests are
the reference's bit for bit.  Two seams differ.  A bf16 leaf is a CPU
``torch.bfloat16`` (the codec's only bf16 form, ``repro_torch.fed.transport``)
and is read through its bit pattern, so it widens exactly and hashes as the
reference's ``ml_dtypes`` bf16 does.  int8's rounding noise is the port's own
(``repro_torch.fed.compression``) unless a ``noise=`` is injected: the
reference draws it from ``jax.random``.  Nothing here touches an accelerator.

``repro_torch.fed.net`` fans every client into one accept loop; this module
stacks a tree of aggregator nodes on top of the *same* 4-method
``Transport`` surface so fan-in scales with tier width instead of a
single socket loop (FedML Parrot / Flower's scalable-server design —
see PAPERS.md).  Three pieces:

* **ExactAccumulator** — an integer superaccumulator (72 int64 bins, 32
  value bits per bin, grid base 2^-1152) that folds fp32 / bf16 / int8-
  and topk-compressed deltas *exactly*: every addend is decomposed into
  two ≤27-bit integer mantissa halves and scattered onto the bin grid,
  so partial sums are plain int64 adds — associative, order-independent,
  and therefore **bit-identical** for any tree shape, flat included.
  ``finalize_mean`` rounds once, at the root.
* **PARTIAL_SUM wire form** — a leaf ships ``count + weight + windowed
  sign-magnitude bins`` (int64/int8 segments ride the v2 wire natively);
  root reduction is ``bins += bins``.  ``docs/wire-protocol.md``
  § Hierarchical aggregation is the normative spec.
* **LeafAggregator / RootAggregator** — FLServer-driven nodes: the leaf
  terminates thousands of client sessions (async accept loop in
  ``repro_torch.fed.net``), folds uploads in their native quantized domain,
  and answers the root's ``TRAIN`` with one ``PARTIAL_SUM``; the root
  broadcasts content-addressed params (framed once per leaf pod via
  ``CachedSegments``, re-broadcast to clients from the leaf's
  ``ChunkStore``) and merges leaf partials in sorted-leaf order.

The simulated-client half (``SimWorker`` / ``synth_delta``) exists so a
100k-client campaign is testable in seconds: deltas are a pure integer
hash of ``(path, round, client)``, independent of the current params, so
flat and tree runs see identical addends by construction and the test
isolates exactly what this module claims — the aggregation path.
"""
from __future__ import annotations

import hashlib
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fed.compression import Noise, compress_tree
from repro_torch.fed.server import FLServer, RoundPolicy  # noqa: F401 (re-export)
from repro_torch.fed.transport import (
    _BF16,
    CachedSegments,
    Message,
    MsgType,
    QuantizedTensor,
    TopKTensor,
    _wire_array,
    precompute_segments,
)
from repro_torch.obs.metrics import Counter

__all__ = [
    "NBINS",
    "GRID_LO",
    "RoundPolicy",
    "ExactAccumulator",
    "ChunkStore",
    "LeafAggregator",
    "RootAggregator",
    "SimWorker",
    "params_digest",
    "tree_add",
    "synth_delta",
    "synth_delta_batch",
    "sim_weight",
    "drive_sim_clients",
    "run_leaf",
    "run_root_campaign",
    "run_flat_campaign",
    "aggregate_tree_sim",
]

# --------------------------------------------------------------------------
# Exact superaccumulator
# --------------------------------------------------------------------------
#
# Bin grid: NBINS int64 bins per scalar, bin k worth 2^(32*k + GRID_LO).
# GRID_LO = -1152 puts the lowest fp64-subnormal contribution (2^-1126
# after the mantissa split) at t = p - GRID_LO >= 26 >= 0, and the
# largest fp64 exponent (e = 1024 -> p = 998) at bin k = 67, spilling at
# most into k+2 = 69 < 72.  Each bin holds a signed 32-bit "digit" plus
# 31 bits of carry headroom, so ~2^26 raw folds fit before a normalize.

NBINS = 72
GRID_LO = -1152
_MASK32 = np.int64(0xFFFFFFFF)
_ADDS_LIMIT = 1 << 26


def _flatten(tree: Any, _path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """Pytree -> sorted [(path, leaf)]: dicts by sorted key, lists/tuples
    by index.  Deterministic for any tree shape (the digest and the
    accumulator structure both key off it)."""
    if isinstance(tree, dict):
        out: List[Tuple[Tuple, Any]] = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], _path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, _path + (i,)))
        return out
    return [(_path, tree)]


def _unflatten(paths: Sequence[Tuple], leaves: Sequence[Any]) -> Any:
    """Inverse of :func:`_flatten`: rebuilds nested dicts; a dict whose
    keys are exactly 0..n-1 ints becomes a list."""
    if len(paths) == 1 and paths[0] == ():
        return leaves[0]
    root: Dict[Any, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    def _listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: _listify(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            ks = sorted(out)
            if ks == list(range(len(ks))):
                return [out[k] for k in ks]
        return out
    return _listify(root)


def _leaf_to_f64(leaf: Any) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """One delta leaf -> (flat float64, dense shape), **exactly**.

    fp32/bf16/fp16 -> f64 is exact (wider format).  int8 dequant is exact
    because ``scale`` is fp32 (24-bit mantissa) and ``|q| <= 127`` (7
    bits): the product has <= 31 significant bits < 53.  topk scatters
    fp32 values onto a dense zero grid (indices are unique by
    construction).  Non-finite addends would make the integer
    decomposition undefined, so they are rejected here."""
    if isinstance(leaf, QuantizedTensor):
        q = np.asarray(leaf.q)
        d = q.astype(np.float64) * np.float64(np.float32(leaf.scale))
        shape = q.shape
    elif isinstance(leaf, TopKTensor):
        shape = tuple(int(s) for s in leaf.shape)
        d = np.zeros(int(np.prod(shape)) if shape else 1, np.float64)
        d[np.asarray(leaf.idx, np.int64)] = np.asarray(
            leaf.vals, np.float32).astype(np.float64)
    else:
        d = _dense_f64(leaf)
        shape = d.shape
    d = np.ascontiguousarray(d).reshape(-1)
    if not np.isfinite(d).all():
        raise ValueError("non-finite delta leaf cannot be folded exactly")
    return d, tuple(int(s) for s in shape)


def _dense_f64(leaf: Any) -> np.ndarray:
    """A dense leaf (numpy, or a CPU ``torch.bfloat16``) as float64,
    exactly: a bf16 leaf's 16 bits are the top half of its fp32 value.  Any
    other ``torch.Tensor`` raises ``TypeError``, as the codec does."""
    a, name = _wire_array(leaf)
    if name == _BF16:
        a = (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float64)


def _decompose(d: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                       np.ndarray, np.ndarray]:
    """f64 array -> two integer mantissa halves + their bin-grid
    exponents: ``d == Mhi * 2^(e-26) + Mlo * 2^(e-53)`` with
    ``|Mhi| <= 2^26`` and ``0 <= Mlo < 2^27`` — both exact int64."""
    m, e = np.frexp(d)
    M53 = np.round(m * 9007199254740992.0).astype(np.int64)  # m * 2^53, exact
    Mhi = M53 >> 27               # arithmetic shift == floor division
    Mlo = M53 & np.int64((1 << 27) - 1)
    e = e.astype(np.int64)
    return Mhi, Mlo, e - 26, e - 53


def _scatter(bins: np.ndarray, v: np.ndarray, p: np.ndarray) -> None:
    """Add integer contributions ``v * 2^p`` into the bin grid (single
    addend: one (value, exponent) pair per column, columns unique)."""
    cols = np.arange(bins.shape[1])
    s = np.sign(v)
    a = np.abs(v)
    c0 = a & _MASK32
    c1 = a >> 32                        # < 2^26 for |v| < 2^58
    t = p - GRID_LO
    k = t >> 5
    r = t & 31
    f0 = c0 << r                        # < 2^63: safe
    f1 = c1 << r
    bins[k, cols] += s * (f0 & _MASK32)
    bins[k + 1, cols] += s * ((f0 >> 32) + (f1 & _MASK32))
    bins[k + 2, cols] += s * (f1 >> 32)


def _scatter_batch(bins: np.ndarray, v: np.ndarray, p: np.ndarray) -> None:
    """Batched scatter: ``v``/``p`` are (B, n) — many addends may land in
    the same (bin, column), so this goes through ``np.add.at``."""
    B, n = v.shape
    cols = np.broadcast_to(np.arange(n), (B, n))
    s = np.sign(v)
    a = np.abs(v)
    c0 = a & _MASK32
    c1 = a >> 32
    t = p - GRID_LO
    k = t >> 5
    r = t & 31
    f0 = c0 << r
    f1 = c1 << r
    flat = bins.reshape(-1)
    base = k * n + cols
    np.add.at(flat, base, s * (f0 & _MASK32))
    np.add.at(flat, base + n, s * ((f0 >> 32) + (f1 & _MASK32)))
    np.add.at(flat, base + 2 * n, s * (f1 >> 32))


def _carry(b: np.ndarray) -> None:
    """Normalize in place: every digit below the top bin into [0, 2^32);
    the top bin keeps the sign.  Value-preserving (each step moves
    ``c * 2^32`` one bin up)."""
    for k in range(NBINS - 1):
        c = b[k] >> 32
        b[k] -= c << 32
        b[k + 1] += c


def _canonical(bins: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Bins -> (magnitude digits, negative mask): the unique
    sign-magnitude canonical form of the represented value.  Two
    carry passes: the first exposes the sign in the top bin, the second
    renormalizes the negated columns.  Pure function of the *value*, so
    any representation of the same partial sum canonicalizes
    identically — this is what makes tree shape irrelevant."""
    b = bins.copy()
    _carry(b)
    neg = b[NBINS - 1] < 0
    if neg.any():
        b[:, neg] = -b[:, neg]
        _carry(b)
    return b, neg


def _finalize_leaf(bins: np.ndarray) -> np.ndarray:
    """Canonical bins -> float64 sum per column (deterministic: top three
    digits, 96 bits, folded into f64 — relative truncation < 2^-64)."""
    b, neg = _canonical(bins)
    n = b.shape[1]
    cols = np.arange(n)
    nz = b != 0
    any_nz = nz.any(axis=0)
    h = (NBINS - 1) - np.argmax(nz[::-1], axis=0)
    h = np.maximum(h, 2)
    v = (b[h, cols].astype(np.float64) * 4294967296.0
         + b[h - 1, cols]) * 4294967296.0 + b[h - 2, cols]
    out = np.ldexp(v, (32 * (h - 2) + GRID_LO).astype(np.int64))
    out = np.where(neg, -out, out)
    out[~any_nz] = 0.0
    return out


class ExactAccumulator:
    """Order-independent exact partial sum of weighted delta pytrees.

    ``fold`` adds one client's delta with integer weight ``w``;
    ``merge`` adds another accumulator (a deserialized ``PARTIAL_SUM``);
    ``finalize_mean`` divides by the total weight and rounds to fp32 —
    the only inexact step, performed exactly once, at the root.
    """

    def __init__(self):
        self.paths: Optional[List[Tuple]] = None
        self.shapes: Optional[List[Tuple[int, ...]]] = None
        self.bins: Optional[List[np.ndarray]] = None
        self.count = 0          # clients folded (transitively)
        self.weight = 0         # sum of per-client integer weights
        self._adds = 0          # folds since the last carry-normalize

    def _init_structure(self, paths, shapes) -> None:
        self.paths = [tuple(p) for p in paths]
        self.shapes = [tuple(int(x) for x in s) for s in shapes]
        self.bins = [
            np.zeros((NBINS, int(np.prod(s)) if s else 1), np.int64)
            for s in self.shapes
        ]

    def _check_structure(self, paths, shapes, what: str) -> None:
        if list(self.paths) != [tuple(p) for p in paths] or \
                list(self.shapes) != [tuple(int(x) for x in s) for s in shapes]:
            raise ValueError(f"accumulator structure mismatch in {what}")

    def _guard(self) -> None:
        # each fold adds < 2^34 per bin; 2^26 folds stay under 2^60, and
        # a merge of two guarded accumulators under 2^61 — normalize
        # (value-preserving) long before int64 could overflow
        if self._adds >= _ADDS_LIMIT:
            for b in self.bins or ():
                _carry(b)
            self._adds = 0

    def fold(self, delta: Any, w: int = 1) -> None:
        """Add one client delta (dense fp32/bf16, ``QuantizedTensor`` or
        ``TopKTensor`` leaves) with integer weight ``w``."""
        w = int(w)
        if not 0 <= w < (1 << 31):
            raise ValueError(f"weight {w} outside [0, 2^31)")
        flat = _flatten(delta)
        pairs = [_leaf_to_f64(leaf) for _, leaf in flat]
        if self.bins is None:
            self._init_structure([p for p, _ in flat],
                                 [s for _, s in pairs])
        else:
            self._check_structure([p for p, _ in flat],
                                  [s for _, s in pairs], "fold")
        wi = np.int64(w)
        for b, (d, _shape) in zip(self.bins, pairs):
            Mhi, Mlo, phi, plo = _decompose(d)
            _scatter(b, wi * Mhi, phi)      # |w*Mhi| < 2^57
            _scatter(b, wi * Mlo, plo)      # |w*Mlo| < 2^58
        self.count += 1
        self.weight += w
        self._adds += 1
        self._guard()

    def fold_batch(self, leaves_batch: Sequence[np.ndarray],
                   weights: Sequence[int],
                   template: Optional[Any] = None) -> None:
        """Fold B dense clients at once: ``leaves_batch[i]`` is the i-th
        template leaf (path order) stacked to ``(B, *leaf_shape)``
        (fp32/bf16), ``weights`` the per-client integer weight vector,
        ``template`` the tree whose paths the stacks follow (required on
        the first fold of an empty accumulator).  This is the 100k-client
        path: one vectorized decompose + ``np.add.at`` per tensor instead
        of 100k Python folds."""
        w = np.asarray(weights, np.int64)
        if w.size == 0:
            return
        if (w < 0).any() or (w >= (1 << 31)).any():
            raise ValueError("batch weights outside [0, 2^31)")
        B = int(w.shape[0])
        mats: List[np.ndarray] = []
        shapes: List[Tuple[int, ...]] = []
        for a in leaves_batch:
            arr = _dense_f64(a)
            if arr.shape[0] != B:
                raise ValueError("batch leaf leading dim != len(weights)")
            shapes.append(tuple(int(s) for s in arr.shape[1:]))
            d = arr.reshape(B, -1)
            if not np.isfinite(d).all():
                raise ValueError("non-finite delta leaf in batch")
            mats.append(d)
        if self.bins is None:
            if template is None:
                raise ValueError("first fold_batch needs the template tree")
            self._init_structure([p for p, _ in _flatten(template)], shapes)
        else:
            self._check_structure(self.paths, shapes, "fold_batch")
        wc = w[:, None]
        for b, d in zip(self.bins, mats):
            Mhi, Mlo, phi, plo = _decompose(d)
            _scatter_batch(b, wc * Mhi, phi)
            _scatter_batch(b, wc * Mlo, plo)
        self.count += B
        self.weight += int(w.sum())
        self._adds += B
        self._guard()

    def merge(self, other: "ExactAccumulator") -> None:
        """Exact tree reduction: plain int64 bin adds — associative and
        commutative, so any reduction order/shape yields identical bins."""
        self.count += other.count
        self.weight += other.weight
        if other.bins is None:
            return
        if self.bins is None:
            self.paths = list(other.paths)
            self.shapes = list(other.shapes)
            self.bins = [b.copy() for b in other.bins]
        else:
            self._check_structure(other.paths, other.shapes, "merge")
            for b, ob in zip(self.bins, other.bins):
                b += ob
        self._adds += other._adds + 1
        self._guard()

    def finalize_sum(self) -> Any:
        """Exact (to < 2^-64 relative) float64 sum tree."""
        if self.bins is None:
            raise ValueError("empty accumulator has no sum")
        leaves = [_finalize_leaf(b).reshape(s)
                  for b, s in zip(self.bins, self.shapes)]
        return _unflatten(self.paths, leaves)

    def finalize_mean(self) -> Any:
        """Weighted-mean fp32 tree: the one rounding step, root-only."""
        if self.weight <= 0:
            raise ValueError("cannot take mean with zero total weight")
        wsum = np.float64(self.weight)
        leaves = [
            (_finalize_leaf(b) / wsum).astype(np.float32).reshape(s)
            for b, s in zip(self.bins, self.shapes)
        ]
        return _unflatten(self.paths, leaves)

    # -- PARTIAL_SUM wire form --------------------------------------------

    def to_payload(self) -> Dict[str, Any]:
        """Windowed sign-magnitude wire form (normative spec:
        docs/wire-protocol.md § Hierarchical aggregation).  Digits ship
        canonical and non-negative — a raw signed representation would
        sign-extend negative columns all the way to bin 71 and defeat the
        row window."""
        if self.bins is None:
            return {"count": int(self.count), "weight": int(self.weight),
                    "acc": None}
        paths = [list(p) for p in self.paths]
        shapes = [list(s) for s in self.shapes]
        k0s: List[int] = []
        mags: List[np.ndarray] = []
        signs: List[np.ndarray] = []
        for b in self.bins:
            mag, neg = _canonical(b)
            nzrows = np.flatnonzero((mag != 0).any(axis=1))
            if nzrows.size == 0:
                k0, rows = 0, 0
            else:
                k0 = int(nzrows[0])
                rows = int(nzrows[-1]) - k0 + 1
            k0s.append(k0)
            mags.append(np.ascontiguousarray(mag[k0:k0 + rows]))
            signs.append(np.where(neg, -1, 1).astype(np.int8))
        return {
            "count": int(self.count),
            "weight": int(self.weight),
            "acc": {"paths": paths, "shapes": shapes, "k0": k0s,
                    "bins": mags, "sign": signs},
        }

    @classmethod
    def from_payload(cls, payload: Dict[str, Any]) -> "ExactAccumulator":
        acc = cls()
        acc.count = int(payload["count"])
        acc.weight = int(payload["weight"])
        blob = payload.get("acc")
        if blob is None:
            return acc
        paths = [tuple(p) for p in blob["paths"]]
        shapes = [tuple(int(x) for x in s) for s in blob["shapes"]]
        acc._init_structure(paths, shapes)
        for b, k0, mag, sign in zip(acc.bins, blob["k0"], blob["bins"],
                                    blob["sign"]):
            mag = np.asarray(mag, np.int64)
            if mag.size:
                k0 = int(k0)
                if not (0 <= k0 and k0 + mag.shape[0] <= NBINS
                        and mag.shape[1] == b.shape[1]):
                    raise ValueError("PARTIAL_SUM bin window out of range")
                b[k0:k0 + mag.shape[0]] = (
                    mag * np.asarray(sign, np.int64)[None, :])
        acc._adds = 1
        return acc


# --------------------------------------------------------------------------
# Param trees: digest, update, content-addressed store
# --------------------------------------------------------------------------


def params_digest(tree: Any) -> str:
    """Content address of a param tree: sha256 over path-sorted leaves
    (path, dtype, shape, raw bytes).  Recomputable by every tier, so the
    leaf can verify a chunk it re-broadcasts and a client can verify the
    params it trains on.  A CPU ``torch.bfloat16`` leaf hashes as the
    reference's ``ml_dtypes`` bf16: the name ``bfloat16`` and its 2-byte
    bit patterns."""
    h = hashlib.sha256()
    for path, leaf in _flatten(tree):
        a, dtype = _wire_array(leaf)
        a = np.ascontiguousarray(a)
        h.update(repr(path).encode())
        h.update(dtype.encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def tree_add(params: Any, delta: Any) -> Any:
    """``params + delta`` leaf-wise, preserving params' dtype.  A CPU
    ``torch.bfloat16`` leaf adds as ``ml_dtypes`` bf16 does: the delta
    rounded to bf16, the sum taken in fp32 and rounded once to bf16."""
    pf = _flatten(params)
    df = dict(_flatten(delta))
    leaves = []
    for path, leaf in pf:
        if _wire_array(leaf)[1] == _BF16:
            d = leaf.new_tensor(np.asarray(df[path], np.float32))   # f32 -> bf16, RNE
            leaves.append((leaf.float() + d.float()).to(leaf.dtype))
            continue
        a = np.asarray(leaf)
        leaves.append((a + np.asarray(df[path], a.dtype)).astype(a.dtype))
    return _unflatten([p for p, _ in pf], leaves)


class ChunkStore:
    """Content-addressed param-chunk cache (bounded, newest-kept).

    ``put`` materializes a blob for a new digest (``hier.chunk_misses``);
    a ``get`` that finds its digest is a reuse (``hier.chunk_hits``) —
    the broadcast savings the hierarchy buys."""

    def __init__(self, capacity: int = 4, *, obs=None, scope: str = ""):
        self.capacity = int(capacity)
        self._blobs: Dict[str, Any] = {}
        self._lru: List[str] = []
        reg = obs.registry if obs is not None else None
        self.hits = reg.counter("hier.chunk_hits", scope) if reg else Counter()
        self.misses = (reg.counter("hier.chunk_misses", scope)
                       if reg else Counter())

    def put(self, digest: str, params: Any) -> bool:
        """Store params under their digest; True when newly materialized."""
        if digest in self._blobs:
            return False
        self.misses.inc()
        self._blobs[digest] = params
        self._lru.append(digest)
        while len(self._lru) > self.capacity:
            self._blobs.pop(self._lru.pop(0), None)
        return True

    def get(self, digest: str) -> Optional[Any]:
        params = self._blobs.get(digest)
        if params is not None:
            self.hits.inc()
        return params


# --------------------------------------------------------------------------
# Simulated clients: hash-derived deltas, full wire protocol
# --------------------------------------------------------------------------

_SPLITMIX_A = np.uint64(0x9E3779B97F4A7C15)
_SPLITMIX_B = np.uint64(0xBF58476D1CE4E5B9)
_SPLITMIX_C = np.uint64(0x94D049BB133111EB)


def _splitmix(x: np.ndarray) -> np.ndarray:
    x = x.copy()
    x ^= x >> np.uint64(30)
    x *= _SPLITMIX_B
    x ^= x >> np.uint64(27)
    x *= _SPLITMIX_C
    x ^= x >> np.uint64(31)
    return x


def _leaf_seed(path: Tuple, rnd: int, cid) -> int:
    return ((zlib.crc32(repr(path).encode()) * 0x100000001B3
             + int(rnd) * 0xBF58476D1CE4E5B9 + int(cid) * 0x9E3779B97F4A7C15)
            & 0xFFFFFFFFFFFFFFFF)


def synth_delta(template: Any, rnd: int, cid: int) -> Any:
    """Deterministic pseudo-delta for client ``cid`` at round ``rnd``:
    an integer hash of (leaf path, round, client) mapped to small fp32
    values in ``[-0.01, 0.01)`` — independent of the current params, so
    flat and tree campaigns fold identical addends by construction."""
    flat = _flatten(template)
    leaves = []
    for path, leaf in flat:
        a = np.asarray(leaf)
        n = int(a.size) if a.size else 1
        x = (np.arange(n, dtype=np.uint64) * _SPLITMIX_A
             + np.uint64(_leaf_seed(path, rnd, cid)))
        u = (_splitmix(x) >> np.uint64(11)).astype(np.float64) / (1 << 53)
        leaves.append(((u - 0.5) * 0.02).astype(np.float32).reshape(a.shape))
    return _unflatten([p for p, _ in flat], leaves)


def synth_delta_batch(template: Any, rnd: int,
                      cids: Sequence[int]) -> List[np.ndarray]:
    """Vectorized :func:`synth_delta` over many clients: one stacked
    ``(B, *leaf_shape)`` fp32 array per template leaf, in path order —
    ready for :meth:`ExactAccumulator.fold_batch`."""
    flat = _flatten(template)
    cid_arr = np.asarray(list(cids), np.uint64)
    out = []
    for path, leaf in flat:
        a = np.asarray(leaf)
        n = int(a.size) if a.size else 1
        seeds = np.array([_leaf_seed(path, rnd, int(c)) for c in cid_arr],
                         np.uint64)[:, None]
        x = np.arange(n, dtype=np.uint64)[None, :] * _SPLITMIX_A + seeds
        u = (_splitmix(x) >> np.uint64(11)).astype(np.float64) / (1 << 53)
        out.append(((u - 0.5) * 0.02).astype(np.float32)
                   .reshape((len(cid_arr),) + a.shape))
    return out


def sim_weight(cid: int) -> int:
    """Uneven per-client weights so weighted-mean bugs can't hide."""
    return 1 + (int(cid) % 7)


def _client_delta(template: Any, rnd: int, cid: int, compression: str,
                  noise: Optional[Noise] = None) -> Any:
    delta = synth_delta(template, rnd, cid)
    if compression == "none":
        return delta
    # same seed convention as the real multihost workers: compression
    # randomness depends only on (round, client), never on topology;
    # ``noise`` is int8's (compression.py's seam: the port's by default)
    return compress_tree(delta, compression, seed=int(rnd) * 1000 + int(cid),
                         noise=noise)


class SimWorker:
    """A protocol-complete simulated client: REGISTER → READY → TRAIN →
    TRAIN_DONE → SEND_UPDATE → UPLOAD, re-registering after a plain
    TERMINATE, exiting on reason ``shutdown``.  Verifies the broadcast
    params against the ``params_digest`` the TRAIN instruction carries
    (the content-address integrity check end to end).  ``noise`` is the
    int8 rounding noise of its uploads (the port's by default)."""

    def __init__(self, cid: int, transport, template: Any, *,
                 verify_digest: bool = True, noise: Optional[Noise] = None):
        self.cid = int(cid)
        self.t = transport
        self.template = template
        self.verify_digest = verify_digest
        self.noise = noise
        self.done = False
        self.rounds_trained = 0
        self._pending_upload: Optional[Dict[str, Any]] = None
        self.t.send_to_server(Message(
            MsgType.REGISTER, self.cid,
            {"session": getattr(transport, "session", None)}))

    def step(self) -> bool:
        """Poll + handle one instruction; returns True once shut down."""
        if self.done:
            return True
        inst = self.t.poll_client(self.cid)
        if inst is None:
            return False
        k = inst.kind
        if k is MsgType.WAIT:
            self.t.send_to_server(Message(MsgType.READY, self.cid))
        elif k is MsgType.TRAIN:
            p = inst.payload
            rnd = int(p.get("round", 0))
            if self.verify_digest and "params_digest" in p:
                got = params_digest(p["params"])
                if got != p["params_digest"]:
                    raise AssertionError(
                        f"client {self.cid}: params digest mismatch "
                        f"({got[:12]} != {p['params_digest'][:12]})")
            delta = _client_delta(self.template, rnd, self.cid,
                                  p.get("compression", "none"), self.noise)
            self._pending_upload = {
                "delta": delta, "n": sim_weight(self.cid), "round": rnd,
            }
            self.t.send_to_server(Message(MsgType.TRAIN_DONE, self.cid))
        elif k is MsgType.SEND_UPDATE:
            up = self._pending_upload or {}
            self._pending_upload = None
            self.t.send_to_server(Message(MsgType.UPLOAD, self.cid, up))
            self.rounds_trained += 1
        elif k is MsgType.TERMINATE:
            if inst.payload.get("reason") == "shutdown":
                self.done = True
                return True
            self.t.send_to_server(Message(
                MsgType.REGISTER, self.cid,
                {"session": getattr(self.t, "session", None)}))
        return False


def drive_sim_clients(host: str, port: int, cids: Sequence[int],
                      template: Any, *, threads: int = 8,
                      recv_timeout: float = 0.002,
                      session_key: Optional[bytes] = None,
                      max_reconnect_attempts: int = 10,
                      timeout: float = 120.0,
                      noise: Optional[Noise] = None) -> None:
    """Run ``SimWorker``s against a live leaf over real sockets: ``cids``
    are split across ``threads`` driver threads, each round-robin polling
    one short-timeout socket transport per client until every worker is
    shut down.  Raises on the first worker error (propagated from its
    thread) or on timeout.  ``noise`` goes to every ``SimWorker``."""
    from repro_torch.fed.net import SocketClientTransport

    cids = list(cids)
    errors: List[BaseException] = []
    lock = threading.Lock()

    def run(batch: List[int]) -> None:
        transports = []
        try:
            workers = []
            for cid in batch:
                t = SocketClientTransport(
                    host, port, cid, recv_timeout=recv_timeout,
                    session_key=session_key,
                    max_reconnect_attempts=max_reconnect_attempts)
                transports.append(t)
                workers.append(SimWorker(cid, t, template, noise=noise))
            pending = list(workers)
            deadline = time.monotonic() + timeout
            while pending:
                progressed = False
                for w in list(pending):
                    if w.step():
                        pending.remove(w)
                        progressed = True
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{len(pending)} sim clients still pending")
                if not progressed:
                    time.sleep(0.005)
        except BaseException as e:  # noqa: BLE001 - surfaced to caller
            with lock:
                errors.append(e)
        finally:
            for t in transports:
                try:
                    t.close()
                except Exception:
                    pass

    n = max(1, min(int(threads), len(cids)))
    batches = [cids[i::n] for i in range(n)]
    ts = [threading.Thread(target=run, args=(b,), daemon=True)
          for b in batches if b]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise errors[0]


# --------------------------------------------------------------------------
# Aggregator nodes
# --------------------------------------------------------------------------


class LeafAggregator:
    """Tier-1 aggregator: terminates client sessions on its own transport,
    folds their uploads into an :class:`ExactAccumulator` in the native
    quantized domain, and answers the root's ``TRAIN`` with one
    ``PARTIAL_SUM``.  Params arrive once per round as a content-addressed
    ``PARAMS_CHUNK`` and are re-broadcast to clients from the local
    :class:`ChunkStore` via cached v2 segments — framed once per leaf,
    not once per client."""

    def __init__(self, leaf_id: int, client_transport, root_transport, *,
                 obs=None, round_timeout: float = 120.0,
                 policy: Optional[RoundPolicy] = None, wal=None,
                 recovery=None, wal_checkpoint_every: int = 0):
        self.leaf_id = int(leaf_id)
        self.root = root_transport
        self.round_timeout = round_timeout
        self.policy = policy
        #: Optional :class:`repro_torch.fed.wal.RoundJournal`: accepted uploads
        #: are journaled *before* folding, plus an accumulator window
        #: checkpoint every ``wal_checkpoint_every`` folds, so a SIGKILLed
        #: leaf replays the journal on restart and resumes bit-identical.
        self.wal = wal
        self.wal_checkpoint_every = int(wal_checkpoint_every)
        self.server = FLServer(client_transport, obs=obs)
        self.store = ChunkStore(obs=obs, scope=f"leaf:{self.leaf_id}")
        self.acc: Optional[ExactAccumulator] = None
        self.round: Optional[int] = None
        self.last_round_report: Dict[str, Any] = {
            "mode": "FULL", "reported": [], "stragglers": []}
        reg = obs.registry if obs is not None else None
        scope = f"leaf:{self.leaf_id}"
        self._m_folded = (reg.counter("hier.clients_folded", scope)
                          if reg else Counter())
        self._m_replays = (reg.counter("fault.wal_replays", scope)
                           if reg else Counter())
        self._m_round_closed = (reg.counter("fault.round_closed_aborts",
                                            scope)
                                if reg else Counter())
        self._train_cache: Optional[CachedSegments] = None
        self._train_cache_digest: Optional[str] = None
        self._round_folds = 0
        self._pending_recovery = None
        if recovery is not None:
            # whole-journal dedup floor first: a reconnecting client that
            # retrains a round the dead leaf already accepted must get
            # ``duplicate_upload``, never a second fold
            for cid, rounds in recovery.uploaded_rounds.items():
                self.server.sessions.uploaded_rounds.setdefault(
                    cid, set()).update(rounds)
            self._pending_recovery = recovery.open_round
        # replace the stock store-the-payload hook: a leaf folds each
        # delta immediately and keeps only a tiny per-client marker, so
        # memory stays O(model), not O(clients x model)
        self.server.monitor.aggregation_hook = self._fold_upload

    def _fold_upload(self, cid: int, payload: Dict[str, Any]) -> None:
        rnd = payload.get("round")
        self.server.sessions.record_upload(cid, rnd)
        if rnd != self.round or self.acc is None:
            return  # late upload for a closed round: acked, not folded
        if self.wal is not None:
            # write-ahead: journal, then fold — a crash between the two
            # replays the upload instead of losing it
            self.wal.upload(cid, payload)
        self.acc.fold(payload["delta"], int(payload.get("n", 1)))
        self._m_folded.inc()
        self.server.uploads[cid] = {"round": rnd, "n": payload.get("n", 1)}
        self._round_folds += 1
        if (self.wal is not None and self.wal_checkpoint_every > 0
                and self._round_folds % self.wal_checkpoint_every == 0):
            self.wal.checkpoint(self._round_folds,
                                {"round": rnd, **self.acc.to_payload()})

    def _adopt_recovery(self, rnd: int) -> int:
        """Resume the journal's open round: adopt the newest accumulator
        checkpoint, re-fold the uploads journaled after it, and mark every
        journaled uploader done.  Returns uploads restored (0 when the
        crash round was already closed — history only)."""
        live, self._pending_recovery = self._pending_recovery, None
        if live is None or live.round != rnd:
            return 0
        s = self.server
        k = live.checkpoint_folds if live.checkpoint is not None else 0
        if live.checkpoint is not None:
            self.acc = ExactAccumulator.from_payload(live.checkpoint)
        for i, (cid, payload) in enumerate(live.uploads):
            if i >= k:
                self.acc.fold(payload["delta"], int(payload.get("n", 1)))
                self._m_folded.inc()
            s.sessions.record_upload(cid, rnd)
            s.uploads[cid] = {"round": rnd, "n": payload.get("n", 1)}
            s.monitor.state[cid] = "done"
            self._m_replays.inc()
        self._round_folds = len(live.uploads)
        return len(live.uploads)

    def _cached_train(self, digest: str, params: Any) -> CachedSegments:
        if self._train_cache_digest != digest:
            self._train_cache = precompute_segments({"params": params})
            self._train_cache_digest = digest
        return self._train_cache

    def run_round(self, rnd: int, cids: Sequence[int], digest: str, *,
                  local_steps: int = 1, compression: str = "none") -> None:
        """Collect ``cids``' uploads for round ``rnd`` and ship the
        partial sum to the root.

        With a :class:`RoundPolicy` installed the round may close
        **DEGRADED**: once the policy deadline has elapsed (or every
        still-connected participant reported) and the quorum is met, the
        partial ships with the subset that uploaded — the weighted mean
        renormalizes over the folded weight, exactly the simulator's
        straggler-drop math — and each straggler's session gets
        ``TERMINATE`` reason ``"round_closed"``."""
        params = self.store.get(digest)
        if params is None:
            raise KeyError(f"leaf {self.leaf_id}: no chunk for digest "
                           f"{digest[:12]} (PARAMS_CHUNK not received?)")
        s = self.server
        s.sessions.prune_rounds(rnd)
        s.uploads.clear()
        self.acc = ExactAccumulator()
        self.round = rnd
        self._round_folds = 0
        self._adopt_recovery(rnd)
        if self.wal is not None:
            self.wal.open_round(rnd, digest=digest)
        s.participants = set(int(c) for c in cids)
        s.train_payload = {
            "round": rnd, "local_steps": int(local_steps),
            "compression": compression, "params_digest": digest,
        }
        s.cached_payloads[MsgType.TRAIN] = self._cached_train(digest, params)
        connected = getattr(s.transport, "connected_clients", None)
        start = time.monotonic()
        deadline = start + self.round_timeout
        mode = "FULL"
        done: set = set()
        stragglers: List[int] = []
        try:
            while True:
                n = s.step()
                done = {c for c in s.participants
                        if s.uploads.get(c, {}).get("round") == rnd}
                if len(done) == len(s.participants):
                    break
                if self.policy is not None:
                    missing = s.participants - done
                    quorum_met = len(done) >= self.policy.quorum(
                        len(s.participants))
                    all_live_reported = (
                        quorum_met and connected is not None
                        and not (set(connected()) & missing))
                    if all_live_reported or self.policy.may_close(
                            len(done), len(s.participants),
                            time.monotonic() - start):
                        mode = "DEGRADED"
                        stragglers = sorted(missing)
                        break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"leaf {self.leaf_id} round {rnd}: "
                        f"{len(done)}/{len(s.participants)} uploads")
                if n == 0:
                    time.sleep(0.002)
        finally:
            s.participants = None
            s.train_payload = {}
            s.cached_payloads.pop(MsgType.TRAIN, None)
        for cid in stragglers:
            self._m_round_closed.inc()
            try:
                s.transport.send_to_client(Message(
                    MsgType.TERMINATE, cid,
                    {"reason": "round_closed", "round": rnd}))
            except Exception:
                pass  # a straggler may have no live session to abort
        self.last_round_report = {
            "mode": mode, "reported": sorted(done), "stragglers": stragglers}
        acc, self.acc, self.round = self.acc, None, None
        self.root.send_to_server(Message(
            MsgType.PARTIAL_SUM, self.leaf_id,
            {"round": rnd, **acc.to_payload()}))
        if self.wal is not None:
            # after the send: if the crash lands between ship and record,
            # the root either got the partial (and moves on — recovery of
            # the stale open round is discarded at the next round's open)
            # or re-sends TRAIN and the fully-recovered round re-ships
            self.wal.close_round(rnd, mode=mode, count=acc.count,
                                 weight=acc.weight)

    def _drain_shutdown(self, grace: float = 5.0) -> None:
        """After broadcasting shutdown, wait for clients to read their
        TERMINATE and hang up — closing the listener first would cut the
        final frames mid-flush and strand reconnecting clients on a
        refused port."""
        connected = getattr(self.server.transport, "connected_clients", None)
        if connected is None:
            return
        deadline = time.monotonic() + grace
        while connected() and time.monotonic() < deadline:
            time.sleep(0.01)

    def serve(self) -> None:
        """Leaf main loop: speak the client protocol upward to the root
        (REGISTER/READY like any worker), run rounds on TRAIN, cascade
        shutdown downward on TERMINATE(reason=shutdown)."""
        r = self.root
        r.send_to_server(Message(
            MsgType.REGISTER, self.leaf_id,
            {"session": getattr(r, "session", None)}))
        while True:
            inst = r.poll_client(self.leaf_id)
            if inst is None:
                # client traffic queues in the transport until the next
                # run_round steps the FLServer — answering a READY while
                # no round is open would hand out a paramless TRAIN
                continue
            k = inst.kind
            if k is MsgType.WAIT:
                r.send_to_server(Message(MsgType.READY, self.leaf_id))
            elif k is MsgType.PARAMS_CHUNK:
                self.store.put(inst.payload["digest"], inst.payload["params"])
            elif k is MsgType.TRAIN:
                p = inst.payload
                self.run_round(
                    int(p["round"]), [int(c) for c in p.get("cids", [])],
                    p["params_digest"],
                    local_steps=int(p.get("local_steps", 1)),
                    compression=p.get("compression", "none"))
            elif k is MsgType.TERMINATE:
                if inst.payload.get("reason") == "shutdown":
                    self.server.broadcast_shutdown()
                    self._drain_shutdown()
                    return
                r.send_to_server(Message(
                    MsgType.REGISTER, self.leaf_id,
                    {"session": getattr(r, "session", None)}))


class RootAggregator:
    """Tier-0 aggregator: selects per-leaf client assignments, broadcasts
    content-addressed params (one ``PARAMS_CHUNK`` per leaf, cached v2
    segments), and merges leaf ``PARTIAL_SUM``s in sorted-leaf order —
    which, by exactness, is the same result as any other order."""

    def __init__(self, transport, *, obs=None, round_timeout: float = 120.0,
                 policy: Optional[RoundPolicy] = None, wal=None,
                 recovery=None):
        self.server = FLServer(transport, obs=obs, wal=wal)
        self.round_timeout = round_timeout
        self.policy = policy
        self.wal = wal
        self.assignment: Dict[int, List[int]] = {}
        self._digest: Optional[str] = None
        self.last_round_report: Dict[str, Any] = {
            "mode": "FULL", "reported": [], "stragglers": []}
        self._pending_recovery = None
        if recovery is not None:
            for cid, rounds in recovery.uploaded_rounds.items():
                self.server.sessions.uploaded_rounds.setdefault(
                    cid, set()).update(rounds)
            self._pending_recovery = recovery.open_round
        reg = obs.registry if obs is not None else None
        self._m_partials = (reg.counter("hier.partial_sums", "root")
                            if reg else Counter())
        self._m_replays = (reg.counter("fault.wal_replays", "root")
                           if reg else Counter())
        self._m_round_closed = (reg.counter("fault.round_closed_aborts",
                                            "root")
                                if reg else Counter())
        stock = self.server.monitor.aggregation_hook
        def hook(cid: int, payload: Dict[str, Any]) -> None:
            stock(cid, payload)
            self._m_partials.inc()
        self.server.monitor.aggregation_hook = hook
        self.server.monitor.train_payload_provider = self._train_payload_for
        self.server.on_instruction = self._inject_chunk

    def _train_payload_for(self, leaf_id: int) -> Dict[str, Any]:
        p = dict(self.server.train_payload)
        p["cids"] = list(self.assignment.get(leaf_id, []))
        return p

    def _inject_chunk(self, out: Message) -> List[Message]:
        if out.kind is MsgType.TRAIN and self._digest is not None:
            chunk = Message(MsgType.PARAMS_CHUNK, out.client_id, {
                "round": self.server.train_payload.get("round"),
                "digest": self._digest,
            })
            return [chunk, out]
        return [out]

    def train_round(self, assignment: Dict[int, Sequence[int]], params: Any,
                    rnd: int, *, local_steps: int = 1,
                    compression: str = "none") -> Tuple[Any, int, int]:
        """Run one round over the tree; returns ``(mean_delta_fp32,
        client_count, total_weight)``."""
        leaf_ids = sorted(int(l) for l in assignment)
        self.assignment = {int(l): [int(c) for c in cs]
                           for l, cs in assignment.items()}
        digest = params_digest(params)
        self._digest = digest
        s = self.server
        s.cached_payloads[MsgType.PARAMS_CHUNK] = precompute_segments(
            {"params": params})
        s.sessions.prune_rounds(rnd)
        s.uploads.clear()
        live, self._pending_recovery = self._pending_recovery, None
        if live is not None and live.round == rnd:
            # crash-restart: re-adopt the partials already journaled for
            # the interrupted round (replayed, not re-requested)
            for cid, payload in live.uploads:
                s.uploads[cid] = payload
                s.sessions.record_upload(cid, payload.get("round"))
                s.monitor.state[cid] = "done"
                self._m_replays.inc()
        if self.wal is not None:
            self.wal.open_round(rnd, digest=digest)
        s.participants = set(leaf_ids)
        s.train_payload = {
            "round": rnd, "local_steps": int(local_steps),
            "compression": compression, "params_digest": digest,
        }
        start = time.monotonic()
        deadline = start + self.round_timeout
        mode = "FULL"
        done: List[int] = []
        stragglers: List[int] = []
        try:
            while True:
                n = s.step()
                done = [l for l in leaf_ids
                        if s.uploads.get(l, {}).get("round") == rnd]
                if len(done) == len(leaf_ids):
                    break
                if self.policy is not None and self.policy.may_close(
                        len(done), len(leaf_ids),
                        time.monotonic() - start):
                    mode = "DEGRADED"
                    stragglers = [l for l in leaf_ids if l not in done]
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"root round {rnd}: {len(done)}/{len(leaf_ids)} "
                        f"partials")
                if n == 0:
                    time.sleep(0.002)
        finally:
            s.participants = None
            s.train_payload = {}
            s.cached_payloads.pop(MsgType.PARAMS_CHUNK, None)
            self._digest = None
            self.assignment = {}
        for lid in stragglers:
            self._m_round_closed.inc()
            try:
                s.transport.send_to_client(Message(
                    MsgType.TERMINATE, lid,
                    {"reason": "round_closed", "round": rnd}))
            except Exception:
                pass  # a straggler leaf may have no live session to abort
        self.last_round_report = {
            "mode": mode, "reported": list(done), "stragglers": stragglers}
        total = ExactAccumulator()
        for lid in done:
            total.merge(ExactAccumulator.from_payload(s.uploads[lid]))
        if self.wal is not None:
            self.wal.close_round(rnd, mode=mode, count=total.count,
                                 weight=total.weight)
        return total.finalize_mean(), total.count, total.weight


# --------------------------------------------------------------------------
# Campaign drivers
# --------------------------------------------------------------------------


def run_leaf(leaf_id: int, root_host: str, root_port: int, *,
             host: str = "127.0.0.1", port: int = 0, ready_queue=None,
             session_key: Optional[bytes] = None, obs=None,
             round_timeout: float = 120.0,
             async_server: bool = True,
             policy: Optional[RoundPolicy] = None,
             wal_path=None, wal_checkpoint_every: int = 0) -> None:
    """Process entry point for one leaf aggregator: bind the client-facing
    socket server (async accept loop by default), report
    ``(leaf_id, bound_port)`` on ``ready_queue``, dial the root, serve
    until shutdown.  With ``wal_path`` the leaf journals every accepted
    upload and recovers the journal on start — a SIGKILLed leaf restarted
    on the same ``wal_path`` resumes its round bit-identical."""
    from repro_torch.fed.net import (AsyncSocketServerTransport,
                                     SocketClientTransport, SocketServerTransport)
    wal = recovery = None
    if wal_path is not None:
        from repro_torch.fed import wal as walmod
        recovery = walmod.recover(wal_path)
        wal = walmod.RoundJournal(wal_path, obs=obs,
                                  scope=f"leaf:{int(leaf_id)}")
    cls = AsyncSocketServerTransport if async_server else SocketServerTransport
    client_side = cls(host, port, session_key=session_key, obs=obs)
    root_side = SocketClientTransport(
        root_host, root_port, leaf_id, recv_timeout=0.05,
        session_key=session_key, obs=obs)
    if ready_queue is not None:
        ready_queue.put((int(leaf_id), client_side.address[1]))
    leaf = LeafAggregator(leaf_id, client_side, root_side, obs=obs,
                          round_timeout=round_timeout, policy=policy,
                          wal=wal, recovery=recovery,
                          wal_checkpoint_every=wal_checkpoint_every)
    try:
        leaf.serve()
    finally:
        root_side.close()
        client_side.close()
        if wal is not None:
            wal.close()


def run_root_campaign(root: RootAggregator,
                      assignment: Dict[int, Sequence[int]], template: Any,
                      rounds: int, *, compression: str = "none",
                      shutdown: bool = True,
                      allow_partial: bool = False) -> Tuple[str, Any]:
    """Drive ``rounds`` rounds over a live tree; returns the final params
    digest (the tree-vs-flat bit-identity witness) and the params.
    ``allow_partial`` permits quorum-degraded rounds (fewer clients folded
    than assigned) instead of asserting full participation."""
    params = _zeros_like_f32(template)
    n_clients = sum(len(cs) for cs in assignment.values())
    for rnd in range(int(rounds)):
        delta, count, _w = root.train_round(
            assignment, params, rnd, compression=compression)
        if count != n_clients and not allow_partial:
            raise AssertionError(
                f"round {rnd}: folded {count} clients, expected {n_clients}")
        params = tree_add(params, delta)
    if shutdown:
        root.server.broadcast_shutdown()
    return params_digest(params), params


def run_flat_campaign(template: Any, cids: Sequence[int], rounds: int, *,
                      compression: str = "none",
                      batch: int = 4096,
                      noise: Optional[Noise] = None) -> Tuple[str, Any]:
    """The flat reference: identical clients folded into ONE accumulator
    in-process — the single-node configuration of the exact-reduction
    path.  Bit-identity against any tree run is the module's core
    invariant.  ``noise`` is the clients' int8 rounding noise, as in
    :class:`SimWorker`."""
    params = _zeros_like_f32(template)
    cids = [int(c) for c in cids]
    for rnd in range(int(rounds)):
        acc = ExactAccumulator()
        if compression == "none":
            for i in range(0, len(cids), int(batch)):
                chunk = cids[i:i + int(batch)]
                acc.fold_batch(synth_delta_batch(template, rnd, chunk),
                               [sim_weight(c) for c in chunk],
                               template=template)
        else:
            for cid in cids:
                acc.fold(_client_delta(template, rnd, cid, compression, noise),
                         sim_weight(cid))
        params = tree_add(params, acc.finalize_mean())
    return params_digest(params), params


def run_two_tier_campaign(template: Any, cids: Sequence[int], rounds: int,
                          n_leaves: int) -> Tuple[str, Any, List[int]]:
    """The scale world of the tree without sockets: each round
    ``n_leaves`` leaf accumulators fold their share of ``cids``
    (``cids[leaf::n_leaves]``, ``fold_batch`` in chunks of 4,096),
    every leaf's ``PARTIAL_SUM`` makes a round trip through the wire
    codec, and the root merges them in leaf order.  Returns the digest
    and params, as :func:`run_flat_campaign` does for the same world,
    and the root's folded count each round."""
    params = _zeros_like_f32(template)
    cids = [int(c) for c in cids]
    counts = []
    for rnd in range(int(rounds)):
        total = ExactAccumulator()
        for lid in range(int(n_leaves)):
            mine = cids[lid::int(n_leaves)]
            leaf = ExactAccumulator()
            for i in range(0, len(mine), 4096):
                chunk = mine[i:i + 4096]
                leaf.fold_batch(synth_delta_batch(template, rnd, chunk),
                                [sim_weight(c) for c in chunk],
                                template=template)
            total.merge(ExactAccumulator.from_payload(
                _wire_roundtrip(leaf.to_payload())))
        counts.append(total.count)
        params = tree_add(params, total.finalize_mean())
    return params_digest(params), params, counts


def _zeros_like_f32(template: Any) -> Any:
    flat = _flatten(template)
    return _unflatten(
        [p for p, _ in flat],
        [np.zeros(np.asarray(l).shape, np.float32) for _, l in flat])


def aggregate_tree_sim(tree: Any, deltas: Sequence[Any],
                       weights: Sequence[int], *,
                       wire_version: int = 2) -> Dict[str, Any]:
    """In-process tree aggregation for property tests: ``tree`` is a
    nested list whose leaves are lists of client indices into ``deltas``;
    every tier's ``PARTIAL_SUM`` payload makes a full round trip through
    the wire codec (the exact bytes a socket would carry)."""
    def is_leaf(node: Any) -> bool:
        return all(isinstance(x, int) for x in node)

    def agg(node: Any) -> Dict[str, Any]:
        acc = ExactAccumulator()
        if is_leaf(node):
            for i in node:
                acc.fold(deltas[i], weights[i])
        else:
            for child in node:
                acc.merge(ExactAccumulator.from_payload(agg(child)))
        return _wire_roundtrip(acc.to_payload(), version=wire_version)

    return agg(tree)


def _wire_roundtrip(payload: Dict[str, Any], *, version: int = 2) -> Dict[str, Any]:
    """``payload`` as a ``PARTIAL_SUM`` encoded to the wire and decoded
    back: the exact bytes a socket would carry."""
    from repro_torch.fed.transport import (decode_wire_body, encode_envelope_wire,
                                           parse_envelope)

    enc = encode_envelope_wire(
        1, 0, Message(MsgType.PARTIAL_SUM, 0, payload), version=version)
    frame, _ = decode_wire_body(enc.data[4:])
    _seq, _ack, msg = parse_envelope(frame)
    return msg.payload
