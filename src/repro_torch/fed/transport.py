"""Message transports: the RPC seam between FLServer and its clients.

The port of ``repro.fed.transport``: the same frames, byte for byte
(``docs/wire-protocol.md`` is the normative spec), so a server of either
package speaks to workers of the other.  Payloads are numpy at the seams —
the dispatcher's TRAIN params, a worker's upload, the mirror's provider
output — and the codec refuses a ``torch.Tensor`` (``TypeError``) rather
than hide a device-to-host copy inside the wire layer.  The one exception
is bf16: numpy has no bf16 of its own, so a ``bf16`` segment is encoded
from, and decoded to, a CPU ``torch.bfloat16`` tensor (its bytes go
through ``view(torch.int16)``), with no ``ml_dtypes`` import.  A numpy
array whose dtype is named ``bfloat16`` is encoded as the reference
encodes it.  The compressed-delta wire types (:class:`QuantizedTensor`,
:class:`TopKTensor`) live here, as in the reference, and
``repro_torch.fed.compression`` makes them.

The paper's control plane speaks gRPC between a long-lived server process
and per-client processes.  This module pins down the *surface* that any
deployment transport must implement (``Transport``), keeps the in-process
``LocalTransport`` as the reference implementation, and proves the seam is
RPC-ready with ``SerializingTransport``: a transport that wire round-trips
every message across the send/poll boundary, so nothing in the protocol
depends on in-memory object identity.  Swapping in a socket transport is
then a pure I/O change — messages are already plain dicts.

Two wire protocol versions live here (``docs/wire-protocol.md`` is the
normative spec; version negotiation happens in the socket handshake):

* **v1** — every frame is a UTF-8 JSON body; tensors are tagged JSON
  objects with base64-encoded bytes (~33 % payload inflation plus a
  ``json``/``base64`` pass per message each way).
* **v2** — the envelope header stays compact JSON but tensor payloads
  ride as contiguous raw bytes *after* the header: no base64, no
  per-element JSON, zero-copy ``np.frombuffer`` on decode, optional
  per-segment deflate, and the ``repro_torch.fed.compression`` outputs
  (:class:`QuantizedTensor`, :class:`TopKTensor`) are native wire types
  so a compressed delta is transmitted compressed.

Frames are self-describing on the wire (a v2 body starts with the byte
``0xF2``, which can never begin a JSON body), so receivers accept either
version regardless of what was negotiated — negotiation only controls what
a sender *emits*.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import struct
import zlib
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import (
    Any, Deque, Dict, List, Optional, Protocol, Sequence, Tuple,
    runtime_checkable,
)

import numpy as np
import torch

from repro_torch.obs.metrics import Counter

#: Highest wire-protocol version spoken by this build.  The socket
#: handshake (``repro_torch.fed.net``) negotiates the session version: each
#: side advertises the versions it accepts and the highest common one
#: wins — see ``docs/wire-protocol.md`` § Handshake.
PROTOCOL_VERSION = 2

#: Every version this build can speak (v1 JSON kept as the fallback for
#: mixed-version worlds).
SUPPORTED_VERSIONS: Tuple[int, ...] = (1, 2)

#: Environment override for the *preferred* version (``1`` forces the
#: JSON wire format end-to-end; used by the CI cross-version check).
WIRE_VERSION_ENV = "FEDHC_WIRE_VERSION"

#: Environment toggle for v2 per-segment deflate (off by default: raw
#: segments keep the encode path at memcpy speed).
WIRE_DEFLATE_ENV = "FEDHC_WIRE_DEFLATE"

#: Magic tag carried by every handshake frame, so a stray TCP client
#: that is not a FedHC peer is rejected before any state is allocated.
PROTOCOL_MAGIC = "fedhc"

#: Shared-secret env var for HMAC-signed session tokens.  When set on the
#: server, every client hello must carry ``auth`` =
#: HMAC-SHA256(key, "client_id:session"); unsigned or garbage peers are
#: rejected with a clean error-hello before any session state exists.
SESSION_KEY_ENV = "FEDHC_SESSION_KEY"

#: Upper bound on a single frame body (64 MiB).  A length prefix above
#: this is treated as a corrupt stream, not an allocation request.
MAX_FRAME_BYTES = 64 * 1024 * 1024

#: First byte of a v2 binary envelope body.  0xF2 is not valid UTF-8, so
#: no JSON body can start with it — frames self-describe their version.
WIRE_V2_MAGIC = 0xF2

#: v2 wire dtype tags (normative; docs/wire-protocol.md lists this table
#: and CI asserts every tag is documented).  Encoding a dtype outside
#: this table raises ``TypeError`` — fall back to v1 JSON for exotica.
WIRE_DTYPES: Dict[str, str] = {
    "f16": "float16",
    "f32": "float32",
    "f64": "float64",
    "bf16": "bfloat16",
    "i8": "int8",
    "i16": "int16",
    "i32": "int32",
    "i64": "int64",
    "u8": "uint8",
    "u16": "uint16",
    "u32": "uint32",
    "u64": "uint64",
    "b1": "bool",
}

_TAG_BY_DTYPE = {v: k for k, v in WIRE_DTYPES.items()}

#: Payload dict keys reserved by the wire codec's tagged encodings.
_RESERVED_KEYS = frozenset({"__nd__", "__seg__", "__q8__", "__topk__"})


def default_protocol_version() -> int:
    """The preferred wire version: ``FEDHC_WIRE_VERSION`` env override,
    else :data:`PROTOCOL_VERSION`."""
    v = os.environ.get(WIRE_VERSION_ENV)
    return int(v) if v else PROTOCOL_VERSION


def default_accept_versions(version: Optional[int] = None) -> Tuple[int, ...]:
    """Versions a peer preferring ``version`` accepts: every supported
    version up to it (so a v2 peer still accepts v1 frames from an old
    world), or just ``(version,)`` for a version this build doesn't know
    — the handshake then refuses cleanly instead of guessing."""
    version = default_protocol_version() if version is None else int(version)
    if version in SUPPORTED_VERSIONS:
        return tuple(v for v in SUPPORTED_VERSIONS if v <= version)
    return (version,)


def default_deflate() -> bool:
    return os.environ.get(WIRE_DEFLATE_ENV, "") not in ("", "0", "false")


def default_session_key() -> Optional[bytes]:
    """The handshake HMAC key from ``FEDHC_SESSION_KEY`` (None = auth off)."""
    k = os.environ.get(SESSION_KEY_ENV, "")
    return k.encode() if k else None


def sign_session(key: bytes, client_id: int, session: str) -> str:
    """HMAC-SHA256 signature binding a session token to its client id."""
    mac = hmac.new(key, f"{int(client_id)}:{session}".encode(), hashlib.sha256)
    return mac.hexdigest()


def verify_session_auth(hello: Dict[str, Any], key: Optional[bytes]) -> bool:
    """Server side: does the client hello's ``auth`` field verify under
    ``key``?  With no key configured every hello passes (auth off); with a
    key, a missing/short/garbage signature fails in constant time."""
    if key is None:
        return True
    sig = hello.get("auth")
    if not isinstance(sig, str):
        return False
    try:
        expect = sign_session(key, int(hello.get("client_id", -1)),
                              str(hello.get("session", "")))
    except (TypeError, ValueError):
        return False
    return hmac.compare_digest(sig, expect)


class ProtocolError(RuntimeError):
    """Peer violated the wire protocol (bad magic, version mismatch, …)."""


class FrameError(ProtocolError):
    """The byte stream is not a valid frame sequence (truncation,
    oversize, corrupt v2 header/segment table)."""


class MsgType(str, Enum):
    """Every message kind on the FedHC control plane (paper Fig 4).

    The first block is client → server *requests*; the second is
    server → client *instructions*.  ``docs/wire-protocol.md`` is the
    normative field-level spec for each member (CI enforces that every
    member is documented there).
    """

    # client -> server requests
    REGISTER = "register"
    READY = "ready"                 # polling for work
    TRAIN_DONE = "train_done"
    UPLOAD = "upload"               # carries the delta payload
    HEARTBEAT = "heartbeat"
    ABORT = "abort"                 # client died / was evicted mid-round
    # server -> client instructions
    TRAIN = "train"
    SEND_UPDATE = "send_update"
    WAIT = "wait"
    TERMINATE = "terminate"
    # hierarchy tier protocol (leaf aggregator <-> root; docs/wire-protocol.md
    # § Hierarchical aggregation is the normative spec)
    PARTIAL_SUM = "partial_sum"     # leaf -> root: count + exact bin sums
    PARAMS_CHUNK = "params_chunk"   # root -> leaf: content-addressed params


#: Normative reason tokens carried by ``TERMINATE`` (server → client) and
#: round-abort instructions — ``docs/wire-protocol.md`` § Round close lists
#: this table and CI (``tools/check_docs.py``) asserts the doc and this dict
#: agree in BOTH directions.  ``bad <kind> in <state>`` is the template for
#: the state-machine rejection reason (``<kind>``/``<state>`` are filled
#: with the offending message kind and session state).
TERMINATE_REASONS: Dict[str, str] = {
    "abort": "client reported ABORT; session marked failed, may re-register",
    "duplicate_upload": "(cid, round) already aggregated; upload acked, not re-folded",
    "round_closed": "quorum round closed at deadline without this client's upload",
    "shutdown": "campaign over; the worker process should exit",
    "bad <kind> in <state>": "protocol violation: <kind> is not legal in session state <state>",
}


@dataclass
class Message:
    """One control-plane message.

    ``kind``       — the :class:`MsgType` discriminant.
    ``client_id``  — the FL client the message is from (requests) or for
                     (instructions); the transport routes on it.
    ``payload``    — wire-serializable dict.  Tensors (numpy arrays;
                     bf16 as CPU ``torch.bfloat16``)
                     and the compressed-delta wire types
                     (:class:`QuantizedTensor` / :class:`TopKTensor`) are
                     allowed as values anywhere in the tree; the codec
                     round-trips them bit-exactly (see
                     ``docs/wire-protocol.md`` § Tensor encoding).
    """

    kind: MsgType
    client_id: int
    payload: Dict[str, Any] = field(default_factory=dict)


@runtime_checkable
class Transport(Protocol):
    """The send/poll surface every deployment transport must provide.

    Four methods, two per side of the wire:

    * server side — ``poll_server`` pops the next pending client request
      (or ``None``), ``send_to_client`` issues an instruction to
      ``msg.client_id``;
    * client side — ``send_to_server`` submits a request,
      ``poll_client(cid)`` pops the next instruction for that client
      (or ``None``; socket transports may block up to their configured
      receive timeout before returning ``None``).

    Implementations must deliver messages per-destination in FIFO order
    and never invent or drop messages (a socket transport achieves this
    with per-session sequence numbers, retransmission and receiver-side
    deduplication — see ``repro_torch.fed.net``).  ``LocalTransport`` is the
    in-process reference; ``SerializingTransport`` additionally proves
    every payload survives the binary wire format.

    One documented divergence: ``LocalTransport`` buffers instructions for
    clients it has never seen, but a socket transport has no wire to route
    on until the client's first connection — its ``send_to_client`` raises
    ``KeyError`` for an unknown client.  Server-side code must only send
    instructions in response to received requests (the FLServer does).
    """

    def send_to_server(self, msg: Message) -> None: ...

    def send_to_client(self, msg: Message) -> None: ...

    def poll_server(self) -> Optional[Message]: ...

    def poll_client(self, client_id: int) -> Optional[Message]: ...


class LocalTransport:
    """In-process stand-in for the paper's gRPC channel."""

    def __init__(self):
        self.to_server: Deque[Message] = deque()
        self.to_client: Dict[int, Deque[Message]] = {}

    def send_to_server(self, msg: Message) -> None:
        self.to_server.append(msg)

    def send_to_client(self, msg: Message) -> None:
        self.to_client.setdefault(msg.client_id, deque()).append(msg)

    def poll_server(self) -> Optional[Message]:
        return self.to_server.popleft() if self.to_server else None

    def poll_client(self, client_id: int) -> Optional[Message]:
        q = self.to_client.get(client_id)
        return q.popleft() if q else None


# --------------------------------------------------------------------------
# Compressed-delta wire types
# --------------------------------------------------------------------------
#
# ``repro_torch.fed.compression`` produces these; the codec transmits them
# natively (int8 bytes + one fp32 scale, topk index+value pairs) instead of
# the dequantized fp32 tensors — the whole point of the compressed uplink.


@dataclass(frozen=True)
class QuantizedTensor:
    """QSGD-style per-tensor symmetric int8 quantization: ``q`` (int8,
    original shape) and one scalar ``scale`` such that the dequantized
    tensor is ``q.astype(f32) * scale``."""

    q: Any
    scale: float


@dataclass(frozen=True)
class TopKTensor:
    """Magnitude top-k sparsification: ``idx`` (int32 indices into the
    flattened tensor), ``vals`` (float32), and the dense ``shape``."""

    idx: Any
    vals: Any
    shape: Tuple[int, ...]


# --------------------------------------------------------------------------
# Tensors at the seam: numpy, or a CPU torch.bfloat16 for the bf16 tag
# --------------------------------------------------------------------------

_BF16 = "bfloat16"


def _wire_array(obj: Any) -> Tuple[np.ndarray, str]:
    """A payload tensor as ``(numpy array holding its bytes, wire dtype
    name)``.  A CPU ``torch.bfloat16`` tensor travels as its int16 bit
    pattern under the name ``bfloat16``; any other ``torch.Tensor`` is
    refused — wire payloads are numpy at the seams."""
    if isinstance(obj, torch.Tensor):
        if obj.dtype == torch.bfloat16 and obj.device.type == "cpu":
            return obj.detach().contiguous().view(torch.int16).numpy(), _BF16
        raise TypeError(
            f"payload value is a torch.Tensor ({obj.dtype} on {obj.device}): wire "
            f"payloads are numpy at the seams — convert with "
            f"repro_torch.bridge.params_to_numpy before sending (only a CPU "
            f"torch.bfloat16 travels as a tensor, for the bf16 tag)")
    arr = np.asarray(obj)
    return arr, str(arr.dtype)


def check_numpy_tree(tree: Any, where: str) -> None:
    """Raise ``TypeError`` if ``tree`` holds a ``torch.Tensor`` the codec
    refuses — for seams (the mirror's provider output) whose payload may
    stay in-process, where no encode would catch it."""
    if isinstance(tree, dict):
        for v in tree.values():
            check_numpy_tree(v, where)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            check_numpy_tree(v, where)
    elif isinstance(tree, torch.Tensor):
        try:
            _wire_array(tree)
        except TypeError as e:
            raise TypeError(f"{where}: {e}") from None


def _resolve_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a wire dtype's bytes: ``bfloat16`` is
    read as int16 (its bit pattern), every other name is numpy's own."""
    if name == _BF16:
        return np.dtype(np.int16)
    try:
        return np.dtype(name)
    except TypeError:
        raise TypeError(f"wire dtype {name!r} has no numpy or torch form here") from None


def _wire_tensor(arr: np.ndarray, name: str) -> Any:
    """Decoded bytes as the payload tensor: numpy, or a CPU
    ``torch.bfloat16`` (a copy: torch wants writable memory) for bf16."""
    if name == _BF16:
        return torch.from_numpy(np.array(arr, copy=True)).view(torch.bfloat16)
    return arr


# --------------------------------------------------------------------------
# v1 JSON codec
# --------------------------------------------------------------------------


def _to_jsonable(obj: Any, _b64_acc: Optional[List[int]] = None) -> Any:
    if isinstance(obj, QuantizedTensor):
        return {"__q8__": {"q": _to_jsonable(obj.q, _b64_acc),
                           "scale": float(obj.scale)}}
    if isinstance(obj, TopKTensor):
        return {"__topk__": {"idx": _to_jsonable(obj.idx, _b64_acc),
                             "vals": _to_jsonable(obj.vals, _b64_acc),
                             "shape": [int(s) for s in obj.shape]}}
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            k = str(k)
            if k in _RESERVED_KEYS:   # same rule as v2: no tag spoofing
                raise TypeError(f"payload key {k!r} is reserved by the wire codec")
            out[k] = _to_jsonable(v, _b64_acc)
        return out
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v, _b64_acc) for v in obj]
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        arr, name = _wire_array(obj)
        b64 = base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()
        if _b64_acc is not None:
            _b64_acc.append(len(b64))
        return {"__nd__": b64, "dtype": name, "shape": list(arr.shape)}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):  # numpy scalars (np.bool_)
        return _to_jsonable(np.asarray(obj), _b64_acc)
    raise TypeError(f"payload value {type(obj).__name__} is not wire-serializable")


def _from_jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "__nd__" in obj:
            raw = base64.b64decode(obj["__nd__"])
            arr = np.frombuffer(raw, dtype=_resolve_dtype(obj["dtype"]))
            return _wire_tensor(arr.reshape(obj["shape"]).copy(), obj["dtype"])
        if "__q8__" in obj:
            d = obj["__q8__"]
            return QuantizedTensor(_from_jsonable(d["q"]), float(d["scale"]))
        if "__topk__" in obj:
            d = obj["__topk__"]
            return TopKTensor(_from_jsonable(d["idx"]), _from_jsonable(d["vals"]),
                              tuple(int(s) for s in d["shape"]))
        return {k: _from_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_jsonable(v) for v in obj]
    return obj


def _b64_payload_bytes(obj: Any) -> int:
    """Tensor bytes-on-wire of a decoded v1 JSON object: the total length
    of its base64 ``__nd__`` strings (exact — b64encode emits no newlines)."""
    if isinstance(obj, dict):
        n = len(obj["__nd__"]) if isinstance(obj.get("__nd__"), str) else 0
        return n + sum(_b64_payload_bytes(v) for k, v in obj.items() if k != "__nd__")
    if isinstance(obj, list):
        return sum(_b64_payload_bytes(v) for v in obj)
    return 0


def encode_message(msg: Message) -> str:
    """Message -> JSON wire string (raises if a payload is not wire-safe)."""
    return json.dumps({
        "kind": msg.kind.value,
        "client_id": int(msg.client_id),
        "payload": _to_jsonable(msg.payload),
    })


def decode_message(wire: str) -> Message:
    """JSON wire string -> Message.

    Raises ``ValueError`` (``json.JSONDecodeError``) on malformed or
    truncated JSON and ``KeyError`` on a well-formed object missing the
    required ``kind``/``client_id``/``payload`` fields — receivers treat
    either as a corrupt frame and drop the connection, never the process.
    """
    d = json.loads(wire)
    return Message(MsgType(d["kind"]), d["client_id"], _from_jsonable(d["payload"]))


# --------------------------------------------------------------------------
# v2 binary codec: JSON header + raw tensor segments
# --------------------------------------------------------------------------
#
# A v2 envelope body is
#
#   0xF2 | flags u8 | header_len u32 BE | header JSON | pad | segment blob
#
# The header is the usual compact envelope JSON, except every tensor in
# the payload tree is replaced by a ``{"__seg__": i}`` placeholder and a
# ``segs`` table describes segment i's dtype tag, shape, offset and
# stored length inside the blob.  Segments are raw little-endian array
# bytes (optionally deflate-compressed), 8-byte aligned, decoded with a
# zero-copy ``np.frombuffer`` view over the frame body.

_V2_PRE = struct.Struct(">BBI")

#: Segments at least this large are considered for deflate.
_DEFLATE_MIN_BYTES = 512


def _align8(n: int) -> int:
    return (n + 7) & ~7


class _SegmentWriter:
    """Accumulates the v2 segment table + blob during a payload walk."""

    def __init__(self, deflate: bool):
        self.deflate = deflate
        self.segs: List[Dict[str, Any]] = []
        self.chunks: List[bytes] = []
        self.blob_len = 0

    def add(self, obj) -> Dict[str, int]:
        arr, name = _wire_array(obj)
        shape = list(arr.shape)   # before ascontiguousarray: it 1-d-ifies 0-d
        arr = np.ascontiguousarray(arr)
        tag = _TAG_BY_DTYPE.get(name)
        if tag is None:
            raise TypeError(
                f"dtype {name} is not a v2 wire dtype "
                f"(supported tags: {sorted(WIRE_DTYPES)})"
            )
        raw = arr.tobytes()
        out, enc = raw, "raw"
        if self.deflate and len(raw) >= _DEFLATE_MIN_BYTES:
            z = zlib.compress(raw, 1)
            if len(z) < 0.9 * len(raw):
                out, enc = z, "z"
        pad = (-self.blob_len) % 8
        if pad:
            self.chunks.append(b"\x00" * pad)
            self.blob_len += pad
        self.segs.append({"d": tag, "s": shape,
                          "o": self.blob_len, "l": len(out), "e": enc})
        self.chunks.append(out)
        self.blob_len += len(out)
        return {"__seg__": len(self.segs) - 1}


def _extract_segments(obj: Any, w: _SegmentWriter) -> Any:
    if isinstance(obj, QuantizedTensor):
        return {"__q8__": {"q": w.add(obj.q),
                           "scale": float(obj.scale)}}
    if isinstance(obj, TopKTensor):
        return {"__topk__": {"idx": w.add(obj.idx),
                             "vals": w.add(obj.vals),
                             "shape": [int(s) for s in obj.shape]}}
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            k = str(k)
            if k in _RESERVED_KEYS:
                raise TypeError(f"payload key {k!r} is reserved by the wire codec")
            out[k] = _extract_segments(v, w)
        return out
    if isinstance(obj, (list, tuple)):
        return [_extract_segments(v, w) for v in obj]
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return w.add(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):  # numpy scalars (np.bool_)
        return w.add(np.asarray(obj))
    raise TypeError(f"payload value {type(obj).__name__} is not wire-serializable")


def _encode_envelope_v2(seq: int, ack: int, msg: Message,
                        deflate: bool) -> Tuple[bytes, int]:
    """-> (body bytes, payload bytes = blob length incl. alignment pads)."""
    w = _SegmentWriter(deflate)
    payload = _extract_segments(msg.payload, w)
    blob = b"".join(w.chunks)
    header = json.dumps(
        {"seq": int(seq), "ack": int(ack),
         "msg": {"kind": msg.kind.value, "client_id": int(msg.client_id),
                 "payload": payload},
         "segs": w.segs, "crc": zlib.crc32(blob)},
        separators=(",", ":"),
    ).encode()
    pre = _V2_PRE.pack(WIRE_V2_MAGIC, 0, len(header))
    blob_start = _align8(len(pre) + len(header))
    head_pad = blob_start - len(pre) - len(header)
    body = b"".join([pre, header, b"\x00" * head_pad, blob])
    return body, w.blob_len


def _seg_to_array(seg: Dict[str, Any], blob: memoryview):
    try:
        tag, shape = seg["d"], tuple(int(s) for s in seg["s"])
        off, length, enc = int(seg["o"]), int(seg["l"]), seg.get("e", "raw")
    except (KeyError, TypeError, ValueError) as e:
        raise FrameError(f"corrupt v2 segment descriptor: {e}") from None
    dtype_name = WIRE_DTYPES.get(tag)
    if dtype_name is None:
        raise FrameError(f"unknown v2 wire dtype tag {tag!r}")
    dt = _resolve_dtype(dtype_name)
    count = 1
    for s in shape:
        count *= s
    expected = count * dt.itemsize
    if off < 0 or length < 0 or off + length > len(blob):
        raise FrameError(
            f"v2 segment [{off}:{off + length}] overruns {len(blob)}B blob"
        )
    buf: Any = blob[off:off + length]
    if enc == "z":
        try:
            buf = zlib.decompress(buf)
        except zlib.error as e:
            raise FrameError(f"corrupt deflate segment: {e}") from None
    elif enc != "raw":
        raise FrameError(f"unknown v2 segment encoding {enc!r}")
    if len(buf) != expected:
        raise FrameError(
            f"v2 segment holds {len(buf)}B, dtype×shape needs {expected}B"
        )
    # zero-copy for raw segments: the array is a read-only view over the
    # frame body (deflate segments view the freshly decompressed bytes)
    return _wire_tensor(np.frombuffer(buf, dtype=dt).reshape(shape), dtype_name)


def _hydrate_segments(obj: Any, arrays: List[Any]) -> Any:
    if isinstance(obj, dict):
        if "__seg__" in obj:
            try:
                return arrays[int(obj["__seg__"])]
            except (IndexError, TypeError, ValueError):
                raise FrameError(
                    f"v2 payload references missing segment {obj['__seg__']!r}"
                ) from None
        return {k: _hydrate_segments(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_hydrate_segments(v, arrays) for v in obj]
    return obj


def _decode_envelope_v2(body: bytes) -> Tuple[Dict[str, Any], int]:
    if len(body) < _V2_PRE.size:
        raise FrameError(f"v2 frame body truncated at {len(body)}B")
    magic, _flags, hlen = _V2_PRE.unpack_from(body)
    if magic != WIRE_V2_MAGIC:
        raise FrameError(f"bad v2 frame magic 0x{magic:02x}")
    hstart = _V2_PRE.size
    if hstart + hlen > len(body):
        raise FrameError(
            f"v2 header length {hlen}B overruns {len(body)}B frame body"
        )
    try:
        header = json.loads(body[hstart:hstart + hlen])
    except ValueError as e:
        raise FrameError(f"v2 header is not valid JSON: {e}") from None
    blob_start = _align8(hstart + hlen)
    blob = memoryview(body)[min(blob_start, len(body)):]
    crc = header.get("crc") if isinstance(header, dict) else None
    if crc is not None and zlib.crc32(blob) != int(crc):
        raise FrameError(
            f"v2 segment blob crc mismatch (header {int(crc):#010x}, "
            f"blob {zlib.crc32(blob):#010x}): corrupt frame"
        )
    try:
        segs = header.get("segs", [])
        msg_obj = header["msg"]
        frame = {
            "seq": int(header["seq"]), "ack": int(header["ack"]),
            "msg": {
                "kind": msg_obj["kind"],
                "client_id": msg_obj["client_id"],
                "payload": _hydrate_segments(
                    msg_obj.get("payload", {}),
                    [_seg_to_array(s, blob) for s in segs],
                ),
            },
        }
    except (KeyError, TypeError, ValueError) as e:
        raise FrameError(f"corrupt v2 envelope header: {e}") from None
    # a segment-free foreign frame may end at the header, before the
    # alignment pad — never report a negative payload share
    return frame, max(0, len(body) - blob_start)


@dataclass(frozen=True)
class EncodedEnvelope:
    """One envelope ready for the wire.  ``data`` includes the 4-byte
    length prefix — ``len(data)`` IS the framed bytes-on-wire;
    ``payload_bytes`` is the tensor-segment share of it (v2: blob bytes;
    v1: base64 characters), so header/payload accounting is uniform
    across transports."""

    data: bytes
    payload_bytes: int
    version: int

    @property
    def header_bytes(self) -> int:
        return len(self.data) - self.payload_bytes


def encode_envelope_wire(seq: int, ack: int, msg: Message, *,
                         version: Optional[int] = None,
                         deflate: Optional[bool] = None) -> EncodedEnvelope:
    """Encode one Message as a complete wire frame in the given protocol
    version (default: the build's preferred version)."""
    version = default_protocol_version() if version is None else int(version)
    if version >= 2:
        body, payload_bytes = _encode_envelope_v2(
            seq, ack, msg, default_deflate() if deflate is None else bool(deflate)
        )
    else:
        acc: List[int] = []
        obj = {"seq": int(seq), "ack": int(ack),
               "msg": {"kind": msg.kind.value, "client_id": int(msg.client_id),
                       "payload": _to_jsonable(msg.payload, acc)}}
        body = json.dumps(obj, separators=(",", ":")).encode()
        payload_bytes = sum(acc)
    if len(body) > MAX_FRAME_BYTES:
        raise FrameError(f"frame body {len(body)}B exceeds {MAX_FRAME_BYTES}B")
    return EncodedEnvelope(_LEN.pack(len(body)) + body, payload_bytes, version)


@dataclass(frozen=True)
class CachedSegments:
    """Content-addressed pre-encoded v2 payload: the expensive half of
    envelope encoding (tensor walk, ``tobytes``, optional deflate) done
    once, reusable across sends.

    ``payload_obj`` is the payload tree with every tensor replaced by its
    ``{"__seg__": i}`` placeholder, ``segs`` the segment table, ``blob``
    the joined (aligned, possibly deflated) segment bytes, and ``digest``
    a sha256 over the blob + segment table — the content address.  A root
    broadcasting identical global params to N leaf pods calls
    :func:`precompute_segments` once and :func:`encode_envelope_cached`
    N times; only the small JSON header is re-stamped per send.
    """

    payload_obj: Any
    segs: Tuple[Dict[str, Any], ...]
    blob: bytes
    blob_len: int
    digest: str
    crc: Optional[int] = None


def precompute_segments(payload: Dict[str, Any], *,
                        deflate: Optional[bool] = None) -> CachedSegments:
    """Walk ``payload`` once, extracting every tensor into the v2 segment
    blob, and return the reusable :class:`CachedSegments`."""
    w = _SegmentWriter(default_deflate() if deflate is None else bool(deflate))
    obj = _extract_segments(payload, w)
    blob = b"".join(w.chunks)
    h = hashlib.sha256(blob)
    h.update(json.dumps(w.segs, separators=(",", ":")).encode())
    return CachedSegments(payload_obj=obj, segs=tuple(w.segs), blob=blob,
                          blob_len=w.blob_len, digest=h.hexdigest(),
                          crc=zlib.crc32(blob))


def encode_envelope_cached(seq: int, ack: int, kind: "MsgType",
                           client_id: int, cached: CachedSegments,
                           extra_payload: Optional[Dict[str, Any]] = None,
                           ) -> EncodedEnvelope:
    """Encode a complete v2 wire frame around a pre-extracted payload.

    ``extra_payload`` merges additional *plain-JSON* keys (no tensors —
    those belong in the cached blob) into the payload per send, e.g. the
    round number alongside a cached params blob.  Per-send cost is one
    small ``json.dumps`` plus a join of pre-built byte chunks."""
    payload = cached.payload_obj
    if extra_payload:
        for k in extra_payload:
            if k in _RESERVED_KEYS:
                raise TypeError(f"payload key {k!r} is reserved by the wire codec")
        merged = dict(payload) if isinstance(payload, dict) else {}
        for k, v in extra_payload.items():
            merged[str(k)] = _to_jsonable(v)
        payload = merged
    hdr_obj = {"seq": int(seq), "ack": int(ack),
               "msg": {"kind": kind.value, "client_id": int(client_id),
                       "payload": payload},
               "segs": list(cached.segs)}
    if cached.crc is not None:
        hdr_obj["crc"] = cached.crc
    header = json.dumps(hdr_obj, separators=(",", ":")).encode()
    pre = _V2_PRE.pack(WIRE_V2_MAGIC, 0, len(header))
    blob_start = _align8(len(pre) + len(header))
    head_pad = blob_start - len(pre) - len(header)
    body = b"".join([pre, header, b"\x00" * head_pad, cached.blob])
    if len(body) > MAX_FRAME_BYTES:
        raise FrameError(f"frame body {len(body)}B exceeds {MAX_FRAME_BYTES}B")
    return EncodedEnvelope(_LEN.pack(len(body)) + body, cached.blob_len, 2)


def hydrate_cached(cached: CachedSegments) -> Dict[str, Any]:
    """Rebuild the plain payload dict from a :class:`CachedSegments` —
    the fallback for destinations the cached fast path cannot reach
    (``LocalTransport``, v1-negotiated sessions): the tensors come back
    out of the blob and the message travels the ordinary codec."""
    blob = memoryview(cached.blob)
    arrays = [_seg_to_array(s, blob) for s in cached.segs]
    return _from_jsonable(_hydrate_segments(cached.payload_obj, arrays))


def decode_wire_body(body: bytes) -> Tuple[Dict[str, Any], int]:
    """One frame body (either version — frames self-describe) ->
    ``(frame dict, payload bytes)``.  v2 payload tensors come back as
    zero-copy numpy views; v1 stays the tagged-JSON form that
    :func:`parse_envelope` hydrates.  Raises :class:`FrameError` on a
    corrupt v2 body and ``ValueError`` on malformed JSON."""
    if body[:1] == bytes([WIRE_V2_MAGIC]):
        return _decode_envelope_v2(body)
    obj = json.loads(body)
    return obj, _b64_payload_bytes(obj)


class WireCounters:
    """THE wire-byte accounting implementation, shared by every transport.

    Replaces the three independent copies that used to live in
    ``SerializingTransport``, ``repro_torch.fed.net``'s per-session/per-client
    accounting, and the dispatcher aggregation — one set of counters
    (``framed``/``payload``/``header``/``messages``) built on the
    ``repro_torch.obs`` counter primitive.  ``framed`` counts bytes-on-wire
    including the 4-byte length prefix; ``payload`` the tensor-segment
    share; ``header`` the rest (framed − payload).  With an ``ObsPlane``
    the counters alias into its registry under the canonical ``wire.*``
    names.  NOT internally locked — multi-threaded call sites (the socket
    transports' reader loops) keep their existing stats lock around the
    increment group."""

    __slots__ = ("framed", "payload", "header", "messages")

    def __init__(self, obs=None, scope: str = ""):
        if obs is not None:
            reg = obs.registry
            self.framed = reg.counter("wire.framed_bytes", scope)
            self.payload = reg.counter("wire.payload_bytes", scope)
            self.header = reg.counter("wire.header_bytes", scope)
            self.messages = reg.counter("wire.messages", scope)
        else:
            self.framed = Counter()
            self.payload = Counter()
            self.header = Counter()
            self.messages = Counter()

    def account(self, enc: EncodedEnvelope) -> None:
        """Account one encoded envelope (send side)."""
        self.framed.inc(len(enc.data))
        self.payload.inc(enc.payload_bytes)
        self.header.inc(enc.header_bytes)
        self.messages.inc()

    def account_frame(self, framed_len: int, payload_len: int,
                      count_message: bool = True) -> None:
        """Account one frame by raw byte sizes (receive side)."""
        self.framed.inc(framed_len)
        self.payload.inc(payload_len)
        self.header.inc(framed_len - payload_len)
        if count_message:
            self.messages.inc()


class SerializingTransport(LocalTransport):
    """LocalTransport that forces every message through the wire codec.

    Each ``send`` encodes the message to a complete wire frame (same
    codec, same framing as the socket transports — v2 binary by default)
    and each ``poll`` decodes a fresh object, so receivers can never rely
    on object identity or non-serializable payload types — the exact
    guarantee a socket/gRPC transport needs, and local vs multihost runs
    exercise bit-identical codecs.  ``wire_bytes`` counts *framed* bytes
    (4-byte length prefix included), exactly as the socket path does, so
    local and multihost comm reports are comparable;
    ``payload_bytes``/``header_bytes`` split out the tensor-segment share.
    """

    def __init__(self, *, version: Optional[int] = None,
                 deflate: Optional[bool] = None, obs=None,
                 scope: str = "local"):
        super().__init__()
        self.version = default_protocol_version() if version is None else int(version)
        self.deflate = deflate
        # byte accounting on the shared repro_torch.obs counter primitive; with
        # an ObsPlane the counters alias into its registry under the
        # canonical wire.* names, otherwise they stand alone — either way
        # the legacy attribute surface (wire_bytes, …) reads identically
        wc = WireCounters(obs=obs, scope=scope)
        self._wire = wc

    @property
    def wire_bytes(self) -> int:
        return int(self._wire.framed.value)

    @property
    def payload_bytes(self) -> int:
        return int(self._wire.payload.value)

    @property
    def header_bytes(self) -> int:
        return int(self._wire.header.value)

    @property
    def messages_encoded(self) -> int:
        return int(self._wire.messages.value)

    def _roundtrip(self, msg: Message) -> Message:
        enc = encode_envelope_wire(0, 0, msg, version=self.version,
                                   deflate=self.deflate)
        self._wire.account(enc)
        frame, _pb = decode_wire_body(enc.data[_LEN.size:])
        _seq, _ack, out = parse_envelope(frame)
        return out

    def send_to_server(self, msg: Message) -> None:
        super().send_to_server(self._roundtrip(msg))

    def send_to_client(self, msg: Message) -> None:
        super().send_to_client(self._roundtrip(msg))


# --------------------------------------------------------------------------
# Framing: length-prefixed frames (the socket wire format)
# --------------------------------------------------------------------------
#
# Every frame on a FedHC TCP stream is a 4-byte big-endian unsigned body
# length followed by the body: a UTF-8 JSON object (handshakes and v1
# envelopes) or a v2 binary envelope (first byte 0xF2).  The first frame
# each direction is a *handshake*; every subsequent frame is an *envelope*
# wrapping one encoded Message together with its per-session sequence
# number and a piggybacked cumulative ack.  These helpers are pure
# byte/obj transforms — all actual I/O lives in ``repro_torch.fed.net`` — so
# they are unit-testable without sockets and reusable by the
# fault-injection proxy.

_LEN = struct.Struct(">I")


def encode_frame(obj: Dict[str, Any]) -> bytes:
    """dict -> length-prefixed JSON frame bytes (handshakes, v1 frames)."""
    body = json.dumps(obj, separators=(",", ":")).encode()
    if len(body) > MAX_FRAME_BYTES:
        raise FrameError(f"frame body {len(body)}B exceeds {MAX_FRAME_BYTES}B")
    return _LEN.pack(len(body)) + body


def encode_frame_raw(body: bytes) -> bytes:
    """Re-frame an already-encoded body verbatim (the chaos proxy's
    forwarding path — a v2 body must never be transcoded in flight)."""
    if len(body) > MAX_FRAME_BYTES:
        raise FrameError(f"frame body {len(body)}B exceeds {MAX_FRAME_BYTES}B")
    return _LEN.pack(len(body)) + body


class FrameDecoder:
    """Incremental frame parser over an arbitrary byte-chunk stream.

    ``feed(chunk)`` returns the frames completed by that chunk; partial
    frames are buffered, so a receive timeout mid-frame loses nothing —
    and a truncated or corrupt frame raises, it never hangs ``feed``.
    In the default parsed mode each completed frame is decoded
    (:func:`decode_wire_body`) into a dict; with ``raw=True`` the
    undecoded body bytes are returned instead (the transports use raw
    mode so they can account header/payload bytes per frame; the chaos
    proxy uses it to forward bodies verbatim).

    Raises :class:`FrameError` on an oversize length prefix or a corrupt
    v2 body, and ``ValueError`` on a JSON body that does not parse.
    """

    def __init__(self, raw: bool = False):
        self._buf = bytearray()
        self.raw = raw

    def feed(self, chunk: bytes) -> List[Any]:
        self._buf.extend(chunk)
        out: List[Any] = []
        while len(self._buf) >= _LEN.size:
            (n,) = _LEN.unpack_from(self._buf)
            if n > MAX_FRAME_BYTES:
                raise FrameError(f"frame length {n}B exceeds {MAX_FRAME_BYTES}B")
            if len(self._buf) < _LEN.size + n:
                break
            body = bytes(self._buf[_LEN.size:_LEN.size + n])
            del self._buf[:_LEN.size + n]
            out.append(body if self.raw else decode_wire_body(body)[0])
        return out

    @property
    def pending_bytes(self) -> int:
        """Bytes buffered toward an incomplete frame."""
        return len(self._buf)


# --------------------------------------------------------------------------
# Handshake + version negotiation + envelope codecs
# --------------------------------------------------------------------------


def make_client_hello(client_id: int, session: str, recv_seq: int,
                      version: int = PROTOCOL_VERSION,
                      accept: Optional[Sequence[int]] = None,
                      auth_key: Optional[bytes] = None) -> Dict[str, Any]:
    """First frame client -> server on every (re)connection.

    ``session`` identifies the client's logical lifetime across
    reconnects; ``recv_seq`` is the last server sequence number the
    client has seen, so the server can retransmit exactly the
    instructions that were lost with the previous connection.
    ``version`` is the client's *preferred* wire version and ``accept``
    every version it can speak (default: all supported versions up to
    ``version``) — the server picks the highest common one.
    ``auth_key`` (default: ``FEDHC_SESSION_KEY``) adds the HMAC ``auth``
    signature over ``client_id:session`` that an auth-enabled server
    requires.
    """
    acc = default_accept_versions(version) if accept is None else accept
    hello = {"magic": PROTOCOL_MAGIC, "version": int(version),
             "accept": sorted(int(v) for v in acc),
             "client_id": int(client_id), "session": str(session),
             "recv_seq": int(recv_seq)}
    key = default_session_key() if auth_key is None else auth_key
    if key:
        hello["auth"] = sign_session(key, client_id, session)
    return hello


def make_server_hello(recv_seq: int, *, resumed: bool,
                      version: int = PROTOCOL_VERSION) -> Dict[str, Any]:
    """Handshake reply server -> client: the *negotiated* wire version
    for this session, the server's last received client sequence number
    (cumulative ack) and whether the session resumed."""
    return {"magic": PROTOCOL_MAGIC, "version": int(version),
            "recv_seq": int(recv_seq), "resumed": bool(resumed)}


def make_error_hello(reason: str) -> Dict[str, Any]:
    """Handshake rejection (version mismatch, bad magic); sender closes."""
    return {"magic": PROTOCOL_MAGIC, "error": str(reason)}


def negotiate_version(hello: Dict[str, Any],
                      accept_versions: Sequence[int]) -> int:
    """Server side: pick the session wire version from a client hello —
    the highest version both ends accept.  A hello without an ``accept``
    list (a pure-v1 peer) is treated as accepting only its ``version``.
    Raises :class:`ProtocolError` on bad magic, an error-hello, or an
    empty intersection."""
    if hello.get("magic") != PROTOCOL_MAGIC:
        raise ProtocolError(f"bad handshake magic: {hello.get('magic')!r}")
    if "error" in hello:
        raise ProtocolError(f"peer rejected handshake: {hello['error']}")
    theirs = hello.get("accept") or [hello.get("version")]
    try:
        common = {int(v) for v in theirs} & {int(v) for v in accept_versions}
    except (TypeError, ValueError):
        raise ProtocolError(f"malformed handshake versions: {theirs!r}") from None
    if not common:
        raise ProtocolError(
            f"no common protocol version: peer accepts {sorted(theirs)}, "
            f"this build accepts {sorted(accept_versions)}"
        )
    return max(common)


def check_hello(frame: Dict[str, Any], *,
                accept_versions: Optional[Sequence[int]] = None,
                expect_version: Optional[int] = None) -> int:
    """Client side: validate the server's handshake reply and return the
    negotiated wire version.  Raises :class:`ProtocolError` on bad magic,
    an error-hello, or a chosen version this end does not accept.
    (``expect_version`` is the strict pre-negotiation form, kept for
    callers that pin exactly one version.)"""
    if frame.get("magic") != PROTOCOL_MAGIC:
        raise ProtocolError(f"bad handshake magic: {frame.get('magic')!r}")
    if "error" in frame:
        raise ProtocolError(f"peer rejected handshake: {frame['error']}")
    got = frame.get("version")
    acc = ((expect_version,) if expect_version is not None else None) \
        or accept_versions or SUPPORTED_VERSIONS
    if got not in set(int(v) for v in acc):
        raise ProtocolError(
            f"protocol version mismatch: peer chose {got}, "
            f"this end accepts {sorted(acc)}"
        )
    return int(got)


def make_envelope(seq: int, ack: int, msg: Message) -> Dict[str, Any]:
    """Wrap one Message for the v1 JSON wire: its session sequence number
    plus a piggybacked cumulative ack of the peer's stream.  (v2 senders
    use :func:`encode_envelope_wire` directly.)"""
    return {"seq": int(seq), "ack": int(ack),
            "msg": {"kind": msg.kind.value, "client_id": int(msg.client_id),
                    "payload": _to_jsonable(msg.payload)}}


def parse_envelope(frame: Dict[str, Any]) -> Tuple[int, int, Message]:
    """Envelope frame dict (either version, as produced by
    :func:`decode_wire_body`) -> (seq, ack, Message); raises on a
    non-envelope."""
    try:
        seq, ack, body = frame["seq"], frame["ack"], frame["msg"]
    except KeyError as e:
        raise ProtocolError(f"not an envelope frame: missing {e}") from None
    return int(seq), int(ack), Message(
        MsgType(body["kind"]), body["client_id"], _from_jsonable(body["payload"])
    )
