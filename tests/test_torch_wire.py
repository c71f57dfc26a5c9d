"""The port's wire codec against the reference's: the same ``Message`` frames
to the same bytes under v1, v2 and v2 with deflate, the handshakes (HMAC
signed too) are byte-identical, each package decodes the other's frames,
bf16 travels as a CPU ``torch.bfloat16``, corrupt frames raise the same
typed errors, and a ``torch.Tensor`` payload is refused (wire payloads are
numpy at the seams)."""
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.fed import transport as ref
from repro_torch.fed import transport as port

_LEN = struct.Struct(">I")

#: every v2 wire dtype but bf16 (tested on its own: torch on the port's side)
DTYPES = [name for name in ref.WIRE_DTYPES.values() if name != "bfloat16"]
SHAPES = [(), (0,), (1,), (3,), (2, 3), (4, 1, 2), (0, 5)]
SEEDS = [0, 1, 4321]
MODES = {"v1": (1, False), "v2": (2, False), "v2-deflate": (2, True)}


def _make_array(seed, dtype, shape):
    """tests/test_wire_codec.py's array recipe."""
    n = int(np.prod(shape)) if shape else 1
    base = (np.arange(n, dtype=np.float64) * 7 + seed) % 251 - 125
    return base.astype(dtype).reshape(shape)


def _payload(pkg, seed, dtype):
    """One nested payload of every shape of ``dtype`` with scalars, strings,
    None and both compressed wire types of ``pkg``."""
    arrs = {f"s{i}": _make_array(seed + i, dtype, s) for i, s in enumerate(SHAPES)}
    big = _make_array(seed, "float32", (64, 16))           # deflate takes it
    return {
        "arrs": arrs, "big": big, "n": seed, "f": seed * 0.5, "none": None,
        "flag": bool(seed % 2), "s": "x" * (seed % 5), "lst": [arrs["s3"], seed, "y"],
        "q": pkg.QuantizedTensor(_make_array(seed, "int8", (3, 4)), 0.015625),
        "t": pkg.TopKTensor(np.array([0, 7], np.int32),
                            np.array([1.5, -2.25], np.float32), (2, 4)),
        "nested": {"np_int": np.int64(seed), "np_float": np.float32(0.25), "empty": {}},
    }


def _frame(pkg, seed, dtype, mode):
    version, deflate = MODES[mode]
    msg = pkg.Message(pkg.MsgType.UPLOAD, seed % 97, _payload(pkg, seed, dtype))
    return pkg.encode_envelope_wire(seed, seed + 1, msg, version=version, deflate=deflate)


def _decode(pkg, data):
    frame, payload_bytes = pkg.decode_wire_body(data[_LEN.size:])
    seq, ack, msg = pkg.parse_envelope(frame)
    return seq, ack, msg, payload_bytes


def _plain(x):
    """A decoded payload as comparable plain values (either package's types)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if type(x).__name__ == "QuantizedTensor":
        return ("q8", _plain(x.q), x.scale)
    if type(x).__name__ == "TopKTensor":
        return ("topk", _plain(x.idx), _plain(x.vals), tuple(x.shape))
    if isinstance(x, torch.Tensor):
        return ("bf16", tuple(x.shape), x.view(torch.int16).numpy().tobytes())
    if isinstance(x, np.ndarray):
        if x.dtype == np.dtype(ml_dtypes.bfloat16):
            return ("bf16", x.shape, x.view(np.int16).tobytes())
        return (str(x.dtype), x.shape, x.tobytes())
    return x


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_same_message_frames_to_the_same_bytes_and_crosses(dtype, seed, mode):
    r, p = _frame(ref, seed, dtype, mode), _frame(port, seed, dtype, mode)
    assert p.data == r.data
    assert (p.payload_bytes, p.header_bytes, p.version) == (
        r.payload_bytes, r.header_bytes, r.version)
    # each package decodes the other's frame to what its own decodes
    r_own, r_cross = _decode(ref, r.data), _decode(ref, p.data)
    p_own, p_cross = _decode(port, p.data), _decode(port, r.data)
    for a, b in ((r_own, p_cross), (p_own, r_cross), (r_own, p_own)):
        assert a[:2] == b[:2] and a[3] == b[3]
        assert (a[2].kind.value, a[2].client_id) == (b[2].kind.value, b[2].client_id)
        assert _plain(a[2].payload) == _plain(b[2].payload)
    assert isinstance(p_cross[2].payload["q"], port.QuantizedTensor)
    assert isinstance(p_cross[2].payload["t"], port.TopKTensor)


@pytest.mark.parametrize("key", [None, b"s3cret"])
def test_handshakes_are_byte_identical_and_verify_across(key):
    for version, accept in ((2, None), (1, None), (2, (1, 2)), (3, None)):
        hr = ref.make_client_hello(7, "sess-a", 4, version=version, accept=accept, auth_key=key)
        hp = port.make_client_hello(7, "sess-a", 4, version=version, accept=accept, auth_key=key)
        assert port.encode_frame(hp) == ref.encode_frame(hr)
        assert port.verify_session_auth(hr, key) and ref.verify_session_auth(hp, key)
        try:
            want = ref.negotiate_version(hr, ref.SUPPORTED_VERSIONS)
        except ref.ProtocolError as e:
            with pytest.raises(port.ProtocolError, match="no common protocol version"):
                port.negotiate_version(hp, port.SUPPORTED_VERSIONS)
            assert "no common" in str(e)
        else:
            assert port.negotiate_version(hp, port.SUPPORTED_VERSIONS) == want
    if key is not None:
        forged = dict(ref.make_client_hello(7, "sess-a", 4, auth_key=b"other"))
        assert not port.verify_session_auth(forged, key)
        assert port.sign_session(key, 7, "sess-a") == ref.sign_session(key, 7, "sess-a")
    for resumed in (False, True):
        assert (port.encode_frame(port.make_server_hello(9, resumed=resumed, version=2))
                == ref.encode_frame(ref.make_server_hello(9, resumed=resumed, version=2)))
    assert (port.encode_frame(port.make_error_hello("nope"))
            == ref.encode_frame(ref.make_error_hello("nope")))


@pytest.mark.parametrize("mode", list(MODES))
def test_bf16_goes_through_torch_bfloat16(mode):
    version, deflate = MODES[mode]
    vals = np.arange(-300, 300, dtype=np.float32) / 7.0
    r = ref.encode_envelope_wire(1, 0, ref.Message(
        ref.MsgType.UPLOAD, 1, {"w": vals.astype(ml_dtypes.bfloat16).reshape(20, 30)}),
        version=version, deflate=deflate)
    t = torch.from_numpy(vals).to(torch.bfloat16).reshape(20, 30)
    p = port.encode_envelope_wire(1, 0, port.Message(port.MsgType.UPLOAD, 1, {"w": t}),
                                  version=version, deflate=deflate)
    assert p.data == r.data
    got = _decode(port, r.data)[2].payload["w"]
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    assert got.device.type == "cpu" and torch.equal(got, t)
    back = _decode(ref, p.data)[2].payload["w"]
    assert back.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(back.view(np.int16), t.view(torch.int16).numpy())
    # a 0-d bf16 tensor keeps its shape
    zero_d = torch.tensor(1.5, dtype=torch.bfloat16)
    one = _decode(port, port.encode_envelope_wire(
        1, 0, port.Message(port.MsgType.UPLOAD, 1, {"w": zero_d}), version=version).data)
    assert one[2].payload["w"].shape == () and float(one[2].payload["w"]) == 1.5


def _v2_header_frame(header: bytes, blob: bytes = b"") -> bytes:
    pre = struct.pack(">BBI", ref.WIRE_V2_MAGIC, 0, len(header))
    pad = (-(len(pre) + len(header))) % 8
    return pre + header + b"\0" * pad + blob


def _corrupt_cases():
    good = ref.encode_envelope_wire(
        1, 0, ref.Message(ref.MsgType.UPLOAD, 0, {"w": np.arange(4096, dtype=np.float32)}),
        version=2, deflate=True).data[_LEN.size:]
    plain = ref.encode_envelope_wire(
        1, 0, ref.Message(ref.MsgType.UPLOAD, 0, {"w": np.arange(32, dtype=np.float32)}),
        version=2).data[_LEN.size:]
    smashed = bytearray(good)
    smashed[-8:] = b"\x00" * 8
    flipped = bytearray(plain)
    flipped[-3] ^= 0xFF
    v1 = ref.encode_envelope_wire(1, 0, ref.Message(ref.MsgType.WAIT, 2), version=1).data
    return {
        "v2 truncated before its header": plain[:3],
        "v2 header overruns the body": plain[:20],
        "v2 header not JSON": _v2_header_frame(b"{not json"),
        "v2 blob crc mismatch": bytes(flipped),
        "v2 unknown dtype tag": _v2_header_frame(
            b'{"seq":1,"ack":0,"msg":{"kind":"upload","client_id":0,"payload":{}},'
            b'"segs":[{"d":"fp128","s":[1],"o":0,"l":16,"e":"raw"}]}', b"\0" * 24),
        "v2 segment overruns the blob": _v2_header_frame(
            b'{"seq":1,"ack":0,"msg":{"kind":"upload","client_id":0,"payload":{}},'
            b'"segs":[{"d":"f32","s":[8],"o":0,"l":32,"e":"raw"}]}', b"\0" * 8),
        "v2 missing segment": _v2_header_frame(
            b'{"seq":1,"ack":0,"msg":{"kind":"upload","client_id":0,'
            b'"payload":{"w":{"__seg__":3}}},"segs":[]}'),
        "v2 corrupt deflate segment": bytes(smashed),
        "v1 truncated JSON": v1[_LEN.size:-5],
    }


CORRUPT = _corrupt_cases()


@pytest.mark.parametrize("case", list(CORRUPT))
def test_corrupt_frames_raise_the_same_typed_errors(case):
    body = CORRUPT[case]
    errs = []
    for pkg in (ref, port):
        with pytest.raises(Exception) as info:
            frame, _ = pkg.decode_wire_body(body)
            pkg.parse_envelope(frame)
        errs.append(info.value)
    r, p = errs
    assert type(p).__name__ == type(r).__name__ and str(p) == str(r), (r, p)
    assert isinstance(p, (port.FrameError, ValueError))


def test_frame_decoder_streams_and_refuses_oversize_alike():
    msgs = [(ref.Message(ref.MsgType.UPLOAD, i, {"w": np.full(i + 1, i, np.float32)}),
             port.Message(port.MsgType.UPLOAD, i, {"w": np.full(i + 1, i, np.float32)}))
            for i in range(5)]
    stream_r = b"".join(ref.encode_envelope_wire(i, 0, m, version=2).data
                        for i, (m, _) in enumerate(msgs))
    stream_p = b"".join(port.encode_envelope_wire(i, 0, m, version=2).data
                        for i, (_, m) in enumerate(msgs))
    assert stream_p == stream_r
    dec_r, dec_p = ref.FrameDecoder(raw=True), port.FrameDecoder(raw=True)
    out_r, out_p = [], []
    for i in range(0, len(stream_r), 7):                 # 7-byte chunks
        out_r += dec_r.feed(stream_r[i:i + 7])
        out_p += dec_p.feed(stream_r[i:i + 7])
    assert out_p == out_r and len(out_p) == 5 and dec_p.pending_bytes == 0
    for pkg in (ref, port):
        with pytest.raises(pkg.FrameError, match="exceeds"):
            pkg.FrameDecoder().feed(_LEN.pack(pkg.MAX_FRAME_BYTES + 1))


def test_cached_segments_and_serializing_transport_match():
    params = {"w": _make_array(3, "float32", (32, 8)), "b": _make_array(4, "float32", (8,))}
    cr = ref.precompute_segments(params, deflate=False)
    cp = port.precompute_segments(params, deflate=False)
    assert (cp.digest, cp.blob, cp.crc) == (cr.digest, cr.blob, cr.crc)
    er = ref.encode_envelope_cached(5, 2, ref.MsgType.TRAIN, 3, cr, {"round": 1})
    ep = port.encode_envelope_cached(5, 2, port.MsgType.TRAIN, 3, cp, {"round": 1})
    assert ep.data == er.data
    hp = port.hydrate_cached(cp)
    np.testing.assert_array_equal(hp["w"], params["w"])
    tr, tp = ref.SerializingTransport(), port.SerializingTransport()
    for t, pkg in ((tr, ref), (tp, port)):
        t.send_to_server(pkg.Message(pkg.MsgType.UPLOAD, 1, {"delta": params, "n": 3}))
        t.send_to_client(pkg.Message(pkg.MsgType.TRAIN, 1, {"params": params}))
    assert (tp.wire_bytes, tp.payload_bytes, tp.header_bytes, tp.messages_encoded) == (
        tr.wire_bytes, tr.payload_bytes, tr.header_bytes, tr.messages_encoded)
    got = tp.poll_server()
    np.testing.assert_array_equal(got.payload["delta"]["w"], params["w"])


@pytest.mark.parametrize("where", ["v1", "v2", "quantized", "cached", "serializing"])
def test_torch_tensor_payload_raises_type_error(where):
    t = torch.ones(2, 3)
    with pytest.raises(TypeError, match="numpy at the seams"):
        if where == "v1":
            port.encode_envelope_wire(0, 0, port.Message(port.MsgType.UPLOAD, 0, {"d": t}),
                                      version=1)
        elif where == "v2":
            port.encode_envelope_wire(0, 0, port.Message(port.MsgType.UPLOAD, 0,
                                                         {"d": {"w": [t]}}), version=2)
        elif where == "quantized":
            port.encode_envelope_wire(0, 0, port.Message(
                port.MsgType.UPLOAD, 0, {"d": port.QuantizedTensor(t.to(torch.int8), 1.0)}))
        elif where == "cached":
            port.precompute_segments({"w": t})
        else:
            port.SerializingTransport().send_to_server(
                port.Message(port.MsgType.UPLOAD, 0, {"d": t}))
    port.check_numpy_tree({"w": [np.zeros(2), torch.zeros(2, dtype=torch.bfloat16)]}, "x")
    with pytest.raises(TypeError, match="the seam: payload value is a torch.Tensor"):
        port.check_numpy_tree({"w": [np.zeros(2), t]}, "the seam")
