"""The flash-attention wrapper's host-side logic, on the CPU.

``choose_path`` picks the kernel's path before the launch from the dtype,
the head size and the operands' alignment: ``wgmma`` for bf16 whose rows
16-byte copies can read, ``ffma`` for the rest.  ``kv_tiles`` is the
kernel's block-skip: the KV tiles a query tile visits; ``q_tiles`` its
mirror for the backward's dK/dV kernel, the query tiles that see a KV tile.
These tests hold the chooser on every condition it reads, and both tile
ranges against a brute-force count of the live (query, key) pairs under
causal, window and suffix masks: every live pair lies in a visited tile,
and every visited tile holds one.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - dev extra not installed
    from _hypothesis_fallback import given, settings, strategies as st


def _qkv(b=2, sq=16, skv=24, hq=4, hk=2, d=64, dtype=torch.bfloat16):
    return (torch.zeros((b, sq, hq, d), dtype=dtype), torch.zeros((b, skv, hk, d), dtype=dtype),
            torch.zeros((b, skv, hk, d), dtype=dtype))


@pytest.mark.parametrize("d", [8, 16, 56, 64, 72, 128, 200, 256])
def test_bf16_with_16_byte_rows_takes_wgmma(d):
    assert ops.choose_path(*_qkv(d=d)) == "wgmma"


@pytest.mark.parametrize("d", [8, 64, 128, 256])
def test_f32_takes_ffma(d):
    assert ops.choose_path(*_qkv(d=d, dtype=torch.float32)) == "ffma"


@pytest.mark.parametrize("d", [1, 4, 20, 36, 100, 250])
def test_bf16_head_size_off_8_takes_ffma(d):
    assert ops.choose_path(*_qkv(d=d)) == "ffma"


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_a_stride_off_8_takes_ffma(which, axis):
    """One operand with a batch, sequence or head stride that is no
    multiple of 8 elements: its rows are not 16-byte aligned."""
    t = list(_qkv())
    strides = list(t[which].stride())
    strides[axis] += 4
    base = torch.zeros(2 * t[which].numel() + 64, dtype=t[which].dtype)
    t[which] = base.as_strided(t[which].shape, strides)
    assert ops.choose_path(*t) == "ffma"
    strides[axis] += 4                                 # 8 more elements: aligned again
    t[which] = base.as_strided(t[which].shape, strides)
    assert ops.choose_path(*t) == "wgmma"


@pytest.mark.parametrize("which", [0, 1, 2])
def test_a_pointer_off_16_bytes_takes_ffma(which):
    t = list(_qkv())
    flat = torch.zeros(t[which].numel() + 1, dtype=t[which].dtype)
    t[which] = flat[1:].view(t[which].shape)
    assert t[which].data_ptr() % 16 == 2
    assert ops.choose_path(*t) == "ffma"
    flat = torch.zeros(t[which].numel() + 8, dtype=t[which].dtype)
    t[which] = flat[8:].view(t[which].shape)          # 16 bytes past an aligned start
    assert ops.choose_path(*t) == "wgmma"


def test_transposed_views_keep_wgmma():
    """(B, H, S, D) storage viewed as (B, S, H, D), as a model may hand it over."""
    t = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in _qkv()]
    assert not t[0].is_contiguous()
    assert ops.choose_path(*t) == "wgmma"


def test_tiles_by_path_and_head_size():
    assert ops.tiles("ffma", 256) == (64, 64)
    assert [ops.tiles("wgmma", d) for d in (8, 64, 128, 136, 256)] == \
        [(128, 128), (128, 128), (128, 128), (128, 64), (128, 64)]
    assert [ops.bwd_tiles(d) for d in (8, 64, 128, 136, 256)] == \
        [(64, 64), (64, 64), (64, 64), (64, 32), (64, 32)]


def _live(sq, skv, causal, window):
    """(Sq, Skv) bool: the pairs the masks leave live (suffix convention)."""
    qpos = np.arange(sq)[:, None] + (skv - sq)
    kpos = np.arange(skv)[None, :]
    live = np.ones((sq, skv), bool)
    if causal:
        live &= kpos <= qpos
    if window is not None:
        live &= kpos > qpos - window
    return live


def _check_tiles(sq, skv, causal, window, tq, tk):
    live = _live(sq, skv, causal, window)
    seen = 0
    for qt in range(-(-sq // tq)):
        begin, end = ops.kv_tiles(qt, sq, skv, causal, window, tq, tk)
        rows = live[qt * tq:(qt + 1) * tq]
        holding = {kt for kt in range(-(-skv // tk)) if rows[:, kt * tk:(kt + 1) * tk].any()}
        if holding:
            assert set(range(begin, end)) == holding, (qt, begin, end, sorted(holding))
        else:
            assert begin >= end, (qt, begin, end)
        seen += int(rows[:, begin * tk:max(begin, end) * tk].sum())
    assert seen == int(live.sum())      # no live pair outside the visited tiles


def _check_q_tiles(sq, skv, causal, window, tq, tk):
    live = _live(sq, skv, causal, window)
    seen = 0
    for kt in range(-(-skv // tk)):
        begin, end = ops.q_tiles(kt, sq, skv, causal, window, tq, tk)
        cols = live[:, kt * tk:(kt + 1) * tk]
        holding = {qt for qt in range(-(-sq // tq)) if cols[qt * tq:(qt + 1) * tq].any()}
        if holding:
            assert set(range(begin, end)) == holding, (kt, begin, end, sorted(holding))
        else:
            assert begin >= end, (kt, begin, end)
        seen += int(cols[begin * tq:max(begin, end) * tq].sum())
    assert seen == int(live.sum())      # no live pair outside the visited tiles


SHAPES = [
    (2048, 2048, True, None),           # qwen1.5-0.5b, olmoe-1b-7b prefill
    (2304, 2304, True, None),           # internvl2-26b prefill: 256 patches + 2048 tokens
    (2048, 2048, False, None),          # whisper-base's encoder: bidirectional
    (2048, 2048, True, 2048),           # recurrentgemma-9b: the window covers every causal key
    (2048, 2048, True, 512),            # a window edge inside the tiles
    (128, 2048, True, None),            # suffix: the queries are the last 128 positions
    (200, 200, True, 48),
    (384, 384, True, 128),
    (130, 130, False, None),
    (70, 70, False, 7),                 # a window without the causal mask
    (37, 150, True, 24),
    (150, 37, True, None),              # more queries than keys: early rows see none
]


@pytest.mark.parametrize("sq,skv,causal,window", SHAPES)
@pytest.mark.parametrize("path,d", [("wgmma", 64), ("wgmma", 256), ("ffma", 64)])
def test_kv_tiles_cover_exactly_the_live_pairs(sq, skv, causal, window, path, d):
    _check_tiles(sq, skv, causal, window, *ops.tiles(path, d))


@pytest.mark.parametrize("sq,skv,causal,window", SHAPES)
@pytest.mark.parametrize("d", [64, 256])
def test_backward_tiles_cover_exactly_the_live_pairs(sq, skv, causal, window, d):
    """The dK/dV kernel's q tiles and the dQ kernel's KV tiles, at the
    backward's tiles (64 x 64; 64 x 32 at D = 256)."""
    _check_q_tiles(sq, skv, causal, window, *ops.bwd_tiles(d))
    _check_tiles(sq, skv, causal, window, *ops.bwd_tiles(d))


@settings(max_examples=60, deadline=None)
@given(sq=st.integers(1, 400), extra=st.integers(-50, 400), causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(1, 300)), tq=st.sampled_from([64, 128]),
       tk=st.sampled_from([64, 128]))
def test_kv_tiles_cover_exactly_the_live_pairs_for_any_shape(sq, extra, causal, window, tq, tk):
    _check_tiles(sq, max(1, sq + extra), causal, window, tq, tk)


@settings(max_examples=60, deadline=None)
@given(sq=st.integers(1, 400), extra=st.integers(-50, 400), causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(1, 300)), tq=st.sampled_from([64, 128]),
       tk=st.sampled_from([32, 64, 128]))
def test_q_tiles_cover_exactly_the_live_pairs_for_any_shape(sq, extra, causal, window, tq, tk):
    _check_q_tiles(sq, max(1, sq + extra), causal, window, tq, tk)
