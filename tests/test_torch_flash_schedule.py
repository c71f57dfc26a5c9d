"""The flash-attention wrapper's host-side logic, on the CPU.

``choose_path`` picks the kernel's path before the launch from the dtype,
the head size and the operands' alignment: ``wgmma`` for bf16 whose rows
16-byte copies can read, ``ffma`` for the rest; ``choose_bwd_path`` does the
same for the backward over q, k, v, o and dO (``bwd_wgmma``, ``bwd_ffma``).
``kv_tiles`` is the kernel's block-skip: the KV tiles a query tile visits;
``q_tiles`` its mirror for the backward's dK/dV kernel, the query tiles that
see a KV tile.  ``bwd_head_splits`` cuts a GQA group's query heads across
dK/dV blocks where the grid is too small for the card.  These tests hold
the choosers on every condition they read, both tile ranges on every path
against a brute-force count of the live (query, key) pairs under causal,
window and suffix masks (every live pair lies in a visited tile, and every
visited tile holds one), and the head split's cover of the group.
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


def _qkvod(**kw):
    """q, k, v and the backward's o and dO (q's shape)."""
    q, k, v = _qkv(**kw)
    return q, k, v, torch.zeros_like(q), torch.zeros_like(q)


# the forward's chooser over (q, k, v) and the backward's over (q, k, v, o, dO):
# the same conditions, each path's names
CHOOSERS = [
    pytest.param(ops.choose_path, _qkv, ("wgmma", "ffma"), id="forward"),
    pytest.param(ops.choose_bwd_path, _qkvod, ("bwd_wgmma", "bwd_ffma"), id="backward"),
]


@pytest.mark.parametrize("choose,operands,paths", CHOOSERS)
@pytest.mark.parametrize("d", [8, 16, 56, 64, 72, 128, 200, 256])
def test_bf16_with_16_byte_rows_takes_wgmma(choose, operands, paths, d):
    assert choose(*operands(d=d)) == paths[0]


@pytest.mark.parametrize("choose,operands,paths", CHOOSERS)
@pytest.mark.parametrize("d", [8, 64, 128, 256])
def test_f32_takes_ffma(choose, operands, paths, d):
    assert choose(*operands(d=d, dtype=torch.float32)) == paths[1]


@pytest.mark.parametrize("choose,operands,paths", CHOOSERS)
@pytest.mark.parametrize("d", [1, 4, 20, 36, 100, 250])
def test_bf16_head_size_off_8_takes_ffma(choose, operands, paths, d):
    assert choose(*operands(d=d)) == paths[1]


@pytest.mark.parametrize("choose,operands,paths,which", [
    *[pytest.param(ops.choose_path, _qkv, ("wgmma", "ffma"), w, id=f"forward-{w}")
      for w in range(3)],
    *[pytest.param(ops.choose_bwd_path, _qkvod, ("bwd_wgmma", "bwd_ffma"), w, id=f"backward-{w}")
      for w in range(5)]])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_a_stride_off_8_takes_ffma(choose, operands, paths, which, axis):
    """One operand with a batch, sequence or head stride that is no
    multiple of 8 elements: its rows are not 16-byte aligned."""
    t = list(operands())
    strides = list(t[which].stride())
    strides[axis] += 4
    base = torch.zeros(2 * t[which].numel() + 64, dtype=t[which].dtype)
    t[which] = base.as_strided(t[which].shape, strides)
    assert choose(*t) == paths[1]
    strides[axis] += 4                                 # 8 more elements: aligned again
    t[which] = base.as_strided(t[which].shape, strides)
    assert choose(*t) == paths[0]


@pytest.mark.parametrize("choose,operands,paths,which", [
    *[pytest.param(ops.choose_path, _qkv, ("wgmma", "ffma"), w, id=f"forward-{w}")
      for w in range(3)],
    *[pytest.param(ops.choose_bwd_path, _qkvod, ("bwd_wgmma", "bwd_ffma"), w, id=f"backward-{w}")
      for w in range(5)]])
def test_a_pointer_off_16_bytes_takes_ffma(choose, operands, paths, which):
    t = list(operands())
    flat = torch.zeros(t[which].numel() + 1, dtype=t[which].dtype)
    t[which] = flat[1:].view(t[which].shape)
    assert t[which].data_ptr() % 16 == 2
    assert choose(*t) == paths[1]
    flat = torch.zeros(t[which].numel() + 8, dtype=t[which].dtype)
    t[which] = flat[8:].view(t[which].shape)          # 16 bytes past an aligned start
    assert choose(*t) == paths[0]


@pytest.mark.parametrize("choose,operands,paths", CHOOSERS)
def test_transposed_views_keep_wgmma(choose, operands, paths):
    """(B, H, S, D) storage viewed as (B, S, H, D), as a model may hand it over."""
    t = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in operands()]
    assert not t[0].is_contiguous()
    assert choose(*t) == paths[0]


def test_tiles_by_path_and_head_size():
    assert ops.tiles("ffma", 256) == (64, 64)
    assert [ops.tiles("wgmma", d) for d in (8, 64, 128, 136, 256)] == \
        [(128, 128), (128, 128), (128, 128), (128, 64), (128, 64)]
    # the backward: the dK/dV kernel's (q tile, KV tile), then the dQ kernel's
    assert [ops.bwd_tiles("bwd_ffma", d) for d in (8, 64, 128, 136, 256)] == \
        [((64, 64),) * 2] * 3 + [((64, 32),) * 2] * 2
    assert [ops.bwd_tiles("bwd_wgmma", d) for d in (8, 64, 128, 136, 256)] == \
        [((64, 64), (64, 64))] * 3 + [((64, 64), (64, 32))] * 2
    with pytest.raises(ValueError):
        ops.bwd_tiles("wgmma", 64)


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
@pytest.mark.parametrize("path", ops.BWD_PATHS)
@pytest.mark.parametrize("d", [64, 256])
def test_backward_tiles_cover_exactly_the_live_pairs(sq, skv, causal, window, path, d):
    """The dK/dV kernel's q tiles and the dQ kernel's KV tiles, at each
    backward path's tiles (bwd_ffma 64 x 64, 64 x 32 at D = 256; bwd_wgmma
    64 x 64, and 64 dQ rows over 32 keys at D = 256)."""
    dkdv, dq = ops.bwd_tiles(path, d)
    _check_q_tiles(sq, skv, causal, window, *dkdv)
    _check_tiles(sq, skv, causal, window, *dq)


SMS = 132   # the H100's multiprocessors


@pytest.mark.parametrize("b,hk,group,n_kt", [
    (4, 1, 16, 32),       # recurrentgemma-9b served (MQA 16/1, 4 x 2048, D 256): 128 blocks
    (8, 1, 16, 2),        # its training shape (8 x 128): 16 blocks
    (1, 1, 16, 32),       # MQA, D 256, one sequence of 2048
    (2, 2, 4, 2),         # GQA 8/2 at 256 positions, 128-key tiles
    (1, 1, 4, 6),         # MQA 4/1 at 384 positions
    (1, 2, 2, 4),         # a suffix: GQA 4/2 over 512 keys
    (4, 8, 6, 18),        # internvl2-26b served (GQA 48/8, 4 x 2304, D 128): fills the card
    (4, 16, 1, 16),       # MHA: nothing to split
    (1, 1, 7, 1),         # a group that no split count divides
    (1, 1, 3, 100),
])
def test_head_splits_cover_the_group_once(b, hk, group, n_kt):
    """Every query head of a group falls in exactly one split, no split is
    empty, and the grid reaches two blocks a multiprocessor where the group
    has the heads to get there."""
    splits, per = ops.bwd_head_splits(b, hk, group, n_kt, SMS)
    heads = [h for sp in range(splits) for h in range(sp * per, min(group, (sp + 1) * per))]
    assert sorted(heads) == list(range(group))
    assert all(sp * per < group for sp in range(splits))
    blocks = b * hk * n_kt
    assert blocks * splits >= 2 * SMS or splits == group or blocks >= 2 * SMS


@pytest.mark.parametrize("b,hk,group,n_kt", [(4, 8, 6, 18), (4, 16, 1, 16), (8, 16, 1, 1),
                                             (264, 1, 16, 1), (2, 4, 4, 40)])
def test_one_split_where_the_grid_fills_the_card(b, hk, group, n_kt):
    """No workspace and no extra launch where the (batch, KV head, key tile)
    blocks already fill the card, or there is one head a group."""
    assert ops.bwd_head_splits(b, hk, group, n_kt, SMS) == (1, group)


@settings(max_examples=80, deadline=None)
@given(b=st.integers(1, 8), hk=st.integers(1, 16), group=st.integers(1, 48),
       n_kt=st.integers(1, 64))
def test_head_splits_cover_the_group_once_for_any_grid(b, hk, group, n_kt):
    splits, per = ops.bwd_head_splits(b, hk, group, n_kt, SMS)
    assert 1 <= splits <= group and per >= 1
    assert (splits - 1) * per < group <= splits * per      # each head once, no split empty
    assert (splits == 1) == (group == 1 or b * hk * n_kt >= 2 * SMS)


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
