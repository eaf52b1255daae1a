"""Batched granule DSP chain in JAX — the accelerator compute path.

Processes T time-ordered granules of one stream (or, via vmap in
go_mp3_tpu.parallel, a batch of streams) in a single fused XLA computation:

  requantize -> reorder -> stereo -> antialias -> IMDCT/hybrid ->
  overlap-add -> frequency inversion -> polyphase synthesis -> int16 PCM

Design notes (how this maps the reference's loops onto dense arrays):
 - Every data-dependent loop in the reference (frame.go:184-302, 361-452)
   becomes a static gather/mask using the per-line maps in tables.py; shapes
   are fully static ([T, 2, 576]).
 - The reference's two pieces of sequential state are re-expressed as pure
   shifts along the time axis, so NO lax.scan is needed:
     * IMDCT overlap-add `store` (frame.go:473-476) = raw[t-1, :, 18:],
     * the polyphase `vVec` ring (frame.go:637-653) = a FIFO of the last 16
       matrixed v-vectors, making the 512-tap windowed sum a 16-tap FIR over
       the v time-sequence — fully parallel over granules.
 - The heavy math (IMDCT-36, polyphase matrixing) is dense f32 matmuls,
   and every matmul runs at Precision.HIGHEST: true f32 products on any
   backend. On a GPU, DEFAULT and HIGH f32 dots may run in TF32 (a 10-bit
   mantissa), which breaks parity wherever an operand carries real-valued
   data; the contractions here are at most 6*39 = 234 wide, so reduced
   precision would have little to gain.

The chunk function takes a `valid` granule count so callers can pad T to a
fixed chunk size (one XLA compilation) — padding granules only ever influence
later rows, which are discarded.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..consts import (  # noqa: re-export (layout contract)
    HEAD_LINES,
    SAMPLES_PER_GR,
    SIDE_WIDTH,
)
from . import tables as T

_F32 = jnp.float32
# The one matmul precision of the chain (see the module docstring).
_HI = jax.lax.Precision.HIGHEST


class GranuleBatch(NamedTuple):
    """Fixed-shape device representation of T parsed granules."""

    spectra: jax.Array  # int16 [T, 2, 576] Huffman values, POST-REORDER layout
    scalefac_l: jax.Array  # int32 [T, 2, 22]
    scalefac_s: jax.Array  # int32 [T, 2, 13, 3]
    global_gain: jax.Array  # int32 [T, 2]
    scalefac_scale: jax.Array  # int32 [T, 2]
    preflag: jax.Array  # int32 [T, 2]
    subblock_gain: jax.Array  # int32 [T, 2, 3]
    block_type: jax.Array  # int32 [T, 2]
    block_class: jax.Array  # int32 [T, 2]  (0 long / 1 short / 2 mixed)
    variant: jax.Array  # int32 [T]  (lsf * 3 + sfreq)
    ms_flag: jax.Array  # bool [T]
    is_flag: jax.Array  # bool [T]
    count1_r: jax.Array  # int32 [T]  right-channel rzero start
    mono: jax.Array  # bool [T]


class DecodeState(NamedTuple):
    """Cross-chunk DSP state for one stream (the explicit, serializable
    analogue of the reference's Frame.store / Frame.vVec)."""

    store: jax.Array  # f32 [2, 32, 18]
    v_fifo: jax.Array  # f32 [2, 16, 64], index 0 = most recent


def init_state() -> DecodeState:
    return DecodeState(
        store=jnp.zeros((2, 32, 18), _F32),
        v_fifo=jnp.zeros((2, 16, 64), _F32),
    )


# Device-resident constant tables
_PRETAB22 = jnp.asarray(T.PRETAB.astype(np.float32))  # [22]
_LONG_BAND_START = jnp.asarray(T.LONG_BAND_START)  # [6, 23]
_SHORT_BAND_START3 = jnp.asarray(T.SHORT_BAND_START3)  # [6, 14]
_CS = jnp.asarray(T.CS)
_CA = jnp.asarray(T.CA)
_COS_N36 = jnp.asarray(T.COS_N36)
_IMDCT_WIN = jnp.asarray(T.IMDCT_WIN)
_SYNTH_N_WIN = jnp.asarray(T.SYNTH_N_WIN)
_SYNTH_DTBL = jnp.asarray(T.SYNTH_DTBL)
_FREQ_INV = jnp.asarray(T.FREQ_INV_SIGN)
_E_LONG = jnp.asarray(T.E_LONG)  # [6*22, 576]
_E_SHORT = jnp.asarray(T.E_SHORT)  # [6*39, 576]
_E_SHORT_IS = jnp.asarray(T.E_SHORT_IS)  # [6*39, 576]
_LINE = jnp.arange(SAMPLES_PER_GR, dtype=jnp.int32)
_NV = T.N_BAND_VARIANTS


# Short-block IMDCT as ONE [18, 36] matrix: the 12-point IMDCT cosines,
# the short window, and the 3 overlapping sub-block placements
# (imdct.go: s[i][p] lands at output sample 6 + 6*i + p) compose into
#   M3[3m + i, 6 + 6i + p] = COS_N12[m, p] * win_short[p]
# so the short path is a single einsum of the same [.., 18] x [18, 36]
# shape as the long path — no [.., 3, 12] sub-tensors and no second
# placement matmul. The window
# fold moves one rounding from data to constants (data*(cos*win) vs
# (data*cos)*win, ~1 ulp); the overlap adds become part of the 18-term
# HIGHEST dot. Both effects are far below the stage-parity bounds and
# position-invariant (the contraction width matches the existing long
# einsum — see _polyphase for why 576-wide contractions are the ones
# that break chunk invariance).
_SHORT_M3_NP = np.zeros((18, 36), np.float32)
for _m in range(6):
    for _i in range(3):
        for _p in range(12):
            _SHORT_M3_NP[3 * _m + _i, 6 + 6 * _i + _p] = (
                T.COS_N12[_m, _p] * T.IMDCT_WIN[2, _p]
            )
_SHORT_M3 = jnp.asarray(_SHORT_M3_NP)


def _variant_onehot(variant: jax.Array) -> jax.Array:
    """[T] int -> [T, 6] f32 one-hot (elementwise, no gather)."""
    return (variant[:, None] == jnp.arange(_NV)[None, :]).astype(_F32)


def _expand_bands(values: jax.Array, vh: jax.Array, e: jax.Array) -> jax.Array:
    """Per-band -> per-line via the static one-hot expansion matmul.

    values: [T, C, B] per-band values; vh: [T, 6] variant one-hot;
    e: [6*B, 576]. Values are placed into their variant's row block
    (masked broadcast, no gather) and one matmul scatters them to lines;
    with a 0/1 matrix at HIGHEST the result is exact in f32.

    The operand is assembled with repeat/tile along the trailing axis and
    the matmul runs over flattened [T*C, 6B] rows.
    """
    t_dim, c_dim, b_dim = values.shape
    # big[t, c, v*B + b] = values[t, c, b] * vh[t, v]
    # NOTE: jnp.repeat kept on purpose — the repeat's gather materializes
    # this dot operand, a fusion barrier that shields the dot's codegen
    # from chunk-shape-dependent operand fusion (the known 1-LSB
    # chunk-invariance hazard, see _polyphase docstring). It is tiny
    # ([T, 6B]); a broadcast+reshape would save nothing measurable.
    vh_rep = jnp.repeat(vh, b_dim, axis=-1)  # [T, 6B]
    big = jnp.tile(values, (1, 1, _NV)) * vh_rep[:, None, :]
    out = jnp.dot(
        big.reshape(t_dim * c_dim, _NV * b_dim), e, precision=_HI
    )
    return out.reshape(t_dim, c_dim, e.shape[1])


def _select_by_variant(vh: jax.Array, table: jax.Array) -> jax.Array:
    """[T,6] one-hot x [6, N] constant -> [T, N] (tiny matmul, no gather)."""
    return jnp.einsum("tv,vn->tn", vh, table.astype(_F32), precision=_HI)


def _line_is_long(cls: jax.Array) -> jax.Array:
    """Per-line long/short path mask given block class [..., 1]."""
    return (cls == T.CLASS_LONG) | (
        (cls == T.CLASS_MIXED) & (_LINE < 36)
    )


def _requantize(b: GranuleBatch) -> jax.Array:
    """frame.go:140-255, gather-free: per-band exponents expanded to lines
    by a one-hot matmul; |x|^(4/3) fused into the exp2.

    Input spectra are in POST-REORDER layout (host applies the short-block
    permutation after Huffman decode), so the short-band maps baked into
    _E_SHORT are the permutation-composed ones (tables.py)."""
    spectra = b.spectra
    vh = _variant_onehot(b.variant)

    sf_mult = jnp.where(b.scalefac_scale != 0, 1.0, 0.5).astype(_F32)
    gain = 0.25 * (b.global_gain.astype(_F32) - 210.0)  # [T, 2]

    # per-band exponents
    a_long_b = (
        -(sf_mult[..., None]
          * (b.scalefac_l.astype(_F32)
             + b.preflag.astype(_F32)[..., None] * _PRETAB22))
        + gain[..., None]
    )  # [T, 2, 22]
    sbg39 = jnp.tile(b.subblock_gain.astype(_F32), (1, 1, 13))  # [T,2,39]
    a_short_b = (
        -(sf_mult[..., None] * b.scalefac_s.astype(_F32).reshape(
            *b.scalefac_s.shape[:2], 39))
        + gain[..., None]
        - 2.0 * sbg39
    )  # 0.25 * 8 = 2
    a_long = _expand_bands(a_long_b, vh, _E_LONG)
    a_short = _expand_bands(a_short_b, vh, _E_SHORT)

    cls = b.block_class[..., None]  # [T, 2, 1]
    a = jnp.where(_line_is_long(cls), a_long, a_short)

    absx = jnp.abs(spectra).astype(_F32)
    sign = jnp.sign(spectra).astype(_F32)
    # |x|^(4/3) * 2^a == exp2(a + 4/3*log2|x|); x == 0 -> log2 = -inf -> 0
    mag = jnp.exp2(a + (4.0 / 3.0) * jnp.log2(absx))
    return sign * mag


def _ratio_from_is_pos(is_pos: jax.Array, table: np.ndarray) -> jax.Array:
    """Map is_pos in 0..6 to its ratio constant via a select chain."""
    out = jnp.full(is_pos.shape, float(table[0]), _F32)
    for k in range(1, 7):
        out = jnp.where(is_pos == k, float(table[k]), out)
    return out


def _stereo(b: GranuleBatch, x: jax.Array) -> jax.Array:
    """frame.go:308-420: MS stereo over all lines (equivalent to the
    max-count1 bound since rzero lines are zero) + per-band intensity
    multipliers expanded to lines by the one-hot matmul."""
    left, right = x[:, 0], x[:, 1]

    ms = (b.ms_flag & ~b.mono)[:, None]
    new_l = (left + right) * T.INV_SQRT2
    new_r = (left - right) * T.INV_SQRT2
    left = jnp.where(ms, new_l, left)
    right = jnp.where(ms, new_r, right)

    # Intensity stereo (uses channel 0's block geometry; frame.go:379-419).
    # The reference iterates BANDS, not lines: long blocks touch long bands
    # 0..20; short blocks short bands 0..11; mixed blocks long bands 0..7
    # AND short bands 3..11 — and since long band 8 can start past line 36,
    # a mixed granule's overlap lines get BOTH multipliers applied. We
    # therefore expand two independent per-band multiplier sets and multiply
    # both in (each defaults to 1 where not applicable).
    vh = _variant_onehot(b.variant)
    c1r = b.count1_r.astype(_F32)[:, None]
    gate = (b.is_flag & ~b.mono)[:, None]  # [T, 1]
    cls0 = b.block_class[:, 0][:, None]  # [T, 1]

    # long bands: processed for long (sfb 0..20) and mixed (sfb 0..7) blocks
    band_start_l = _select_by_variant(vh, _LONG_BAND_START[:, :22])  # [T,22]
    is_pos_l = b.scalefac_l[:, 0, :]  # [T, 22]
    band_idx_l = jnp.arange(22)
    long_cap = jnp.where(
        cls0 == T.CLASS_LONG, 20, jnp.where(cls0 == T.CLASS_MIXED, 7, -1)
    )
    apply_l = (
        gate
        & (band_start_l >= c1r)
        & (band_idx_l <= long_cap)
        & (is_pos_l < 7)
    )
    ml_l = jnp.where(apply_l, _ratio_from_is_pos(is_pos_l, T.IS_RATIO_L), 1.0)
    mr_l = jnp.where(apply_l, _ratio_from_is_pos(is_pos_l, T.IS_RATIO_R), 1.0)

    # short bands (win-major positions over the reordered data, matching the
    # reference's indexing): short blocks sfb 0..11, mixed blocks sfb 3..11
    bs3 = _select_by_variant(vh, _SHORT_BAND_START3[:, :13])  # [T, 13]
    band_start_s = jnp.repeat(bs3, 3, axis=1)  # [T, 39]
    is_pos_s = b.scalefac_s[:, 0].reshape(-1, 39)
    sfb_idx = jnp.repeat(jnp.arange(13), 3)
    short_lo = jnp.where(
        cls0 == T.CLASS_SHORT, 0, jnp.where(cls0 == T.CLASS_MIXED, 3, 13)
    )
    apply_s = (
        gate
        & (band_start_s >= c1r)
        & (sfb_idx >= short_lo)
        & (sfb_idx <= 11)
        & (is_pos_s < 7)
    )
    ml_s = jnp.where(apply_s, _ratio_from_is_pos(is_pos_s, T.IS_RATIO_L), 1.0)
    mr_s = jnp.where(apply_s, _ratio_from_is_pos(is_pos_s, T.IS_RATIO_R), 1.0)

    # expand multipliers (default 1 -> encode as delta from 1) and compose.
    # Left/right ride one expansion dot each for long and short (stacked
    # on the channel axis — rows of the dot are independent, so values
    # are identical to per-channel calls at half the dispatches).
    m_long = jnp.stack([ml_l, mr_l], axis=1)  # [T, 2, 22]
    m_short = jnp.stack([ml_s, mr_s], axis=1)  # [T, 2, 39]
    dl = _expand_bands(m_long - 1.0, vh, _E_LONG)
    ds = _expand_bands(m_short - 1.0, vh, _E_SHORT_IS)
    mult = (1.0 + dl) * (1.0 + ds)  # [T, 2, 576]
    return jnp.stack([left, right], axis=1) * mult


def _antialias(b: GranuleBatch, x: jax.Array) -> jax.Array:
    """frame.go:427-452: 8 butterflies at each active subband boundary."""
    xb = x.reshape(*x.shape[:2], 32, 18)
    lower = xb[..., :31, 10:18][..., ::-1]  # [..., 31, 8]; idx i -> line 18sb-1-i
    upper = xb[..., 1:, 0:8]
    lb = lower * _CS - upper * _CA
    ub = upper * _CS + lower * _CA

    cls = b.block_class[..., None]  # [T, 2, 1] over boundary axis
    bidx = jnp.arange(31)
    active = jnp.where(
        cls == T.CLASS_SHORT,
        jnp.zeros((31,), bool),
        jnp.where(cls == T.CLASS_MIXED, bidx < 1, jnp.ones((31,), bool)),
    )[..., None]  # [T, 2, 31, 1]

    new_lower = jnp.where(active, lb, lower)
    new_upper = jnp.where(active, ub, upper)
    xb = xb.at[..., :31, 10:18].set(new_lower[..., ::-1])
    xb = xb.at[..., 1:, 0:8].set(new_upper)
    return xb.reshape(x.shape)


def _imdct(b: GranuleBatch, x: jax.Array) -> jax.Array:
    """imdct.go:83-108 over all subbands: returns rawout [T, 2, 32, 36]."""
    blocks = x.reshape(*x.shape[:2], 32, 18)

    # effective block type: mixed forces long windows on subbands 0-1
    bt = b.block_type[..., None]  # [T, 2, 1]
    sb_idx = jnp.arange(32)
    mixed = (b.block_class == T.CLASS_MIXED)[..., None]
    bt_eff = jnp.where(mixed & (sb_idx < 2), 0, bt)  # [T, 2, 32]

    # window select chain (no gather). A one-hot matmul formulation
    # (bt_onehot @ _IMDCT_WIN) broke bit-invariance of a granule's PCM to
    # its row position in the chunk (XLA CPU fuses the windowing multiply
    # differently near the dot), which the streaming/whole-file identity
    # tests rely on — keep selects.
    win = jnp.zeros((*bt_eff.shape, 36), _F32)
    for k in range(4):
        win = jnp.where((bt_eff == k)[..., None], _IMDCT_WIN[k], win)

    raw_long = jnp.einsum(
        "tcbs,sp->tcbp", blocks, _COS_N36, precision=_HI
    ) * win

    # IMDCT-12 + short window + overlapped placement as one composed
    # einsum (see _SHORT_M3) — same shape as the long path's contraction
    raw_short = jnp.einsum(
        "tcbs,sp->tcbp", blocks, _SHORT_M3, precision=_HI
    )

    return jnp.where(bt_eff[..., None] == 2, raw_short, raw_long)


def _overlap_fold(raw: jax.Array, store_in: jax.Array) -> tuple[jax.Array, jax.Array]:
    """frame.go:473-476 as a shift along time: out = raw[t,:18] + raw[t-1,18:]."""
    uppers = jnp.concatenate([store_in[None], raw[:-1, ..., 18:]], axis=0)
    out = raw[..., :18] + uppers
    return out, raw[..., 18:]


def _polyphase(
    x18: jax.Array, v_fifo_in: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """frame.go:630-661 re-expressed as matmul + 16-tap FIR over v-vectors.

    x18: [T, 2, 32, 18] hybrid output. Returns (pcm_f32 [2, T*18, 32],
    v_history [2, 16 + T*18, 64]).

    The 16-tap FIR is a slice loop of elementwise multiply-adds. Composing
    N with the D taps offline into two dense 576x576 dots (x_prev carried
    instead of the v FIFO) made chunk-initial rows round 1 ulp differently
    from mid-chunk rows once XLA fused the x18 producer into the dot
    operands (CPU backend; optimization_barrier did not stop it), breaking
    the bit-invariance of a granule's PCM to chunk boundaries
    (test_dsp_parity test_chunking_invariance_deep), like the IMDCT one-hot
    window formulation (see _imdct). The small-contraction einsum +
    elementwise FIR below is structurally immune: every contraction is
    <= 64 wide and shape-independent."""
    t_dim = x18.shape[0]
    # contract straight over x18's subband axis — same products and dot
    # order as transposing first (bit-identical), but no explicit
    # swapaxes op for XLA to materialize as a [T,2,18,32] relayout copy
    v = jnp.einsum("tcjs,ij->tcsi", x18, _SYNTH_N_WIN, precision=_HI)
    rows = t_dim * 18
    vf = v.transpose(1, 0, 2, 3).reshape(2, rows, 64)
    # history rows oldest-first then the new rows
    vh = jnp.concatenate([v_fifo_in[:, ::-1], vf], axis=1)

    # Split vh's columns once so each tap slices only rows (bit-exact:
    # same k order and products as slicing the 64-wide vh per tap).
    v_a = vh[..., :32]
    v_b = vh[..., 32:]
    acc = jnp.zeros((2, rows, 32), _F32)
    for k in range(16):
        src = v_a if k % 2 == 0 else v_b
        dk = _SYNTH_DTBL[32 * k : 32 * (k + 1)]
        acc = acc + src[:, 16 - k : 16 - k + rows, :] * dk
    return acc, vh


def decode_chunk_impl(
    b: GranuleBatch, state: DecodeState, valid: jax.Array
) -> tuple[jax.Array, DecodeState]:
    """Decode T granules -> int16 PCM [T*576, 2] and the post-`valid` state.

    `valid` is the number of real granules (the rest are padding); output
    rows past valid*576 are garbage and must be discarded by the caller.
    """
    x = _requantize(b)
    x = _stereo(b, x)
    x = _antialias(b, x)
    raw = _imdct(b, x)
    out18, uppers = _overlap_fold(raw, state.store)
    x18 = out18 * _FREQ_INV
    pcm_f, vh = _polyphase(x18, state.v_fifo)

    t_dim = b.spectra.shape[0]
    samp = jnp.clip(pcm_f * 32767.0, -32767.0, 32767.0).astype(jnp.int32)
    pcm = samp.astype(jnp.int16).reshape(2, t_dim * SAMPLES_PER_GR)
    pcm = jnp.swapaxes(pcm, 0, 1)  # [T*576, 2]
    # broadcast+reshape, not jnp.repeat: repeat lowers to a gather (+
    # scatter-add under vmap) over the 147k sample axis. (Do not move the
    # select before the swapaxes either: reordering the output chain
    # re-layouts the polyphase einsum's codegen and moved single samples
    # by 1 LSB between chunk shapes.)
    mono_rows = jnp.broadcast_to(
        b.mono[:, None], (t_dim, SAMPLES_PER_GR)
    ).reshape(t_dim * SAMPLES_PER_GR)
    pcm = jnp.where(mono_rows[:, None], pcm[:, :1], pcm)

    # State after `valid` granules, extracted by one-hot contractions
    # rather than dynamic slices: with `valid` a traced per-stream value
    # (the corpus scan), vmapped dynamic_slice starts lower to gathers.
    # The one-hot rows select the same f32 values bit-exactly at HIGHEST
    # (products are value*1.0).
    t_sel = (jnp.arange(t_dim) == valid - 1).astype(_F32)
    store_out = jnp.einsum("t,tcbs->cbs", t_sel, uppers, precision=_HI)
    store_out = jnp.where(valid > 0, store_out, state.store)
    # v FIFO: rows valid*18 + k for k in 0..15 of vh, newest first
    r_sel = (
        jnp.arange(vh.shape[1])[None, :]
        == (valid * 18 + jnp.arange(16))[:, None]
    ).astype(_F32)  # [16, rows+16]
    fifo = jnp.einsum("kr,cri->cki", r_sel, vh, precision=_HI)
    return pcm, DecodeState(store=store_out, v_fifo=fifo[:, ::-1])


# ---------------------------------------------------------------------------
# Packed device interface: the host ships TWO flat int16 arrays per chunk
# (spectra [T, 1152] + sidecar [T, SIDE_WIDTH]) — the cheapest H2D layout —
# and the GranuleBatch fields are unpacked on device inside the jitted
# computation (static slices; free after XLA fusion). Layout must match
# native/mp3parse.cpp gmp_parse_packed (see native/lib.py SIDE_*).
# ---------------------------------------------------------------------------

def _batch_from_side_words(spectra2: jax.Array, s: jax.Array) -> GranuleBatch:
    """spectra2 int16 [T, 1152] + side WORDS int32 [T, 144] -> GranuleBatch."""
    t_dim = spectra2.shape[0]
    return GranuleBatch(
        spectra=spectra2.reshape(t_dim, 2, SAMPLES_PER_GR),
        scalefac_l=s[:, 22:66].reshape(t_dim, 2, 22),
        scalefac_s=s[:, 66:144].reshape(t_dim, 2, 13, 3),
        global_gain=s[:, 4:6],
        scalefac_scale=s[:, 6:8],
        preflag=s[:, 8:10],
        subblock_gain=s[:, 14:20].reshape(t_dim, 2, 3),
        block_type=s[:, 10:12],
        block_class=s[:, 12:14],
        variant=s[:, 0],
        ms_flag=(s[:, 1] & 1).astype(bool),
        is_flag=((s[:, 1] >> 1) & 1).astype(bool),
        count1_r=s[:, 2],
        mono=((s[:, 1] >> 2) & 1).astype(bool),
    )


def batch_from_packed(spectra2: jax.Array, side: jax.Array) -> GranuleBatch:
    """spectra2 int16 [T, 1152], side int16 [T, SIDE_WIDTH] -> GranuleBatch."""
    assert side.shape[-1] == SIDE_WIDTH, side.shape
    return _batch_from_side_words(spectra2, side.astype(jnp.int32))


def batch_from_packed8(
    tail8: jax.Array, head16: jax.Array, side8: jax.Array
) -> GranuleBatch:
    """int8-quantized interface -> GranuleBatch (native/lib.py SIDE8 layout).

    tail8 i8 [T, 1024] per-channel lines 64..575; head16 i16 [T, 128]
    per-channel lines 0..63, exact (the only region where |value| > 127
    occurs on real streams — the host parser falls back to the int16
    interface otherwise). The unpack is a pure widen + concatenate: no
    gather/scatter. side8 u8 [T, 168] = 22 LE int16 meta words (all
    non-negative) + int8 scalefactors."""
    t_dim = tail8.shape[0]
    head = head16.reshape(t_dim, 2, HEAD_LINES)
    tail = tail8.reshape(
        t_dim, 2, SAMPLES_PER_GR - HEAD_LINES
    ).astype(jnp.int16)
    spec = jnp.concatenate([head, tail], axis=-1)  # [T, 2, 576]
    u = side8.astype(jnp.int32)
    meta_words = u[:, 0:44:2] | (u[:, 1:44:2] << 8)  # [T, 22]
    s = jnp.concatenate([meta_words, u[:, 44:166]], axis=1)  # [T, 144]
    return _batch_from_side_words(spec.reshape(t_dim, 1152), s)


def decode_chunk_packed8_impl(
    tail8: jax.Array,
    head16: jax.Array,
    side8: jax.Array,
    state: DecodeState,
    valid: jax.Array,
) -> tuple[jax.Array, DecodeState]:
    """decode_chunk_impl over the int8-quantized host interface."""
    return decode_chunk_impl(batch_from_packed8(tail8, head16, side8), state, valid)


def decode_chunk_packed_impl(
    spectra2: jax.Array, side: jax.Array, state: DecodeState, valid: jax.Array
) -> tuple[jax.Array, DecodeState]:
    """decode_chunk_impl over the packed two-array host interface."""
    return decode_chunk_impl(batch_from_packed(spectra2, side), state, valid)


# ---------------------------------------------------------------------------
# Fused single-buffer chunk interface: the host ships ONE contiguous uint8
# buffer per [S, T] chunk instead of three arrays (tail/head/side), so each
# chunk costs one device_put dispatch instead of three.
# Layout (host builder: parallel/corpus.py build_fused_chunk):
#   [0, S*2*L*T)          int8 tail spectra, CHANNEL-MAJOR LINE-MAJOR
#                         [S, 2, L, T] where L <= 576-HEAD_LINES is the
#                         shipped per-channel tail-line count (lines
#                         HEAD_LINES..HEAD_LINES+L-1; lines past L are
#                         zero for every granule of the chunk, verified
#                         by the host against the parsed data)
#   [A, A + S*T*2*HEAD_WIDTH)  head plane, little-endian int16 bytes
#                         [S, T, HEAD_WIDTH, 2]
#   [A + ..., end)        side8 sidecar [S, T, SIDE8_WIDTH] u8
# The buffer is 2-D [S, stream_bytes] — one row per stream — so the mesh
# path still shards it on the stream axis. The per-channel split keeps a
# line cap expressible as a prefix slice.
# ---------------------------------------------------------------------------

_TAIL_LINES_FULL = SAMPLES_PER_GR - HEAD_LINES  # 512


def fused_stream_nbytes(t: int, tail_lines: int = _TAIL_LINES_FULL) -> int:
    """Bytes per stream row of a fused chunk buffer."""
    from ..consts import HEAD_WIDTH, SIDE8_WIDTH

    return 2 * tail_lines * t + t * 2 * HEAD_WIDTH + t * SIDE8_WIDTH


def unpack_fused(buf: jax.Array, t: int, tail_lines: int):
    """Fused u8 buffer [S, stream_bytes] -> (tail8 [S,T,1024] i8,
    head16 [S,T,128] i16, side8 [S,T,168] u8). Pure slice/reshape/widen —
    no gather; capped tail lines are zero-padded back (the host guarantees
    every granule of the chunk is zero past the cap)."""
    from ..consts import HEAD_WIDTH, SIDE8_WIDTH

    s = buf.shape[0]
    a = 2 * tail_lines * t
    b = a + t * 2 * HEAD_WIDTH
    tail = jax.lax.bitcast_convert_type(
        buf[:, :a].reshape(s, 2, tail_lines, t), jnp.int8
    )
    if tail_lines < _TAIL_LINES_FULL:
        tail = jnp.pad(
            tail, ((0, 0), (0, 0), (0, _TAIL_LINES_FULL - tail_lines), (0, 0))
        )
    tail = tail.transpose(0, 3, 1, 2).reshape(s, t, 2 * _TAIL_LINES_FULL)
    hb = buf[:, a:b].reshape(s, t, HEAD_WIDTH, 2).astype(jnp.int32)
    v = hb[..., 0] | (hb[..., 1] << 8)
    head = (v - 2 * (v & 32768)).astype(jnp.int16)  # sign-extend LE pairs
    side = buf[:, b:].reshape(s, t, SIDE8_WIDTH)
    return tail, head, side


def fused_stream_nbytes_mono(t: int, tail_lines: int = _TAIL_LINES_FULL) -> int:
    """Bytes per stream row of a MONO-lane fused chunk buffer: only the
    channel-0 planes ship (ch1 of every mono granule is all-zero by the
    parser's contract and is reconstructed as zeros on device) — roughly
    half the stereo row."""
    from ..consts import SIDE8_WIDTH

    return tail_lines * t + t * 2 * HEAD_LINES + t * SIDE8_WIDTH


def unpack_fused_mono(buf: jax.Array, t: int, tail_lines: int):
    """Mono-lane fused u8 buffer [S, mono_stream_bytes] -> the SAME
    (tail8 [S,T,1024] i8, head16 [S,T,128] i16, side8 [S,T,168] u8)
    shapes as unpack_fused, with the ch1 planes reconstructed as zeros.
    Exact by construction: the parser emits all-zero ch1 for mono
    granules, so these are the identical decoder inputs."""
    from ..consts import SIDE8_WIDTH

    s = buf.shape[0]
    a = tail_lines * t
    b = a + t * 2 * HEAD_LINES
    tail0 = jax.lax.bitcast_convert_type(
        buf[:, :a].reshape(s, 1, tail_lines, t), jnp.int8
    )
    if tail_lines < _TAIL_LINES_FULL:
        tail0 = jnp.pad(
            tail0, ((0, 0), (0, 0), (0, _TAIL_LINES_FULL - tail_lines), (0, 0))
        )
    tail = jnp.concatenate([tail0, jnp.zeros_like(tail0)], axis=1)
    tail = tail.transpose(0, 3, 1, 2).reshape(s, t, 2 * _TAIL_LINES_FULL)
    hb = buf[:, a:b].reshape(s, t, HEAD_LINES, 2).astype(jnp.int32)
    v = hb[..., 0] | (hb[..., 1] << 8)
    head0 = (v - 2 * (v & 32768)).astype(jnp.int16)  # [S, T, 64]
    head = jnp.concatenate(
        [head0[:, :, None, :], jnp.zeros_like(head0)[:, :, None, :]], axis=2
    ).reshape(s, t, 2 * HEAD_LINES)
    side = buf[:, b:].reshape(s, t, SIDE8_WIDTH)
    return tail, head, side


def decode_chunk_fused_batch_impl(
    buf: jax.Array, states, valids: jax.Array, *, t: int, tail_lines: int
):
    """Batched chunk decode over the fused buffer: [S, stream_bytes] u8 ->
    (pcm [S, T*576, 2], states)."""
    tail, head, side = unpack_fused(buf, t, tail_lines)
    return jax.vmap(decode_chunk_packed8_impl)(tail, head, side, states, valids)


def decode_chunk_fused_mono_batch_impl(
    buf: jax.Array, states, valids: jax.Array, *, t: int, tail_lines: int
):
    """decode_chunk_fused_batch_impl for the HALF-WIDTH mono wire layout
    ([S, mono_stream_bytes] u8; ch1 reconstructed as zeros on device)."""
    tail, head, side = unpack_fused_mono(buf, t, tail_lines)
    return jax.vmap(decode_chunk_packed8_impl)(tail, head, side, states, valids)


# Single-stream chunk decode: [T, ...] -> [T*576, 2]
decode_chunk = jax.jit(decode_chunk_impl)

# Single-stream packed-interface decode: ([T,1152] i16, [T,144] i16, ...)
decode_chunk_packed = jax.jit(decode_chunk_packed_impl)

# Packed-interface batch decode: ([S,T,1152], [S,T,144], states, valid[S])
decode_chunk_packed_batch = jax.jit(jax.vmap(decode_chunk_packed_impl))

# int8-quantized batch decode: ([S,T,1024] i8, [S,T,128] i16, [S,T,168] u8)
decode_chunk_packed8_batch = jax.jit(jax.vmap(decode_chunk_packed8_impl))

# Multi-stream batch decode (vmap over a leading stream axis):
# [S, T, ...] -> [S, T*576, 2]; see go_mp3_tpu.parallel for the sharded form.
decode_chunk_batch = jax.jit(jax.vmap(decode_chunk_impl))
