"""Per-stage device-vs-golden parity on the synthetic corpus.

test_synth_parity.py gates the END-TO-END synthetic decode at maxdiff <= 72
LSB (error compounds through stages on white-noise spectra). These tests
localize: every device stage is fed the GOLDEN implementation's input for
that stage, so each stage's own error is isolated and can be bounded
tightly — a stage regression of a few LSB-equivalents fails the named
stage's assert instead of hiding under the loose end-to-end bound.

Stage bounds (all far below 1 output LSB ~ 3.05e-5):
  requantize  relative 2e-5   (f32 exp2/log2 vs f64 pow table)
  stereo      relative 1e-6
  antialias   relative 1e-6
  imdct       relative 2e-6 of max|input|  (cancellation-prone sums)
  polyphase   1 int16 LSB on the same x18 input (f32 vs f64 accumulation)
"""

import random

import numpy as np
import pytest

import go_mp3_tpu.ops.granule as G
from go_mp3_tpu.models.pipeline import granules_from_frame, pack_granule_batch
from go_mp3_tpu.ops import reference_dsp as R
from test_synth_parity import CASES, random_frame


def _golden_stages(f):
    """Run the golden chain stage by stage; returns per-granule dicts."""
    h, si, md = f.header, f.side_info, f.main_data
    nch = h.number_of_channels
    out = []
    for gr in range(h.granules):
        xs = [np.zeros(576, np.float32) for _ in range(2)]
        for ch in range(nch):
            x = R._requantize(h, si, md, gr, ch)
            xs[ch] = R._reorder(h, si, x, gr, ch)
        g1 = [x.copy() for x in xs]
        R._stereo(h, si, md, xs, gr, nch)
        g2 = [x.copy() for x in xs]
        g3 = [np.zeros(576, np.float32) for _ in range(2)]
        graw = np.zeros((2, 32, 36), np.float32)
        for ch in range(nch):
            g3[ch] = R._antialias(si, xs[ch], gr, ch)
            bt_gr = si.block_type[gr][ch]
            mixed = (
                si.win_switch_flag[gr][ch] == 1
                and si.mixed_block_flag[gr][ch] == 1
            )
            for sb in range(32):
                bt = 0 if (mixed and sb < 2) else bt_gr
                graw[ch, sb] = R._imdct_win(
                    g3[ch][sb * 18 : (sb + 1) * 18], bt
                )
        out.append({"g1": g1, "g2": g2, "g3": g3, "graw": graw, "nch": nch})
    return out


def _build(seed):
    rng = random.Random(seed)
    frames = [random_frame(rng, *case) for case in CASES]
    granules = []
    stages = []
    for f in frames:
        granules.extend(granules_from_frame(f))
        stages.extend(_golden_stages(f))
    batch, valid = pack_granule_batch(granules, pad_to=len(granules))
    return batch, stages


def _stack(stages, key):
    return np.stack([np.stack(s[key]) for s in stages])  # [T, 2, 576]


def _check_rel(dev, gold, nchs, bound, label):
    """Max |dev-gold| relative to the granule's own scale, real chs only."""
    scale = np.abs(gold).max() + 1e-30
    worst = 0.0
    for t in range(dev.shape[0]):
        for ch in range(nchs[t]):
            d = np.abs(dev[t, ch] - gold[t, ch]).max()
            worst = max(worst, d / scale)
    assert worst <= bound, f"{label}: rel err {worst:.3e} > {bound:.0e}"


@pytest.mark.parametrize("seed", [1, 12])
def test_stage_requantize_stereo_antialias_imdct(seed):
    batch, stages = _build(seed)
    nchs = [s["nch"] for s in stages]

    g1 = _stack(stages, "g1")
    d1 = np.asarray(G._requantize(batch))
    _check_rel(d1, g1, nchs, 2e-5, "requantize")

    # stereo: device stage applied to the GOLDEN requantize output
    import jax.numpy as jnp

    d2 = np.asarray(G._stereo(batch, jnp.asarray(g1)))
    g2 = _stack(stages, "g2")
    _check_rel(d2, g2, nchs, 1e-6, "stereo")

    d3 = np.asarray(G._antialias(batch, jnp.asarray(g2)))
    g3 = _stack(stages, "g3")
    _check_rel(d3, g3, nchs, 1e-6, "antialias")

    draw = np.asarray(G._imdct(batch, jnp.asarray(g3)))
    graw = np.stack([s["graw"] for s in stages])  # [T, 2, 32, 36]
    scale = np.abs(g3).max() + 1e-30
    worst = 0.0
    for t in range(draw.shape[0]):
        for ch in range(nchs[t]):
            worst = max(
                worst, np.abs(draw[t, ch] - graw[t, ch]).max() / scale
            )
    assert worst <= 2e-6, f"imdct: rel err {worst:.3e}"


@pytest.mark.parametrize("seed", [1, 12])
def test_stage_polyphase(seed):
    """Same x18 input -> device FIR-formulated polyphase vs the golden
    per-step matrixing must agree within 1 int16 LSB (pure f32-vs-f64
    accumulation difference)."""
    import jax.numpy as jnp

    t_dim = 24
    # synthesis-shaped random input at realistic magnitude (~unit scale)
    x18 = np.random.default_rng(seed).standard_normal(
        (t_dim, 2, 32, 18)
    ).astype(np.float32) * 0.3

    pcm_f, _vh = G._polyphase(jnp.asarray(x18), jnp.zeros((2, 16, 64)))
    dev = np.trunc(
        np.clip(np.asarray(pcm_f, np.float64) * 32767.0, -32767, 32767)
    ).astype(np.int32)  # [2, rows, 32]

    gold = np.zeros_like(dev)
    for ch in range(2):
        gd_ch = R.GoldenDecoder()
        for t in range(t_dim):
            pcm = gd_ch._subband_synthesis(x18[t, ch].reshape(-1), ch)
            gold[ch, t * 18 : (t + 1) * 18] = pcm.reshape(18, 32)
    d = np.abs(dev - gold)
    assert d.max() <= 1, f"polyphase maxdiff {d.max()} LSB"


def test_reduced_precision_sites_pinned():
    """Every matmul of the device chain runs at Precision.HIGHEST.

    On a GPU, DEFAULT and HIGH f32 dots may run in TF32 (10-bit mantissa),
    which breaks parity where an operand carries real-valued data (the
    intensity-stereo ratios, IMDCT and synthesis inputs); the CPU computes
    every precision in full f32, so no CPU numeric test can see a lowered
    site. This test pins the precision of every dot_general in the traced
    jaxpr, which is backend-independent.
    """
    import jax
    from jax.lax import Precision

    t = 4
    sds = jax.ShapeDtypeStruct
    b = G.GranuleBatch(
        spectra=sds((t, 2, 576), np.int16),
        scalefac_l=sds((t, 2, 22), np.int32),
        scalefac_s=sds((t, 2, 13, 3), np.int32),
        global_gain=sds((t, 2), np.int32),
        scalefac_scale=sds((t, 2), np.int32),
        preflag=sds((t, 2), np.int32),
        subblock_gain=sds((t, 2, 3), np.int32),
        block_type=sds((t, 2), np.int32),
        block_class=sds((t, 2), np.int32),
        variant=sds((t,), np.int32),
        ms_flag=sds((t,), bool),
        is_flag=sds((t,), bool),
        count1_r=sds((t,), np.int32),
        mono=sds((t,), bool),
    )
    jaxpr = jax.make_jaxpr(G.decode_chunk_impl)(
        b, G.init_state(), np.int32(t)
    )
    dots = [
        e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"
    ]
    assert len(dots) >= 8, "expected the full chain's matmul sites"
    for e in dots:
        prec = e.params["precision"]
        assert prec == (Precision.HIGHEST, Precision.HIGHEST), (
            f"matmul at {prec}, not HIGHEST "
            f"(rhs {e.invars[1].aval.shape})"
        )
