"""Operations and bytes of the LPCNet sampler kernel's work, from the
configuration's widths alone.

`least_time` is the least time one call of the folded sampler could take
on the card's published peaks (core/peaks.py): the larger of its
operations over the peak rate and its bytes over the memory bandwidth.
The work is that of the sampler as the kernel runs it since the
embedding products were folded into tables: per item and GRU step the
MACs of GRU_A's recurrent product (only its live blocks), GRU_B's two
products and every head's product on h_b, at the peak of the sampler's
precision; each gathered table row's adds (the 2*bunch+1 GRU_A input
rows, each further head's embedding rows) and each draw's levels-1
prefix-sum adds in float32.  Bytes count every input once and every
output once: the per-frame streams (conditioning in the sampler's
precision, LPC, temperature, uniforms), the weights (GRU_A's recurrent
matrix only in its live blocks), the biases, the mu-law table, the
folded tables in float32, and the float32 output.
"""
from __future__ import annotations

from typing import Dict

from benchmark.core import peaks

FRAME = 160
HEAD_EMBEDS = {1: 0, 2: 2, 4: 3}
ORDER = 16


def live_rows(voc: Dict) -> float:
    """GRU_A recurrent weights that are live: 3 Ha Ha at density 1, else
    the live blocks' elements."""
    ha = voc["gru_a_units"]
    sp = voc.get("gru_a_sparsity")
    if not sp:
        return 3.0 * ha * ha
    return float(sp["live_blocks"] * sp["block"][0] * sp["block"][1])


def work(voc: Dict, batch: int, frames: int, dtype: str) -> Dict[str, float]:
    """{'flops', 'adds', 'bytes'} of one call on `batch` items of
    `frames` frames."""
    bunch, ha, hb = voc["bunch"], voc["gru_a_units"], voc["gru_b_units"]
    lv = voc["levels"]
    w = peaks.BYTES[dtype]
    n_emb, head_e = 2 * bunch + 1, HEAD_EMBEDS[bunch]
    rec = live_rows(voc)
    macs = rec + 3 * hb * (ha + hb) + bunch * 2 * lv * hb
    gather = n_emb * 3 * ha + (bunch - 1) * head_e * 2 * lv
    steps = batch * frames * FRAME // bunch
    samples = batch * frames * FRAME
    streams = batch * frames * ((3 * ha + 3 * hb) * w + ORDER * 4 + 4
                                + FRAME * 4)
    weights = (rec + 3 * hb * (ha + hb) + bunch * 2 * lv * hb) * w
    biases = (3 * ha + 3 * hb + 2 * lv + 2 * lv * (bunch - 1) + lv) * 4
    tables = 4.0 * lv * gather
    return {"flops": 2.0 * macs * steps,
            "adds": (lv - 1.0) * samples + gather * steps,
            "bytes": streams + weights + biases + tables + samples * 4}


def least_time(voc: Dict, batch: int, frames: int, dtype: str) -> float:
    """Seconds: the larger of the operations' and the bytes' least
    times; products and float32 adds run on different units, so the
    operations' time is the larger of the two in a low precision and
    their sum in float32."""
    wk = work(voc, batch, frames, dtype)
    t_mac = wk["flops"] / peaks.FLOPS[dtype]
    t_add = wk["adds"] / peaks.FLOPS["float32"]
    t_ops = t_mac + t_add if dtype == "float32" else max(t_mac, t_add)
    return max(t_ops, wk["bytes"] / peaks.HBM_BYTES_S)
