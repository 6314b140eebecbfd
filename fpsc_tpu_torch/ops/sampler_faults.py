"""Wrong samplers the replay check must reject.

Each maker takes the operands and meta of a right sampler and gives
those of a sampler wrong in one part: the operands or settings that a
right sampler given the true ones would have to mistake.  The card check
(chip_smoke.py) and the tests run the kernel, or the plain version, on
them and require `lpcnet_sampler.replay_faults` to find a fault.
"""
from __future__ import annotations

import dataclasses

import torch


def reverse_excitations(ops, meta):
    """GRU_A's weights on the embeddings of the previous excitations in
    reverse order: the sampler that feeds them newest first (at bunch=2,
    e_p2 and e_p1 swapped)."""
    e, n = meta.e_dim, meta.bunch
    blocks = ops.wiemb_t[n * e:2 * n * e].reshape(n, e, -1).flip(0)
    w = ops.wiemb_t.clone()
    w[n * e:2 * n * e] = blocks.reshape(n * e, -1)
    return ops._replace(wiemb_t=w), meta


def swap_head_samples(ops, meta):
    """The heads' weights on emb(hist[15]) and emb(hist[14]) swapped."""
    hb, e = meta.hb, meta.e_dim
    w = ops.fch_t.clone()
    w[hb:hb + e], w[hb + e:hb + 2 * e] = (ops.fch_t[hb + e:hb + 2 * e],
                                          ops.fch_t[hb:hb + e])
    return ops._replace(fch_t=w), meta


def swap_head_positions(ops, meta):
    """The heads of sub-samples 1 and 2 swapped: the row blocks 0 and 1
    of fch (column blocks of fch_t)."""
    n = 2 * meta.levels
    w = ops.fch_t.clone()
    w[:, :n], w[:, n:2 * n] = ops.fch_t[:, n:2 * n], ops.fch_t[:, :n]
    return ops._replace(fch_t=w), meta


def drop_block(ops, meta):
    """The pattern without the last block of its fullest row block."""
    pattern = list(meta.pattern)
    row = max(range(len(pattern)), key=lambda r: len(pattern[r]))
    pattern[row] = pattern[row][:-1]
    return ops, dataclasses.replace(meta, pattern=tuple(pattern))


def scales_to_one(name: str):
    """The int8 weight `name`'s row scales (s_<name>) all set to 1."""
    key = f"s_{name}"

    def make(ops, meta):
        return ops._replace(**{key: torch.ones_like(getattr(ops, key))}), meta
    return make


def reverse_row_scales(ops, meta):
    """GRU_A's recurrent int8 row scales in reverse order."""
    return ops._replace(s_wh_a=ops.s_wh_a.flip(0).contiguous()), meta


def wrong_operands(meta):
    """The samplers that must fail the replay at full width, for the
    form of meta: {what: (ops, meta) -> (wrong ops, wrong meta)}.  The
    faults common to every form run on the bunch=1 and bunch=2 forms;
    the bunch=4, int8 and cdf-product forms get those of their own
    parts."""
    wrong = {}
    if meta.bunch < 4 and not meta.w8:
        wrong["no GRU_A recurrent product"] = lambda o, m: (
            o._replace(wh_a_t=torch.zeros_like(o.wh_a_t)), m)
        wrong["LPC history reversed"] = lambda o, m: (
            o._replace(lpc_rev=o.lpc_rev.flip(-1).contiguous()), m)
    if meta.bunch == 2:
        wrong["head 2 zeroed"] = lambda o, m: (
            o._replace(fch_t=torch.zeros_like(o.fch_t)), m)
        wrong["e_p2 and e_p1 swapped"] = reverse_excitations
    if meta.bunch == 4:
        wrong["head embeddings of hist[15] and hist[14] swapped"] = \
            swap_head_samples
        wrong["head positions 1 and 2 swapped"] = swap_head_positions
        wrong["previous excitations reversed"] = reverse_excitations
    if meta.w8:
        wrong["GRU_B input scales set to 1"] = scales_to_one("wi_b")
    if meta.w8 and meta.dtype == torch.float32:
        # the rows of random weights have near-equal maxima, so reversed
        # scales move the recurrent product by a few percent: within the
        # bf16 tolerance
        wrong["GRU_A recurrent row scales reversed"] = reverse_row_scales
    if meta.pattern is not None and meta.dtype == torch.float32:
        # one of the flagship's 22 live blocks moves the cdf by 2e-5 to
        # 2e-3 of its total over two frames: past the f32 tolerance for
        # every block, within bf16's for most
        wrong["one live block dropped"] = drop_block
    return wrong
