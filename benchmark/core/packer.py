"""The benchmark's own writer of range-coded `.fpsc` containers.

A frozen copy of the encode side of the codec's Python range coder and
container format (the port's codec/range_coder.py `pack_utterance_rc`
with its adaptive, prior-seeded models, codec/bitstream.py's pitch
codes, and codec/container.py `write_fpsc` for whole, entropy-coded
utterances).  The benchmark generates the symbols and writes the
container with this copy, so that the program under test only decodes
it, and the reference starts from the same symbols.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

_TOP = 1 << 24
_BOT = 1 << 16
_PITCH_DELTA_RANGE = 32
_PITCH_ESCAPE = 2 * _PITCH_DELTA_RANGE
_VQ_CTX = 4
_IND_RUN_CTX = 6
_PITCH_V_CTX = 3
_SCL_NB = 8


class _Encoder:
    """Carry-less 32-bit range encoder with the minimal flush."""

    def __init__(self):
        self.low = 0
        self.range = 0xFFFFFFFF
        self.out = bytearray()

    def encode(self, cum: int, freq: int, total: int):
        r = self.range // total
        self.low = (self.low + r * cum) & 0xFFFFFFFFFFFF
        self.range = r * freq
        while True:
            if (self.low ^ (self.low + self.range)) < _TOP:
                pass
            elif self.range < _BOT:
                self.range = (-self.low) & (_BOT - 1)
                if self.range == 0:
                    self.range = _BOT
            else:
                break
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & 0xFFFFFFFF
            self.range = (self.range << 8) & 0xFFFFFFFF

    def finish(self) -> bytes:
        hi = self.low + self.range
        v = self.low
        for k in (4, 3, 2, 1):
            step = 1 << (8 * k)
            cand = -(-self.low // step) * step
            if cand < hi:
                v = cand
                break
        else:
            k = 0
        v &= 0xFFFFFFFF
        for _ in range(4 - k):
            self.out.append((v >> 24) & 0xFF)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


class _Adaptive:
    """Adaptive frequency model: +24 a coded symbol, halved (floor 1)
    when the total passes 4096."""

    def __init__(self, n: int, prior=None, prior_mass: int = 2048):
        self.counts = np.ones(n, np.int64)
        if prior is not None:
            p = np.asarray(prior, np.float64)
            assert p.shape == (n,), (p.shape, n)
            self.counts = 1 + np.floor(
                p / max(p.sum(), 1.0) * prior_mass).astype(np.int64)

    def code(self, enc: _Encoder, sym: int) -> int:
        c = self.counts
        enc.encode(int(c[:sym].sum()), int(c[sym]), int(c.sum()))
        c[sym] += 24
        if c.sum() > (1 << 12):
            self.counts = np.maximum(1, c >> 1)
        return sym


def scl_split(n: int) -> Tuple[int, int]:
    n = int(n)
    nb = 4 if n <= 16 else _SCL_NB
    while nb > 1 and n % nb:
        nb //= 2
    nb = min(nb, n)
    return nb, max(1, n // nb)


def _vq_ctx(prev_index: int, prev_size: int) -> int:
    shift = max(0, (int(prev_size) - 1).bit_length() - 2)
    return min(_VQ_CTX - 1, int(prev_index) >> shift)


def _voicing(corr_code: int) -> int:
    return 0 if corr_code <= 2 else (1 if corr_code <= 5 else 2)


def _run_bucket(run: int) -> int:
    return 0 if run == 0 else min(int(run), 16).bit_length()


def prior_layout(sizes: Dict) -> Dict[str, tuple]:
    """The shape of each prior's counts: the context axes, then the
    alphabet."""
    nb, off = scl_split(sizes["scl"])
    out = {"ind1": (2, _IND_RUN_CTX, 2), "ind2": (2, _IND_RUN_CTX, 2),
           "scl_bucket": (nb + 1, nb), "scl_offset": (nb, off),
           "pitch_abs": (256,), "pitch_delta": (_PITCH_V_CTX,
                                                _PITCH_ESCAPE + 1),
           "corr": (8, 8)}
    if sizes.get("scl_bl"):
        nb, off = scl_split(sizes["scl_bl"])
        out["scl_bl_bucket"] = (nb + 1, nb)
        out["scl_bl_offset"] = (nb, off)
    for key in ("vq", "vq_bl"):
        for s, e in enumerate(sizes.get(key, [])):
            out[f"{key}_{s}"] = (e,) if s == 0 else (_VQ_CTX, e)
    return out


def _models(sizes: Dict, priors: Dict) -> Dict:
    def seeded(key, shape):
        p = priors.get(key)

        def build(p, shape):
            if len(shape) == 1:
                return _Adaptive(shape[0], p)
            return [build(None if p is None else p[c], shape[1:])
                    for c in range(shape[0])]

        return build(p, shape)

    return {k: seeded(k, shape) for k, shape in prior_layout(sizes).items()}


def scalar_orders(books: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Value ranks of the scalar books (numpy's argsort of argsort)."""
    return {k: np.argsort(np.argsort(books[k])) for k in ("scl", "scl_bl")
            if k in books}


def quantize_pitch(pitch: np.ndarray) -> np.ndarray:
    """(L, 2) [period feature, correlation] -> (L, 2) int codes."""
    period = np.clip(np.floor(0.1 + 50.0 * pitch[:, 0] + 100.0),
                     32, 287).astype(np.int64) - 32
    corr = np.clip(np.round((pitch[:, 1] + 0.5) * 7.0), 0, 7).astype(
        np.int64)
    return np.stack([period, corr], 1)


def dequantize_pitch(codes: np.ndarray) -> np.ndarray:
    period = codes[:, 0].astype(np.float64) + 32
    f18 = (period - 100.0) / 50.0
    corr = codes[:, 1].astype(np.float64) / 7.0 - 0.5
    return np.stack([f18, corr], 1).astype(np.float32)


def pack_utterance(ind1, ind2, idx: Dict, pcodes: np.ndarray, sizes: Dict,
                   priors: Dict, orders: Dict) -> bytes:
    """One utterance's symbols -> its payload: the frame count in two
    bytes, then the range-coded body."""
    m = _models(sizes, priors)
    enc = _Encoder()
    nb_scl, off_scl = scl_split(sizes["scl"])
    nb_bl, off_bl = scl_split(sizes.get("scl_bl", 0) or 1)
    st = dict(prev_p=0, prev_c=0, prev_i1=0, prev_i2=0, run_i1=0, run_i2=0,
              pb_scl=nb_scl, pb_bl=nb_bl)
    length = len(ind1)

    def chain(key, rank, prev_bucket, off):
        b, o = divmod(int(rank), off)
        m[f"{key}_bucket"][prev_bucket].code(enc, b)
        if off > 1:
            m[f"{key}_offset"][b].code(enc, o)
        return b

    for t in range(length):
        i1, i2 = int(ind1[t]), int(ind2[t])
        m["ind1"][st["prev_i1"]][_run_bucket(st["run_i1"])].code(enc, i1)
        m["ind2"][st["prev_i2"]][_run_bucket(st["run_i2"])].code(enc, i2)
        st["run_i1"] = st["run_i1"] + 1 if t > 0 and i1 == st["prev_i1"] \
            else 1
        st["run_i2"] = st["run_i2"] + 1 if t > 0 and i2 == st["prev_i2"] \
            else 1
        st["prev_i1"], st["prev_i2"] = i1, i2
        p = int(pcodes[t][0])
        if t == 0:
            m["pitch_abs"].code(enc, p)
        else:
            d = p - st["prev_p"]
            table = m["pitch_delta"][_voicing(st["prev_c"])]
            if -_PITCH_DELTA_RANGE <= d < _PITCH_DELTA_RANGE:
                table.code(enc, d + _PITCH_DELTA_RANGE)
            else:
                table.code(enc, _PITCH_ESCAPE)
                m["pitch_abs"].code(enc, p)
        st["prev_p"] = p
        c = int(pcodes[t][1])
        m["corr"][st["prev_c"]].code(enc, c)
        st["prev_c"] = c
        if i1:
            st["pb_scl"] = chain("scl", orders["scl"][int(idx["scl"][t])],
                                 st["pb_scl"], off_scl)
        elif "scl_bl_bucket" in m:
            st["pb_bl"] = chain("scl_bl",
                                orders["scl_bl"][int(idx["scl_bl"][t])],
                                st["pb_bl"], off_bl)
        key = "vq" if i2 else "vq_bl"
        prev = 0
        for s, e in enumerate(sizes.get(key, [])):
            model = m[f"{key}_{s}"]
            if s > 0:
                model = model[_vq_ctx(prev, sizes[key][s - 1])]
            prev = model.code(enc, int(idx[key][t][s]))
    return int(length).to_bytes(2, "big") + enc.finish()


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return struct.pack(">B", len(raw)) + raw


def write_container(path: str, utterances: Sequence[Tuple[str, bytes]],
                    sizes: Dict, l1: float, l2: float) -> int:
    """A version-2 container of whole range-coded utterances (threshold
    encoder, `full` preset, 16 kHz) -> bytes written."""
    out: List[bytes] = [b"FPSC", struct.pack(">BB", 2, 1), _pack_str("full"),
                        struct.pack(">fff", l1, l2, 1000.0),
                        struct.pack(">HH", sizes["scl"], sizes["scl_bl"]),
                        struct.pack(">B", len(sizes["vq"]))]
    out += [struct.pack(">H", n) for n in sizes["vq"]]
    out.append(struct.pack(">B", len(sizes["vq_bl"])))
    out += [struct.pack(">H", n) for n in sizes["vq_bl"]]
    out.append(struct.pack(">IH", 16000, len(utterances)))
    for name, payload in utterances:
        out += [_pack_str(name), struct.pack(">I", len(payload)), payload]
    blob = b"".join(out)
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)
