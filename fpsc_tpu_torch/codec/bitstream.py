"""Fixed-layout bitstream packing for the codec's transmitted data.

The reference never materialises a bitstream (it only prints usage
entropies, generate_qtz_features.py:94-101,202); for a complete codec
we pack per frame:

  [ind1 (1 bit)][ind2 (1 bit)]
  [scl index    (ceil(log2 K)    bits)  - above or below book by ind1]
  [vq stage s   (ceil(log2 E_s)  bits)  - above books      when ind2]
  [vq_bl stage  (ceil(log2 E_s)  bits)  - below books      when !ind2]

plus an 8-bit pitch period code and 3-bit correlation code per frame
(the reference reuses LPCNet's quantised pitch track; here pitch is
part of the stream).  Nominal rate at the reference configuration
(256/16 scalar, 2x1024 + 512 VQ, 100 frames/s) ~= 2 kb/s class.

A copy of fpsc_tpu/codec/bitstream.py: the PyTorch port keeps its own.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


class BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def write(self, value: int, nbits: int):
        v = int(value)
        assert 0 <= v < (1 << nbits), (value, nbits)
        for i in reversed(range(nbits)):
            self.bits.append((v >> i) & 1)

    def bytes(self) -> bytes:
        pad = (-len(self.bits)) % 8
        bits = self.bits + [0] * pad
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for bit in bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte = self.data[self.pos >> 3]
            bit = (byte >> (7 - (self.pos & 7))) & 1
            v = (v << 1) | bit
            self.pos += 1
        return v


def _nbits(n_entries: int) -> int:
    return max(1, math.ceil(math.log2(n_entries)))


def quantize_pitch(pitch: np.ndarray) -> np.ndarray:
    """(L, 2) [period_feat, corr_feat] -> (L, 2) int codes
    (8-bit period in [32, 287], 3-bit correlation)."""
    # floor() matches the reference's int() truncation in its period
    # recovery formula (src/train.py:123)
    period = np.clip(np.floor(0.1 + 50.0 * pitch[:, 0] + 100.0),
                     32, 287).astype(np.int64) - 32
    corr = np.clip(np.round((pitch[:, 1] + 0.5) * 7.0), 0, 7).astype(np.int64)
    return np.stack([period, corr], 1)


def dequantize_pitch(codes: np.ndarray) -> np.ndarray:
    period = codes[:, 0].astype(np.float64) + 32
    f18 = (period - 100.0) / 50.0
    corr = codes[:, 1].astype(np.float64) / 7.0 - 0.5
    return np.stack([f18, corr], 1).astype(np.float32)


def pack_utterance(ind1, ind2, indices: Dict, pitch: np.ndarray,
                   sizes: Dict) -> bytes:
    """Pack one utterance's frame stream.

    ind1/ind2: (L,) bool; indices: dict of (L,)/(L,S) index arrays
    (-1 where unused); pitch: (L, 2) features; sizes: codebook sizes
    {'scl': K, 'scl_bl': K or 0, 'vq': [E...], 'vq_bl': [E...]}.
    """
    w = BitWriter()
    ind1 = np.asarray(ind1).astype(bool)
    ind2 = np.asarray(ind2).astype(bool)
    iscl = np.asarray(indices["scl"])
    iscl_bl = np.asarray(indices["scl_bl"])
    ivq = np.atleast_2d(np.asarray(indices["vq"]))
    ivq_bl = np.atleast_2d(np.asarray(indices["vq_bl"]))
    pcodes = quantize_pitch(np.asarray(pitch))
    length = ind1.shape[0]
    w.write(length, 16)
    for t in range(length):
        w.write(int(ind1[t]), 1)
        w.write(int(ind2[t]), 1)
        w.write(int(pcodes[t, 0]), 8)
        w.write(int(pcodes[t, 1]), 3)
        if ind1[t]:
            w.write(int(iscl[t]), _nbits(sizes["scl"]))
        elif sizes.get("scl_bl"):
            w.write(int(iscl_bl[t]), _nbits(sizes["scl_bl"]))
        if ind2[t]:
            for s, e in enumerate(sizes["vq"]):
                w.write(int(ivq[t, s]), _nbits(e))
        else:
            for s, e in enumerate(sizes.get("vq_bl", [])):
                w.write(int(ivq_bl[t, s]), _nbits(e))
    return w.bytes()


def unpack_utterance(data: bytes, sizes: Dict):
    r = BitReader(data)
    length = r.read(16)
    ind1 = np.zeros(length, bool)
    ind2 = np.zeros(length, bool)
    iscl = np.full(length, -1, np.int32)
    iscl_bl = np.full(length, -1, np.int32)
    ivq = np.full((length, len(sizes["vq"])), -1, np.int32)
    ivq_bl = np.full((length, max(1, len(sizes.get("vq_bl", [])))), -1,
                     np.int32)
    pcodes = np.zeros((length, 2), np.int64)
    for t in range(length):
        ind1[t] = bool(r.read(1))
        ind2[t] = bool(r.read(1))
        pcodes[t, 0] = r.read(8)
        pcodes[t, 1] = r.read(3)
        if ind1[t]:
            iscl[t] = r.read(_nbits(sizes["scl"]))
        elif sizes.get("scl_bl"):
            iscl_bl[t] = r.read(_nbits(sizes["scl_bl"]))
        if ind2[t]:
            for s, e in enumerate(sizes["vq"]):
                ivq[t, s] = r.read(_nbits(e))
        else:
            for s, e in enumerate(sizes.get("vq_bl", [])):
                ivq_bl[t, s] = r.read(_nbits(e))
    pitch = dequantize_pitch(pcodes)
    return {"ind1": ind1, "ind2": ind2,
            "indices": {"scl": iscl, "scl_bl": iscl_bl,
                        "vq": ivq, "vq_bl": ivq_bl},
            "pitch": pitch}


def bitrate_bps(n_bytes: int, n_frames: int,
                frame_rate: float = 100.0) -> float:
    return 8.0 * n_bytes / n_frames * frame_rate
