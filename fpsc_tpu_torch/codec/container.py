"""`.fpsc` bitstream container: the on-disk interchange format of the
file codec.

The reference has no transmittable bitstream at all — its "encoder"
(src/generate_qtz_features.py) writes decoded FEATURE arrays to .npy
and its listening-test path hands those to an external vocoder.  Here
the codec round-trips through an actual file: a small self-describing
header (codec geometry + operating point) followed by one
entropy-coded payload per utterance, so a decoder process needs only
the container and the trained artifacts (checkpoint + codebooks).

Layout (big-endian):

    magic   4s   "FPSC"
    version u8   (1)
    flags   u8   bit0 = entropy-coded payloads (else fixed-layout),
                 bit1 = learned-mask encoder
    preset  u8 len + utf8   codebook-subset preset id (rate_control)
    l1, l2, mask_scale      f32 x3   encoder operating point
    geometry                u16 scl, u16 scl_bl,
                            u8 n_vq  + u16 per stage,
                            u8 n_vq_bl + u16 per stage
    sample_rate u32
    n_utts      u16
    per utterance: u8 len + utf8 name, u32 payload length, payload

The geometry record is the decode-side safety check: mismatched
codebook artifacts fail loudly (`check_geometry`) instead of
desynchronising the arithmetic decoder.

Version 2 (packetized streams only): each utterance additionally
records its TOTAL frame count (u16, after the name) so the decoder
knows the true length of the final — possibly short — packet even
when that packet was dropped in transit (otherwise it would
synthesize up to packet_frames-1 phantom concealed frames).  Version
1 containers (no frame counts) are still readable.

A copy of fpsc_tpu/codec/container.py: the PyTorch port keeps its own.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

MAGIC = b"FPSC"
VERSION = 2
FLAG_ENTROPY = 1
FLAG_MASK = 2
# bit2: per-utterance payloads are lists of independently decodable
# packets (u8 packet_frames after n_utts; per utterance u16 n_packets
# then u32 len + bytes per packet) — range_coder.pack_packets format.
# bit3: packets carry in-band FEC (pack_packets_fec).
FLAG_PACKETS = 4
FLAG_FEC = 8


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    if len(raw) > 255:
        raise ValueError(f"string too long for container: {s!r}")
    return struct.pack(">B", len(raw)) + raw


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, fmt: str):
        vals = struct.unpack_from(">" + fmt, self.data, self.pos)
        self.pos += struct.calcsize(">" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def take_bytes(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated .fpsc container")
        self.pos += n
        return out

    def take_str(self) -> str:
        return self.take_bytes(self.take("B")).decode("utf-8")


def write_fpsc(path: str, utterances: Sequence[Tuple[str, bytes]],
               sizes: Dict, *, entropy: bool = True,
               use_mask: bool = False, l1: float = 0.09,
               l2: float = 0.28, mask_scale: float = 1000.0,
               preset: str = "full", sample_rate: int = 16000,
               packet_frames: int = 0, fec: bool = False,
               frame_counts: Dict[str, int] = None) -> int:
    """Write the container; returns total bytes written.

    With packet_frames > 0 each utterance's payload must be a LIST of
    packet bytes (range_coder.pack_packets / pack_packets_fec) — the
    lossy-transport layout a decoder can drop packets from — and
    frame_counts must map each utterance name to its total frame
    count (recorded per utterance so a dropped FINAL short packet
    still decodes to the right length)."""
    flags = (FLAG_ENTROPY if entropy else 0) | (FLAG_MASK if use_mask
                                                else 0)
    if packet_frames:
        flags |= FLAG_PACKETS | (FLAG_FEC if fec else 0)
    out = [MAGIC, struct.pack(">BB", VERSION, flags),
           _pack_str(preset),
           struct.pack(">fff", l1, l2, mask_scale),
           struct.pack(">HH", sizes["scl"], sizes.get("scl_bl", 0) or 0),
           struct.pack(">B", len(sizes["vq"]))]
    out += [struct.pack(">H", n) for n in sizes["vq"]]
    out.append(struct.pack(">B", len(sizes.get("vq_bl", []) or [])))
    out += [struct.pack(">H", n) for n in (sizes.get("vq_bl") or [])]
    out.append(struct.pack(">IH", sample_rate, len(utterances)))
    if packet_frames:
        out.append(struct.pack(">B", packet_frames))
    for name, payload in utterances:
        out.append(_pack_str(name))
        if packet_frames:
            assert isinstance(payload, (list, tuple)), name
            if frame_counts is None or name not in frame_counts:
                raise ValueError(
                    f"packetized container needs frame_counts[{name!r}]")
            out.append(struct.pack(">HH", frame_counts[name],
                                   len(payload)))
            for pkt in payload:
                out.append(struct.pack(">I", len(pkt)))
                out.append(pkt)
        else:
            out.append(struct.pack(">I", len(payload)))
            out.append(payload)
    blob = b"".join(out)
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def read_fpsc(path: str) -> Dict:
    """Read a container -> {"meta": {...}, "utterances": [(name,
    payload), ...]}."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    if r.take_bytes(4) != MAGIC:
        raise ValueError(f"{path}: not an .fpsc container (bad magic)")
    version, flags = r.take("BB")
    if version not in (1, VERSION):
        raise ValueError(f"{path}: container version {version}, "
                         f"this build reads <= {VERSION}")
    preset = r.take_str()
    l1, l2, mask_scale = r.take("fff")
    scl, scl_bl = r.take("HH")
    vq = [r.take("H") for _ in range(r.take("B"))]
    vq_bl = [r.take("H") for _ in range(r.take("B"))]
    sample_rate, n_utts = r.take("IH")
    packet_frames = r.take("B") if flags & FLAG_PACKETS else 0
    utts: List[Tuple[str, bytes]] = []
    frame_counts: Dict[str, int] = {}
    for _ in range(n_utts):
        name = r.take_str()
        if packet_frames:
            if version >= 2:
                frame_counts[name] = r.take("H")
            utts.append((name, [r.take_bytes(r.take("I"))
                                for _ in range(r.take("H"))]))
        else:
            utts.append((name, r.take_bytes(r.take("I"))))
    return {
        "meta": {
            "entropy": bool(flags & FLAG_ENTROPY),
            "use_mask": bool(flags & FLAG_MASK),
            "preset": preset, "l1": l1, "l2": l2,
            "mask_scale": mask_scale, "sample_rate": sample_rate,
            "packet_frames": packet_frames,
            "fec": bool(flags & FLAG_FEC),
            "frame_counts": frame_counts,
            "sizes": {"scl": scl, "scl_bl": scl_bl, "vq": vq,
                      "vq_bl": vq_bl},
        },
        "utterances": utts,
    }


def check_geometry(meta: Dict, sizes: Dict) -> None:
    """Fail loudly when decode-side artifacts don't match the stream's
    geometry record (a mismatched arithmetic decoder desynchronises
    silently otherwise)."""
    want = meta["sizes"]
    have = {"scl": sizes["scl"],
            "scl_bl": sizes.get("scl_bl", 0) or 0,
            "vq": list(sizes["vq"]),
            "vq_bl": list(sizes.get("vq_bl", []) or [])}
    if want != have:
        raise ValueError(
            "codebook artifacts do not match this .fpsc stream: "
            f"stream geometry {want}, loaded artifacts {have} — "
            "load the codebooks (and rate preset) the encoder used")
